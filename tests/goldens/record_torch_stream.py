#!/usr/bin/env python
"""Record the JAX package's digests of the 60k streams that
``chip_smoke.py``'s stream phase replays on the card
(``torch_stream.json``).

The graph is the 60k cell's, ``powerlaw_bipartite(8_000, 4_000,
60_000, alpha=0.6, seed=0)``, peeled with P=16 on the csr engine and the
per-partition ``device`` FD driver, as wing and as tip; each stream
runs 4 micro-epochs of 512 events, epoch e drawn by
``make_random_events(st.g, 512, seed=1000 + e)`` against the live
graph.  Per epoch the record is that of ``record_stream_goldens.py``
(its ``_sha`` and ``forest_digest``): θ, partition and ⋈init digests,
the full ``PeelStats`` row, the packed-forest digest and the dirty
partition / level counts.

The card runs the tip stream with ``use_pallas=True`` (CD through the
``wedge_count`` kernel).  The recording runs it without: the kernel
route changes no recorded field (``PeelStats`` does not name it, and
the JAX package's tests hold the route's θ and counts equal to the
plain one), and the Pallas kernel in interpret mode on a CPU would take
far longer than the plain route.

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python tests/goldens/record_torch_stream.py

(about 70 s on a CPU, most of it the wing stream.)
"""
from __future__ import annotations

import importlib.util
import json
import os
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(HERE, "torch_stream.json")

GRAPH = dict(n_u=8_000, n_v=4_000, m=60_000, alpha=0.6, seed=0)
P = 16
EPOCHS = 4
BATCH = 512
EVENT_SEED = 1000
# name -> (kind, use_pallas on the card)
CASES = {
    "wing-60k": ("wing", False),
    "tip-60k": ("tip", True),
}


def _stream_recorder():
    """``record_stream_goldens.py`` as a module (its digest helpers)."""
    path = os.path.join(HERE, "record_stream_goldens.py")
    spec = importlib.util.spec_from_file_location("record_stream_goldens",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def epoch_record(rec, st, rep) -> dict:
    """One epoch's record, in ``record_stream_goldens.py``'s format."""
    return dict(
        epoch=rep.epoch,
        net=[rep.n_inserts, rep.n_deletes],
        m=int(st.g.m),
        theta_sha=rec._sha(st.result.theta),
        part_sha=rec._sha(st.result.part),
        sup_init_sha=rec._sha(st.result.support_init),
        stats=st.result.stats.as_dict(),
        forest_sha=rec.forest_digest(st.hierarchy),
        partitions_dirty=rep.partitions_dirty,
        levels_dirty=rep.levels_dirty,
    )


def replay(name: str):
    """Run one case on the JAX package; yields the per-epoch records."""
    from repro.core.graph import powerlaw_bipartite
    from repro.streaming import StreamConfig, StreamState, \
        make_random_events

    rec = _stream_recorder()
    kind, _ = CASES[name]
    g = powerlaw_bipartite(**GRAPH)
    st = StreamState.initial(
        g, StreamConfig(kind=kind, engine="csr", P=P, fd_driver="device"))
    for e in range(EPOCHS):
        rep = st.apply_epoch(make_random_events(st.g, BATCH,
                                                seed=EVENT_SEED + e))
        yield epoch_record(rec, st, rep)


def main() -> None:
    golden = dict(schema=1, graph=GRAPH, P=P, epochs=EPOCHS, batch=BATCH,
                  event_seed=EVENT_SEED,
                  config={name: dict(kind=kind, use_pallas=use_pallas)
                          for name, (kind, use_pallas) in CASES.items()},
                  cases={})
    for name in CASES:
        t0 = time.perf_counter()
        rows = list(replay(name))
        golden["cases"][name] = rows
        print(f"[record-torch-stream] {name}: {len(rows)} epochs in "
              f"{time.perf_counter() - t0:.1f} s, final "
              f"theta_sha={rows[-1]['theta_sha']}")
    with open(GOLDEN_PATH, "w") as f:
        json.dump(golden, f, indent=1)
    print(f"[record-torch-stream] wrote {len(golden['cases'])} cases -> "
          f"{GOLDEN_PATH}")


if __name__ == "__main__":
    main()

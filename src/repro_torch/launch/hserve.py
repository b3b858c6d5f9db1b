"""Multi-tenant hierarchy serving CLI of the PyTorch port.

The same flags, ``[hserve]`` lines and ``--out`` keys as the JAX
package's ``python -m repro.launch.hserve``, plus ``--device`` (default
``cuda``; ``cpu`` runs on the CPU; no fallback where there is no
card)::

    PYTHONPATH=src python -m repro_torch.launch.hserve --artifact-dir DIR \
        --pool-slots 32 --batch 4096 --queries 200000 \
        --metrics metrics.json --trace trace.json --out out.json
    PYTHONPATH=src python -m repro_torch.launch.hserve --dryrun
    PYTHONPATH=src python -m repro_torch.launch.hserve --dryrun --device cpu

Serves a directory of hierarchy artifacts (``<tenant>.npz``, written by
either package's ``launch/peel.py --emit-hierarchy`` or
``save_hierarchy``) behind one endpoint: tenants load through the pool's
LRU artifact cache into shape-bucketed slots, and mixed-tenant mixed-op
query batches are answered with ONE dispatch per shape bucket chunk
(``repro_torch.hierarchy.multiserve``).

``--dryrun`` needs no artifacts: it peels tenants in two shape buckets
on ``--device``, serves a mixed workload, and checks the serving
layer's structural claims — exactly one dispatch signature per bucket;
a cold same-bucket load moving nothing (signature count, the bucket
tensors' ``data_ptr()``, no bucket re-upload); a pinned tenant
surviving a pool flood; and no host synchronisation inside a dispatch
before its result copy (on the card under
``torch.cuda.set_sync_debug_mode("error")``; on the CPU, no
``aten::item``, ``aten::_local_scalar_dense`` or ``aten::nonzero`` in
the dispatch's ``torch.profiler`` op list, whose length does not change
with the tenant mix).  The JAX dry-run's lowering on 512 host devices
has no counterpart on one card.

The serve loop shuts down gracefully: SIGINT/SIGTERM stop it between
dispatch chunks, queued slots are drained, the final metrics snapshot
(``--metrics``) and trace (``--trace``) are flushed, and the process
exits 0.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time


class GracefulShutdown:
    """Flip ``stop`` on SIGINT/SIGTERM instead of dying mid-dispatch;
    previous handlers are restored on exit (nested use is safe)."""

    def __init__(self):
        self.stop = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.stop = True

    def __enter__(self):
        for s in (signal.SIGINT, signal.SIGTERM):
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:      # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


def _mixed_workload(pool, tenants, n, seed=0):
    """Random mixed-op parallel arrays over ``tenants`` (round-robin),
    each slot's ids drawn inside its tenant's true dims (the JAX CLI's
    draws, one by one, so both CLIs serve the same queries)."""
    import numpy as np

    from ..hierarchy.serve import OPS

    rng = np.random.default_rng(seed)
    t_col = [tenants[i % len(tenants)] for i in range(n)]
    ops = rng.integers(0, 5, n).astype(np.int32)
    a = np.zeros(n, np.int32)
    b = np.zeros(n, np.int32)
    for i, t in enumerate(t_col):
        m = pool.meta[t]
        lim = m.n_nodes if ops[i] == OPS["subtree_size"] else m.n_entities
        a[i] = rng.integers(0, max(lim, 1))
        b[i] = rng.integers(0, max(m.n_entities, 1))
    return t_col, ops, a, b


def _count(metrics, name) -> int:
    """Samples in the named histogram (0 before the first)."""
    h = metrics.get(name)
    return h.count if h is not None else 0


def _bucket_ptrs(pool, key):
    """Each bucket tensor's ``data_ptr()``."""
    return {name: t.data_ptr()
            for name, t in pool.bucket_arrays(key).items()}


def _chunk_cols(svc, tenants, ops, a, b):
    """The (4, batch) host columns of one single-bucket chunk."""
    import numpy as np

    from ..hierarchy.serve import OPS

    cols = np.zeros((4, svc.batch), np.int32)
    n = len(tenants)
    cols[0, :n] = [svc.pool.meta[t].slot for t in tenants]
    cols[1] = OPS["subtree_size"]                 # the padding slots
    cols[1, :n] = ops
    cols[2, :n] = a
    cols[3, :n] = b
    return cols


def _dispatch_ops(svc, key, cols):
    """The aten ops of one dispatch's launch, in order (CPU profiler)."""
    from torch.profiler import ProfilerActivity, profile

    arrs, J = svc.pool.bucket_arrays(key), svc.buckets_J(key)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc._launch(arrs, J, cols)
    return [e.name for e in prof.events() if e.name.startswith("aten::")]


def _check_no_host_sync(svc, pool, mixes) -> str:
    """No host synchronisation in a dispatch before its result copy.
    ``mixes`` maps each bucket to two single-bucket chunks of different
    tenant and op mixes."""
    import torch

    if pool.device.type == "cuda":
        for key, chunks in mixes.items():
            arrs, J = pool.bucket_arrays(key), svc.buckets_J(key)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for cols in chunks:
                    res = svc._launch(arrs, J, cols)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            res.cpu()
        return "under set_sync_debug_mode('error')"
    lengths = {}
    for key, chunks in mixes.items():
        names = [_dispatch_ops(svc, key, cols) for cols in chunks]
        for ops in names:
            bad = {"aten::item", "aten::_local_scalar_dense",
                   "aten::nonzero"} & set(ops)
            assert not bad, f"dispatch syncs with the host: {bad}"
        assert len(names[0]) == len(names[1]), \
            "the dispatch's op list must not depend on the tenant mix"
        lengths[key] = len(names[0])
    return f"profiler op lists of {sorted(lengths.values())} aten ops"


def _dryrun(device) -> int:
    import tempfile

    from ..core.graph import powerlaw_bipartite
    from ..core.peel import wing_decomposition
    from ..device import resolve_device
    from ..hierarchy import (ForestPool, MultiTenantService,
                             build_hierarchy, multiserve, save_hierarchy)

    dev = resolve_device(device)
    d = tempfile.mkdtemp(prefix="hserve_dryrun_")

    def peel(nu, nv, m, seed, P):
        g = powerlaw_bipartite(nu, nv, m, seed=seed)
        return build_hierarchy(
            g, wing_decomposition(g, P=P, engine="csr", device=dev),
            device=dev)

    shapes = [(120, 80, 420), (120, 80, 420), (120, 80, 420), (24, 16, 64)]
    for i, (nu, nv, m) in enumerate(shapes):
        save_hierarchy(os.path.join(d, f"tenant{i}.npz"),
                       peel(nu, nv, m, i, 4))

    multiserve.reset_dispatch_count()
    pool = ForestPool(slots=8, artifact_dir=d, device=dev)
    svc = MultiTenantService(pool, batch=256)
    warm = ["tenant0", "tenant1", "tenant3"]   # two shape buckets
    for t in warm:
        pool.ensure(t)
    tenants, ops, a, b = _mixed_workload(pool, warm, 1024)
    svc.query_batch(tenants, ops, a, b)
    n_buckets = len(pool.buckets)
    n_sigs = multiserve.compiled_dispatch_count()
    assert n_sigs == n_buckets, (n_sigs, n_buckets)
    print(f"[hserve-dryrun] {len(warm)} tenants over {n_buckets} shape "
          f"buckets: exactly ONE dispatch signature per bucket ✓")

    # cold load into the big bucket: values change, shapes and storage
    # don't — no new signature, same data_ptr, no bucket re-upload
    big = pool.meta["tenant0"].bucket
    ptrs = _bucket_ptrs(pool, big)
    uploads = _count(pool.metrics, "pool.bucket_upload_ms")
    pool.ensure("tenant2")
    tenants, ops, a, b = _mixed_workload(pool, warm + ["tenant2"], 1024)
    svc.query_batch(tenants, ops, a, b)
    assert multiserve.compiled_dispatch_count() == n_sigs, \
        "cold same-bucket load must not add a dispatch signature"
    assert _bucket_ptrs(pool, big) == ptrs, \
        "cold same-bucket load must keep the bucket's storage"
    assert _count(pool.metrics, "pool.bucket_upload_ms") == uploads, \
        "cold same-bucket load must not re-upload the bucket"
    print("[hserve-dryrun] cold same-bucket tenant load: same signatures, "
          "same storage, no bucket re-upload ✓")

    # the dispatch waits for the device only at its result copy
    mixes = {}
    for key in pool.buckets:
        members = [t for t in pool.tenants() if pool.meta[t].bucket == key]
        chunks = []
        for seed in (0, 1):
            tc, o, x, y = _mixed_workload(pool, members[seed:] or members,
                                          svc.batch // 2, seed=seed)
            chunks.append(_chunk_cols(svc, tc, o, x, y))
        mixes[key] = chunks
    how = _check_no_host_sync(svc, pool, mixes)
    print(f"[hserve-dryrun] dispatch makes no host synchronisation before "
          f"its result copy ({how}, {dev.type}) ✓")

    # eviction safety: pin one tenant, flood the pool, assert survival
    for i in range(4):
        save_hierarchy(os.path.join(d, f"flood{i}.npz"),
                       peel(24, 16, 64, 100 + i, 2))
    small_pool = ForestPool(slots=2, artifact_dir=d, device=dev)
    small_pool.pin("tenant3")
    for i in range(4):
        small_pool.ensure(f"flood{i}")
    assert small_pool.resident("tenant3"), "pinned tenant must survive"
    print("[hserve-dryrun] pinned tenant survives a pool flood ✓")
    return 0


def _run(args) -> int:
    import numpy as np

    from .. import obs
    from ..hierarchy import ForestPool, MultiTenantService, multiserve

    tenants = sorted(
        f[:-4] for f in os.listdir(args.artifact_dir) if f.endswith(".npz"))
    if not tenants:
        print(f"[hserve] no *.npz artifacts in {args.artifact_dir}")
        return 1
    pool = ForestPool(slots=args.pool_slots, artifact_dir=args.artifact_dir,
                      device=args.device)
    svc = MultiTenantService(pool, batch=args.batch)
    warm = tenants[:args.pool_slots]
    t0 = time.perf_counter()
    with obs.span("serve.warm", cat="serve", n=len(warm)):
        for t in warm:
            pool.ensure(t)
    t_load = time.perf_counter() - t0
    print(f"[hserve] {len(tenants)} tenants found; warmed {len(warm)} "
          f"into {len(pool.buckets)} shape buckets in {t_load * 1e3:.1f} ms",
          flush=True)

    served = 0
    checksum = np.int64(0)
    interrupted = False
    # the shutdown handler covers workload generation too: a SIGINT any
    # time after the warm print takes the graceful path
    with GracefulShutdown() as gs:
        t_col, ops, a, b = _mixed_workload(pool, warm, args.queries,
                                           seed=args.seed)
        t0 = time.perf_counter()
        try:
            # one dispatch-sized chunk per iteration so a shutdown
            # signal is honored between dispatches, never inside one
            for lo in range(0, args.queries, args.batch):
                if gs.stop:
                    interrupted = True
                    break
                hi = min(lo + args.batch, args.queries)
                out = svc.query_batch(
                    t_col[lo:hi], ops[lo:hi], a[lo:hi], b[lo:hi])
                checksum += np.int64(out.sum())
                served += hi - lo
        finally:
            # drain queued slots so no tenant retires with in-flight
            # queries (run() is a no-op on an empty queue)
            svc.run()
        dt = time.perf_counter() - t0
        interrupted = interrupted or gs.stop
    qps = served / max(dt, 1e-9)
    print(f"[hserve] {served} mixed-tenant queries in "
          f"{dt * 1e3:.1f} ms -> {qps:,.0f} q/s "
          f"({svc.dispatches} dispatches, "
          f"{multiserve.compiled_dispatch_count()} compiled programs)")
    print(f"[hserve] cache: {pool.stats()}")
    if interrupted:
        print("[hserve] shutdown signal: queue drained, telemetry "
              "flushed, exiting 0")
    svc.metrics.set_gauge("serve.qps", qps)
    if args.metrics:
        svc.metrics.save(args.metrics)
        print(f"[hserve] metrics snapshot -> {args.metrics}")
    if args.out:
        import json
        with open(args.out, "w") as f:
            json.dump(dict(qps=qps, n_tenants=len(warm),
                           served=served,
                           answers_checksum=int(checksum),
                           **pool.stats()), f)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags: the JAX CLI's, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact-dir", default=None, metavar="DIR",
                    help="directory of <tenant>.npz hierarchy artifacts "
                         "(write them with launch/peel.py "
                         "--emit-hierarchy)")
    ap.add_argument("--pool-slots", type=int, default=64,
                    help="resident-tenant budget of the forest pool "
                         "(LRU eviction past it)")
    ap.add_argument("--batch", type=int, default=1024,
                    help="slots per dispatch")
    ap.add_argument("--queries", type=int, default=50_000,
                    help="size of the mixed-op probe workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="dump qps + cache stats JSON")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the final serving-metrics snapshot "
                         "(pool.* cache counters, serve.* dispatch "
                         "latency histograms with p50/p99) as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable the observability layer and write a "
                         "Chrome-trace JSON of the serve run (warm / "
                         "cold-load / dispatch spans; open in Perfetto)")
    ap.add_argument("--dryrun", action="store_true",
                    help="no artifacts needed: peel two shape buckets "
                         "of tenants and check the serving invariants "
                         "(one dispatch signature per bucket, a cold "
                         "load that moves nothing, no host sync in a "
                         "dispatch, pinned survives a flood)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the "
                         "CPU)")
    return ap


def main(argv=None) -> int:
    """Parse ``argv`` and run; returns the exit code."""
    from .. import obs

    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.dryrun and not args.artifact_dir:
        ap.error("--artifact-dir is required (or pass --dryrun)")
    if args.trace:
        obs.enable()
    rc = _dryrun(args.device) if args.dryrun else _run(args)
    if args.trace:
        tracer = obs.get_tracer()
        tracer.save(args.trace)
        print(f"[hserve] trace: {len(tracer.events)} events -> "
              f"{args.trace}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Record the JAX package's multi-tenant serving on a small fixed tenant
set (``torch_multiserve.json``): the golden that
``tests/test_torch_multiserve.py`` and ``chip_smoke.py``'s multitenant
phase hold the port's ``ForestPool`` / ``MultiTenantService`` to.

The recipe is stored in the golden beside what it produced, so a replay
needs nothing else:

* ``distinct`` decompositions, each ``powerlaw_bipartite(n_u, n_v, m,
  seed=seed)`` peeled as wing with P=4 on the csr engine and built into
  a hierarchy (format v2 artifacts);
* ``tenants`` artifacts cycling them (tenant ``t{i}`` is
  ``distinct[i % len(distinct)]``);
* a pool of ``slots`` resident tenants and a service of ``batch``
  slots a dispatch, driven through ``steps``: ``["pin", t]``,
  ``["evict", t]``, or ``["query", tenants, n, seed]`` — ensure each
  tenant in order, draw ``n`` queries with the CLI's seeded
  ``_mixed_workload`` and answer them with one ``query_batch``.

Recorded: every bucket's key, ``J`` and slot capacity; JAX's
``compiled_dispatch_count()`` after the steps (its jit cache cleared
first); the pool's ``stats()`` without the load seconds; the resident
tenants; the dispatch count; and the sha256 of the workload and of the
answers (int64 bytes, every step's in order).  The replay itself is
``multiserve_replay.py``, which either package drives.

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python tests/goldens/record_torch_multiserve.py

(a few seconds on a CPU.)
"""
from __future__ import annotations

import importlib.util
import json
import os
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(HERE, "torch_multiserve.json")


def _load_replay():
    """``multiserve_replay.py`` beside this file, by path (this recorder
    is run as a script and loaded by path from the tests)."""
    spec = importlib.util.spec_from_file_location(
        "multiserve_replay", os.path.join(HERE, "multiserve_replay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_replay = _load_replay()
replay, write_tenants = _replay.replay, _replay.write_tenants

RECIPE = dict(
    distinct=[[40, 28, 120, 0], [40, 28, 120, 1], [40, 28, 120, 2],
              [12, 8, 24, 10]],
    P=4,
    tenants=10,
    slots=7,
    batch=32,
    steps=[
        ["pin", "t3"],
        ["query", ["t0", "t1", "t2", "t3"], 200, 1],
        ["query", ["t4", "t5", "t0", "t7"], 200, 2],
        ["query", ["t8", "t9", "t1", "t4"], 300, 3],
        ["evict", "t8"],
        ["query", ["t6", "t2", "t5", "t9", "t0"], 300, 4],
        ["query", ["t1", "t8", "t3"], 100, 5],
    ],
)


def record_jax(recipe, d) -> dict:
    """The JAX package's record of ``recipe`` over artifacts in ``d``."""
    from repro.hierarchy import ForestPool, MultiTenantService, multiserve
    from repro.launch.hserve import _mixed_workload

    multiserve._answer_batch_multi._clear_cache()
    pool = ForestPool(slots=recipe["slots"], artifact_dir=d)
    svc = MultiTenantService(pool, batch=recipe["batch"])
    out = replay(recipe, pool, svc, _mixed_workload)
    out["compiled_dispatch_count"] = multiserve.compiled_dispatch_count()
    return out


def write_jax_tenants(recipe, d) -> None:
    from repro.core.graph import powerlaw_bipartite
    from repro.core.peel import wing_decomposition
    from repro.hierarchy import build_hierarchy, save_hierarchy

    def peel(nu, nv, m, seed, P):
        g = powerlaw_bipartite(nu, nv, m, seed=seed)
        return g, wing_decomposition(g, P=P, engine="csr")

    write_tenants(recipe, d, peel, build_hierarchy, save_hierarchy)


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        write_jax_tenants(RECIPE, d)
        rec = record_jax(RECIPE, d)
    with open(GOLDEN_PATH, "w") as f:
        json.dump(dict(recipe=RECIPE, **rec), f, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()

"""The port-neutral half of ``record_torch_multiserve.py``: the replay
of a multi-tenant serving recipe through a ``ForestPool`` /
``MultiTenantService`` of either package, and the writing of its tenant
artifacts through either package's peel and build.  It names neither
package, so the JAX recorder, the port's tests and ``chip_smoke.py``
all run the same replay.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np


def sha_int64(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype=np.int64).tobytes())
    return h.hexdigest()


def replay(recipe, pool, svc, workload) -> dict:
    """Drive ``recipe["steps"]`` through a pool and service of either
    package (``workload`` is that package's CLI ``_mixed_workload``);
    returns the record, without the dispatch-signature count."""
    answers, draws = [], []
    for step in recipe["steps"]:
        if step[0] == "pin":
            pool.pin(step[1])
        elif step[0] == "evict":
            pool.evict(step[1])
        else:
            _, tenants, n, seed = step
            for t in tenants:
                pool.ensure(t)
            t_col, ops, a, b = workload(pool, tenants, n, seed=seed)
            answers.append(svc.query_batch(t_col, ops, a, b))
            draws += [ops, a, b]
    stats = pool.stats()
    return dict(
        buckets={f"{k[0]},{k[1]}": dict(J=bk.J, cap=bk.cap)
                 for k, bk in sorted(pool.buckets.items())},
        stats={k: stats[k] for k in ("hits", "misses", "evictions",
                                      "resident")},
        resident=sorted(pool.tenants()),
        dispatches=svc.dispatches,
        n_answers=int(sum(x.size for x in answers)),
        workload_sha256=sha_int64(*draws),
        answers_sha256=sha_int64(*answers),
    )


def write_tenants(recipe, d, peel, build, save) -> None:
    """The recipe's tenant artifacts in ``d`` through one package's
    ``peel(nu, nv, m, seed, P)`` → result, ``build(g, result)`` and
    ``save``; ``peel`` returns ``(g, result)``."""
    hs = []
    for nu, nv, m, seed in recipe["distinct"]:
        g, res = peel(nu, nv, m, seed, recipe["P"])
        hs.append(build(g, res))
    for i in range(recipe["tenants"]):
        save(os.path.join(d, f"t{i}.npz"), hs[i % len(hs)])

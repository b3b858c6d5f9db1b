"""Mode ``decompose_exact``: the mix of ``decompose`` (whole tip
decompositions back to back, one caller), held besides to the
reference's integer supports, where theta alone cannot show that they
were exact.

Set-up, the window and the traced segment are ``decompose``'s.  While
the window and the segment run, each decomposition also keeps the
spec's join-init (``PeelSpec.sup0``: each vertex's butterflies before
any peel) and the result's ``support_init`` and ``part`` (each vertex's
support when CD carved its partition, and that partition).  The check
holds, each count summed over the decompositions, with limit 0, in
int64:

* ``theta_mismatch``: theta against the reference's, as ``decompose``;
* ``join_init_mismatch``: the join-init against
  ``reference.tip.pair_butterflies(...).sum(1)``;
* ``support_init_mismatch``: ``support_init`` against that join-init
  less the pair butterflies each vertex shares with the vertices of the
  partitions before its own (the program's ``part``).

A peel that holds or sums its supports in float32 anywhere past 2**24
gives other supports there, while its theta may still be exact: on
``bcl-6040`` the reference peel with float32 supports gives the exact
theta.  A decomposition whose readings are missing counts every entry
as a mismatch.  A state with no readings at all (the control's, which
answers theta alone) is held to theta alone.  Tip decompositions only.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from portbench import harness
from portbench.reference import reference_theta, tip

__all__ = ["SPANS", "setup", "window", "segment", "check",
           "fd_initial_supports"]

_decompose = harness.load_file(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "decompose.py"))
SPANS = _decompose.SPANS
# the program's functions whose results hold the readings
_KEPT = (("repro_torch.core.peel", "build_peel_spec"),
         ("repro_torch.launch.peel", "run"))


def setup(ctx) -> dict:
    if ctx.config["decomposition"] != "tip":
        raise ValueError("decompose_exact holds tip decompositions only")
    state = _decompose.setup(ctx)
    state["supports"] = []
    return state


def _keeping(state):
    """Inside the block, each decomposition appends (join-init,
    support_init, part) to ``state["supports"]``."""
    pending = []

    def wrap(label, orig):
        def build_peel_spec(*a, **k):
            spec = orig(*a, **k)
            pending.append(np.array(spec.sup0, dtype=np.int64))
            return spec

        def run(*a, **k):
            pending.clear()
            out = orig(*a, **k)
            res = out["result"]
            state["supports"].append((
                pending[-1] if pending else None,
                np.array(res.support_init, dtype=np.int64),
                np.array(res.part, dtype=np.int64)))
            return out
        return build_peel_spec if label == "build_peel_spec" else run
    return harness._patched(_KEPT, wrap)


def window(ctx, state, rec) -> None:
    with _keeping(state):
        _decompose.window(ctx, state, rec)


def segment(ctx, state, rec) -> None:
    with _keeping(state):
        _decompose.segment(ctx, state, rec)


def _mismatch(got, want: np.ndarray) -> int:
    if got is None or np.shape(got) != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def fd_initial_supports(B: sp.csr_matrix, join: np.ndarray,
                        part: np.ndarray):
    """What CD leaves each vertex for its partition's FD: ``join`` less
    the pair butterflies (``B``) it shares with every vertex of an
    earlier partition of ``part``; None where ``part`` is no partition
    of every vertex."""
    n = join.size
    if part.shape != (n,) or n == 0 or int(part.min()) < 0:
        return None
    P = int(part.max()) + 1
    onehot = sp.csr_matrix((np.ones(n, dtype=np.int64),
                            (np.arange(n), part)), shape=(n, P))
    per = np.asarray((B @ onehot).todense(), dtype=np.int64)
    earlier = np.cumsum(per, axis=1) - per
    return join - earlier[np.arange(n), part]


def check(ctx, state, rec):
    n_u, n_v, edges = state["n_u"], state["n_v"], state["edges"]
    want = reference_theta(ctx.config, n_u, n_v, edges)
    bad = [_mismatch(t, want) for t in state["thetas"]]
    checks = [("theta_mismatch", sum(bad), 0)]
    if "supports" not in state:
        return checks, sum(1 for b in bad if b)
    if ctx.config.get("side", "u") == "v":
        n_u, n_v, edges = n_v, n_u, edges[:, ::-1]
    B = tip.pair_butterflies(n_u, n_v, edges)
    join = np.asarray(B.sum(axis=1), dtype=np.int64).ravel()
    kept = state["supports"]
    fd_init = {}
    join_bad, init_bad = [], []
    for k in range(len(bad)):
        sup0, sup_init, part = kept[k] if k < len(kept) else (None,) * 3
        join_bad.append(_mismatch(sup0, join))
        if part is not None and part.tobytes() not in fd_init:
            fd_init[part.tobytes()] = fd_initial_supports(B, join, part)
        exp = None if part is None else fd_init[part.tobytes()]
        init_bad.append(join.size if exp is None
                        else _mismatch(sup_init, exp))
    checks += [("join_init_mismatch", sum(join_bad), 0),
               ("support_init_mismatch", sum(init_bad), 0)]
    failed = sum(1 for b in zip(bad, join_bad, init_bad) if any(b))
    return checks, failed

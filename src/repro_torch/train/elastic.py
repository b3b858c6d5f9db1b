"""Elastic scaling and straggler detection — the port of the JAX
package's ``train/elastic.py``.

* ``remesh``: after losing (or gaining) ranks, resolve the shardings
  for the new mesh from the *logical* axis rules and re-place the state
  as ``DTensor``s.  Checkpoints are layout-free (``checkpoint.py``), so
  a change of rank count never invalidates them.
* ``StragglerDetector`` (a copy): per-step wall-time EWMA + z-score.
"""
from __future__ import annotations

import time
from typing import Optional

from .tree import tree_map

__all__ = ["remesh", "StragglerDetector"]


def _full(x):
    """A leaf as its full tensor: a ``DTensor`` gathered over its own mesh
    (a collective of that mesh's ranks), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def remesh(params, opt_state, axes_tree, new_mesh):
    """Re-place a (params, ``OptState``) pair onto ``new_mesh``: every
    parameter and both moments under ``param_shardings`` resolved for the
    new mesh, ``step`` replicated.

    Leaves may be plain tensors (the same on every rank) or ``DTensor``s
    on another mesh; ``redistribute`` cannot cross meshes, so a
    ``DTensor`` is gathered on its old mesh and split anew, one leaf at
    a time (one full leaf alive at once).  Every rank of the old meshes
    calls this; ``new_mesh`` may span fewer ranks (``DeviceMesh`` over
    the survivors), and a rank outside it keeps empty shards.  Works
    across rank-count changes as long as every tensor fits the new
    mesh's divisibility rules (the resolver falls back to replication
    otherwise)."""
    # lazy: sharding.partition walks trees with train.tree, a cycle
    from ..sharding import Sharding, distribute, param_shardings

    p_sh = param_shardings(axes_tree, params, new_mesh)
    put = lambda x, sh: distribute(_full(x), sh)
    return tree_map(put, params, p_sh), type(opt_state)(
        mu=tree_map(put, opt_state.mu, p_sh),
        nu=tree_map(put, opt_state.nu, p_sh),
        step=put(opt_state.step, Sharding(new_mesh, ())))


class StragglerDetector:
    """EWMA step-time monitor; flags steps > mean + k·std (paper §3.1.4's
    workload-aware scheduling is the peeling analogue)."""

    def __init__(self, alpha: float = 0.1, threshold_sigma: float = 3.0):
        self.alpha = alpha
        self.k = threshold_sigma
        self.mean: Optional[float] = None
        self.var = 0.0
        self._t0: Optional[float] = None
        self.flagged = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        dt = time.perf_counter() - self._t0
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = dt > self.mean + self.k * (self.var ** 0.5 + 1e-9)
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.flagged += int(is_straggler)
        return is_straggler

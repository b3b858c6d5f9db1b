"""The plain reference of the benchmark: NumPy and SciPy only.  It
imports nothing of the program under test and takes nothing the program
made; it works from the run's edge arrays alone.

* :mod:`.tip` — tip numbers by a level-synchronous bottom-up peel;
* :mod:`.wing` — wing numbers by the same peel over edges;
* :mod:`.hierarchy` — the tip hierarchy and the answers of its queries.
"""
from __future__ import annotations

import numpy as np

from . import hierarchy, tip, wing

__all__ = ["reference_theta", "tip", "wing", "hierarchy"]


def reference_theta(config: dict, n_u: int, n_v: int, edges: np.ndarray,
                    **control) -> np.ndarray:
    """theta of the configuration's decomposition of the graph, in the
    order the program reports it: one entry per vertex of the peeled
    side for ``tip``, one per edge in (u, v) lexicographic order for
    ``wing``.  ``control`` (the control only) is passed on to the peel:
    ``significand_bits``."""
    kind = config["decomposition"]
    if kind == "tip":
        if config.get("side", "u") == "v":
            n_u, n_v, edges = n_v, n_u, edges[:, ::-1]
        return tip.tip_numbers(n_u, n_v, edges, **control)
    if kind == "wing":
        e = edges[np.lexsort((edges[:, 1], edges[:, 0]))]
        return wing.wing_numbers(n_u, n_v, e, **control)
    raise ValueError(f"unknown decomposition {kind!r}")

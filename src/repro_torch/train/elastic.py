"""Straggler detection — the port of the JAX package's
``train/elastic.py`` (``StragglerDetector``, a copy).  ``remesh``, which
re-places a sharded state on a new mesh, needs the LM shardings and
waits for them (ROADMAP item 15b.5).
"""
from __future__ import annotations

import time
from typing import Optional

__all__ = ["StragglerDetector"]


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

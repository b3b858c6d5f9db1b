"""The benchmark's control arithmetic: integer supports rounded to a
float of fewer significand bits, as a peel that held them in that float
would round them."""
from __future__ import annotations

import numpy as np

__all__ = ["round_significand"]


def round_significand(x: np.ndarray, bits: int) -> np.ndarray:
    """``x`` (integers) rounded to the nearest float with ``bits``
    significand bits (ties to even), as int64: 24 for float32, 11 for
    float16, 8 for bfloat16.  ``bits`` 0 returns ``x`` unchanged."""
    if not bits:
        return x
    m, e = np.frexp(x.astype(np.float64))
    return np.ldexp(np.rint(np.ldexp(m, bits)), e - bits).astype(np.int64)

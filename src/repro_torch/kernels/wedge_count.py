"""Per-row wedge count wrappers — ``csrc/wedge_count.cu``.

``wedge_count``: row sums W of an (n, K) f32 slot matrix and the f32
butterfly estimate W·(W−1)/2 (exact only while W ≲ 5790; never used for
θ).  The csr engine reads W as per-pair alive wedge counts
(``core.csr.pair_wedge_counts``) and as the tip CD support delta over
vertex-major pair slots (``ops.tip_slot_loss``).

``wedge_count_tile``: exact int32 row sums of an int32 0/1 slot matrix,
the tile mode of the tiled ⋈init (``core.csr.tiled_butterfly_init``).

A CUDA tensor launches the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["wedge_count", "wedge_count_tile"]


@functools.cache
def _lib():
    lib = _build.lib("wedge_count")
    lib.wedge_count_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.wedge_count_launch.restype = ctypes.c_int
    lib.wedge_count_tile_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.wedge_count_tile_launch.restype = ctypes.c_int
    return lib


def wedge_count(slots):
    """``slots``: (n, K) f32 holding exact integers whose row sums stay
    below 2²⁴.  Returns f32 (W (n,), bf (n,))."""
    if slots.device.type == "cpu":
        return ref.pair_wedge_counts_ref(slots)
    n, K = slots.shape
    f32 = torch.float32
    _build.require("wedge_count", ("slots", slots, f32, (n, K)))
    W = torch.empty((n,), dtype=f32, device=slots.device)
    bf = torch.empty((n,), dtype=f32, device=slots.device)
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    err = _lib().wedge_count_launch(
        slots.data_ptr(), W.data_ptr(), bf.data_ptr(), n, K, stream)
    _build.check(err, "wedge_count")
    _build.LAUNCHES["wedge_count"] += 1
    return W, bf


def wedge_count_tile(slots, n=None):
    """``slots``: (n_pad, width) int32 0/1 flags.  Returns the int32 row
    sums (n,) of the first ``n`` rows (default: all); the rows below
    them are bucket padding and are not read."""
    n_pad, width = slots.shape
    n = n_pad if n is None else int(n)
    if not 0 <= n <= n_pad:
        raise ValueError(f"wedge_count_tile: n={n} outside 0..{n_pad}")
    if slots.device.type == "cpu":
        return ref.tile_row_counts_ref(slots[:n])
    _build.require("wedge_count_tile", ("slots", slots, torch.int32,
                                        (n_pad, width)))
    out = torch.empty((n,), dtype=torch.int32, device=slots.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    err = _lib().wedge_count_tile_launch(
        slots.data_ptr(), out.data_ptr(), n, width, stream)
    _build.check(err, "wedge_count_tile")
    _build.LAUNCHES["wedge_count_tile"] += 1
    return out

"""Butterfly-counting wrappers — ``csrc/butterfly_count.cu``.

``vertex_count``: per-row butterflies Σ_{j≠r} C(W[r, j], 2) of a 0/1
adjacency, W = A·Aᵀ never stored.  ``vertex_count_tile``: the same raw
sum for one row strip against all of A, with no diagonal mask.
``matmul``: an f32 product (``a @ b`` or ``a @ bᵀ``) by 3xTF32 on the
tensor cores, f32 accumulation: exact where the operands are integers
below 2²² and every partial sum an integer below 2²⁴ (the graph
products), about an f32 product's rounding error otherwise.
``ops.vertex_butterflies``, ``ops.vertex_butterflies_tiled`` and
``ops.edge_wedge_matrix`` pad and combine them.  A CUDA tensor launches
the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["matmul", "vertex_count", "vertex_count_tile"]


@functools.cache
def _lib():
    lib = _build.lib("butterfly_count")
    lib.vertex_count_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.vertex_count_launch.restype = ctypes.c_int
    lib.matmul_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.matmul_launch.restype = ctypes.c_int
    return lib


def _count(name, A_rows, A, diag0):
    rows, k = A_rows.shape
    n = A.shape[0]
    f32 = torch.float32
    _build.require(name, ("A_rows", A_rows, f32, (rows, k)),
                   ("A", A, f32, (n, k)))
    acc = torch.zeros((rows,), dtype=torch.int64, device=A.device)
    out = torch.empty((rows,), dtype=f32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _lib().vertex_count_launch(
        A_rows.data_ptr(), A.data_ptr(), acc.data_ptr(), out.data_ptr(),
        rows, n, k, diag0, stream)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def vertex_count(A):
    """``A``: (n, k) f32 0/1 adjacency.  Returns the f32 per-row
    butterflies (n,), exact while each stays below 2²⁴."""
    if A.device.type == "cpu":
        return ref.vertex_butterflies_ref(A)
    return _count("vertex_count", A, A, 0)


def vertex_count_tile(A_rows, A):
    """``A_rows``: (rows, k) f32 0/1 row strip of ``A`` (n, k).  Returns
    the f32 raw sums Σ_j C(W[r, j], 2), W = A_rows·Aᵀ, self pair
    included, exact while each stays below 2²⁴."""
    if A.device.type == "cpu":
        return ref.vertex_count_tile_ref(A_rows, A)
    return _count("vertex_count_tile", A_rows, A, -1)


def matmul(a, b, trans_b: bool = False):
    """``a``: (m, k) f32; ``b``: (k, n) f32, or (n, k) read transposed
    with ``trans_b``.  Returns the f32 product (m, n).  On the card the
    kernel's scratch holds each operand's hi/lo TF32 planes, K-major with
    rows padded to a multiple of 4 (2·(m + n)·k f32 values; ``a @ aᵀ``
    shares one pair); a lo plane that is all zero (a 0/1 operand) is
    neither loaded nor multiplied."""
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, trans_b)
    m, k = a.shape
    n = b.shape[0] if trans_b else b.shape[1]
    f32 = torch.float32
    _build.require("matmul", ("a", a, f32, (m, k)),
                   ("b", b, f32, (n, k) if trans_b else (k, n)))
    c = torch.empty((m, n), dtype=f32, device=a.device)
    kp = -(-k // 4) * 4
    a_planes = torch.empty((2, m, kp), dtype=f32, device=a.device)
    same = trans_b and b.data_ptr() == a.data_ptr() and b.shape == a.shape
    b_planes = (a_planes if same
                else torch.empty((2, n, kp), dtype=f32, device=a.device))
    lo_used = torch.empty((2,), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               a_planes.data_ptr(), b_planes.data_ptr(),
                               lo_used.data_ptr(), m, n, k, int(trans_b),
                               stream)
    _build.check(err, "matmul")
    _build.LAUNCHES["matmul"] += 1
    return c

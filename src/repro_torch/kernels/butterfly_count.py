"""Butterfly-counting wrappers — ``csrc/butterfly_count.cu``.

``vertex_count``: per-row butterflies Σ_{j≠r} C(W[r, j], 2) of a 0/1
adjacency, W = A·Aᵀ never stored.  ``vertex_count_tile``: the same raw
sum for one row strip against all of A, with no diagonal mask.  Both
take a 0/1 adjacency, as the JAX kernels do, and compute it exactly in
int8 on the tensor cores, summed in int64 and returned in int64 (the
JAX kernels round to f32, exact only below 2²⁴); they take it as f32 or
as ``pack_s8``'s int8 matrix, so that a caller with many strips packs A
once.  ``pack_s8``
raises ``ValueError`` on any value other than 0 and 1.  ``matmul``: an
f32 product (``a @ b`` or ``a @ bᵀ``) by 3xTF32 on the tensor cores, f32
accumulation: exact where the operands are integers below 2²² and every
partial sum an integer below 2²⁴ (the graph products), about an f32
product's rounding error otherwise.  ``ops.vertex_butterflies``,
``ops.vertex_butterflies_tiled`` and ``ops.edge_wedge_matrix`` pad and
combine them.  A CUDA tensor launches the kernel, a CPU tensor runs the
plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["matmul", "pack_s8", "vertex_count", "vertex_count_tile"]


@functools.cache
def _lib():
    lib = _build.lib("butterfly_count")
    lib.pack_s8_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.pack_s8_launch.restype = ctypes.c_int
    lib.vertex_count_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.vertex_count_launch.restype = ctypes.c_int
    lib.matmul_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.matmul_launch.restype = ctypes.c_int
    return lib


def pack_s8(A):
    """``A``: (n, k) f32 0/1 adjacency.  Returns the vertex-count kernels'
    operand: (n, kp) int8, kp = k rounded up to a multiple of 16, zero
    past column k.  Raises ``ValueError`` if A holds any other value (NaN
    included): the kernel flags it, and the flag is read once a call."""
    if A.device.type == "cpu":
        out, odd = ref.pack_s8_ref(A)
    else:
        n, k = A.shape
        _build.require("pack_s8", ("A", A, torch.float32, (n, k)))
        out = torch.empty((n, -(-k // 16) * 16), dtype=torch.int8,
                          device=A.device)
        odd = torch.empty((1,), dtype=torch.int32, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _lib().pack_s8_launch(A.data_ptr(), out.data_ptr(),
                                    odd.data_ptr(), n, k, out.shape[1], stream)
        _build.check(err, "pack_s8")
        _build.LAUNCHES["pack_s8"] += 1
    if bool(odd):
        raise ValueError("vertex counts take a 0/1 adjacency: A holds a "
                         "value other than 0 and 1")
    return out


def _packed(A):
    """``A`` as the kernels' int8 operand: packed here if it is f32,
    taken as it is if it is already ``pack_s8``'s int8."""
    if A.dtype == torch.int8:
        return A
    if A.dtype != torch.float32:
        raise TypeError(f"vertex counts take an f32 0/1 adjacency or its "
                        f"pack_s8 int8, got {A.dtype}")
    return pack_s8(A)


def _count(name, A_rows, A, triangular):
    if A.device.type == "cpu":
        A_rows, A = A_rows.to(torch.float32), A.to(torch.float32)
        return (ref.vertex_butterflies_ref(A) if triangular
                else ref.vertex_count_tile_ref(A_rows, A))
    rows, kp = A_rows.shape
    n = A.shape[0]
    _build.require(name, ("A_rows", A_rows, torch.int8, (rows, kp)),
                   ("A", A, torch.int8, (n, kp)))
    if kp % 16 or A_rows.data_ptr() % 16 or A.data_ptr() % 16:
        raise ValueError(f"{name}: int8 operands need 16-byte aligned rows "
                         f"of a multiple of 16 values (pack_s8 makes them)")
    out = torch.empty((rows,), dtype=torch.int64, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _lib().vertex_count_launch(
        A_rows.data_ptr(), A.data_ptr(), out.data_ptr(), rows, n, kp,
        int(triangular), stream)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def vertex_count(A):
    """``A``: (n, k) f32 0/1 adjacency, or its ``pack_s8``.  Returns the
    int64 per-row butterflies (n,), exact."""
    A = _packed(A)
    return _count("vertex_count", A, A, triangular=True)


def vertex_count_tile(A_rows, A):
    """``A_rows``: (rows, k) f32 0/1 row strip of ``A`` (n, k), or both
    as ``pack_s8`` int8 (a strip as a row slice of the packed A).
    Returns the int64 raw sums Σ_j C(W[r, j], 2), W = A_rows·Aᵀ, self
    pair included, exact."""
    if A_rows.dtype != A.dtype:
        raise TypeError(f"vertex_count_tile: A_rows is {A_rows.dtype}, A is "
                        f"{A.dtype}; pass both f32 or both packed")
    return _count("vertex_count_tile", _packed(A_rows), _packed(A),
                  triangular=False)


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

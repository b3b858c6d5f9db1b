"""Flash attention wrapper — ``csrc/flash_attention.cu``.

``flash_attention``: softmax attention of q [B, H, Sq, D] over k, v
[B, KVH, Sk, D] (H a multiple of KVH: query head h reads key/value head
h // (H / KVH)), f32 arithmetic, output in q's dtype.  With ``causal``,
key j is visible to query i iff j <= i + ``offset``; a row that sees no
key gives 0.  q, k and v may be strided views (the model's transposed
heads); only their last dimension must be contiguous.

A CUDA tensor launches the kernel, a CPU tensor runs the plain version
(``ref.flash_attention_ref``).  The kernel has no backward: a CUDA input
that requires grad is refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["HEAD_DIMS", "flash_attention"]

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib():
    lib = _build.lib("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _rows(name, t, dtype, device):
    """``t`` as the kernel reads it: on ``device``, of ``dtype``, unit
    stride in D and 16-byte aligned rows (a copy only where not)."""
    if t.device != device:
        raise ValueError(f"flash_attention: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, expected {dtype}")
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def flash_attention(q, k, v, causal: bool, scale: float, offset: int):
    """See the module docstring; ``scale`` multiplies the scores."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       offset=offset)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: takes CPU tensors (plain version) "
                         f"or CUDA tensors (the kernel), got {q.device}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward (neither has "
            "the JAX package's); training waits for ROADMAP queue 1 item 15b")
    B, H, sq, D = q.shape
    KVH, sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q is {q.dtype}, expected float32 "
                        "or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if (k.shape != (B, KVH, sk, D) or v.shape != k.shape or KVH == 0
            or H % KVH):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}: k and v must be [B, KVH, Sk, D] with H a "
            "multiple of KVH")
    q, k, v = (_rows(n, t, q.dtype, q.device)
               for n, t in (("q", q), ("k", k), ("v", v)))
    out = torch.empty((B, H, sq, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KVH, sq, sk, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal), int(offset),
        int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out

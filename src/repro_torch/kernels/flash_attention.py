"""Flash attention wrapper — ``csrc/flash_attention.cu``.

``flash_attention``: softmax attention of q [B, H, Sq, D] over k, v
[B, KVH, Sk, D] (H a multiple of KVH: query head h reads key/value head
h // (H / KVH)), f32 accumulation, output in q's dtype.  With
``causal``, key j is visible to query i iff j <= i + ``offset``; a row
that sees no key gives 0.  q, k and v may be strided views (the model's
transposed heads); only their last dimension must be contiguous.

A CUDA tensor launches a kernel, a CPU tensor runs the plain version
(``ref.flash_attention_ref``).  Which kernel (``route``): bf16 inputs
with D 64, 128 or 256 take the bf16 tensor-core kernel (``wgmma`` fed
by TMA; P is rounded to bf16 before P·V, as the TPU kernel rounds it);
f32 inputs with D 64, 128 or 256 take the 3×TF32 tensor-core kernel
(each operand split into two TF32 planes, three products, f32 to within
rounding), after ``split_kv``, its pre-pass, has written k's and v's
planes; D 32 (the reduced presets' head dim) takes the CUDA-core kernel
in either dtype.  The kernels have no backward: a CUDA input that
requires grad is refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["HEAD_DIMS", "flash_attention", "route", "split_kv"]

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
# flash_attention_route's codes
ROUTES = {0: "cuda cores", 1: "bf16 tensor cores", 2: "3xtf32 tensor cores"}


@functools.cache
def _lib():
    lib = _build.lib("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_split_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p])
    lib.flash_attention_split_launch.restype = ctypes.c_int
    lib.flash_attention_route.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_route.restype = ctypes.c_int
    return lib


def route(dtype, head_dim: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches, as
    the launch function decides it (``ROUTES``); builds the library."""
    code = _lib().flash_attention_route(int(head_dim),
                                        int(dtype == torch.bfloat16))
    if code not in ROUTES:
        raise ValueError(f"flash_attention: head dim {head_dim} not in "
                         f"{HEAD_DIMS}")
    return ROUTES[code]


def split_kv(k, v):
    """The 3×TF32 route's pre-pass: k and v (f32 [B, KVH, Sk, D], strided
    views allowed, unit stride in D) as TF32 planes.  Returns (kp, vp):
    kp [2, B, KVH, Sk, D] holds hi = rna(k) and lo = rna(k − hi); vp
    [2, B, KVH, D, Skp] the same of v transposed, Skp = Sk rounded up to
    a multiple of 8, each group of 8 keys in ``ref.V_KEY_ORDER`` (the
    kernel's A-operand columns), zero past Sk.  On the CPU the plain
    version ``ref.split_kv_ref``; on the card a kernel launch, counted
    in ``_build.LAUNCHES["split_kv"]``."""
    if k.device.type == "cpu":
        return ref.split_kv_ref(k, v)
    B, KVH, sk, D = k.shape
    if v.shape != k.shape or D % 32:
        raise ValueError(f"split_kv: k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "equal shapes with D a multiple of 32")
    k, v = (_rows(n, t, torch.float32, k.device)
            for n, t in (("k", k), ("v", v)))
    skp = -(-sk // 8) * 8
    kp = torch.empty((2, B, KVH, sk, D), dtype=torch.float32, device=k.device)
    vp = torch.empty((2, B, KVH, D, skp), dtype=torch.float32, device=k.device)
    stream = torch.cuda.current_stream(k.device).cuda_stream
    err = _lib().flash_attention_split_launch(
        k.data_ptr(), v.data_ptr(), kp.data_ptr(), vp.data_ptr(), B, KVH, sk,
        D, *k.stride()[:3], *v.stride()[:3], stream)
    _build.check(err, "split_kv")
    _build.LAUNCHES["split_kv"] += 1
    return kp, vp


def _rows(name, t, dtype, device):
    """``t`` as the kernels read it: on ``device``, of ``dtype``, unit
    stride in D and 16-byte aligned rows and strides (TMA's rule too; a
    copy only where not)."""
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
    planes = (split_kv(k, v) if route(q.dtype, D) == ROUTES[2]
              else (None, None))
    out = torch.empty((B, H, sq, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(p if p is None else p.data_ptr() for p in planes),
        B, H, KVH, sq, sk, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal), int(offset),
        int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out

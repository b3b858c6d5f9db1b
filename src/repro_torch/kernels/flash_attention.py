"""Flash attention wrapper — ``csrc/flash_attention.cu``.

``flash_attention``: softmax attention of q [B, H, Sq, D] over k
[B, KVH, Sk, D] and v [B, KVH, Sk, Dv] (H a multiple of KVH: query head
h reads key/value head h // (H / KVH)), f32 accumulation, output
[B, H, Sq, Dv] in q's dtype.  With
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
in either dtype.  Other head dims (DeepSeek-V2's MLA: D 192, Dv 128)
take the smallest instance P >= max(D, Dv) (``padded_head_dim``): q, k
and v are zero-padded to P (``pad_head_dims``), the instance runs with
the caller's scale and the output is cut to Dv.  That is exact with
respect to the kernel's arithmetic: a zero column adds +0 to every bf16 product, its
TF32 hi and lo planes are 0, and the padded output columns are dropped.
A head dim above 256 raises.  The plain version pads nothing.

``flash_attention`` is a ``torch.autograd.Function`` (``FlashAttention``)
on both devices: its forward is the kernel (the plain version on a CPU
tensor), its backward ``attention_backward``, the online-softmax
backward in torch ops, query block by query block, at full f32 (the
JAX package has no backward kernel either: it trains through its jnp
blockwise attention, which XLA differentiates).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from . import _build, ref

__all__ = ["HEAD_DIMS", "FlashAttention", "attention_backward",
           "attention_flops", "counting", "flash_attention", "pad_head_dims",
           "padded_head_dim", "route", "split_kv", "visible_pairs"]

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


def padded_head_dim(d: int, dv: int) -> int:
    """The head dim of the instance a call with q/k head dim ``d`` and v
    head dim ``dv`` launches: the smallest of ``HEAD_DIMS`` >= both (d
    itself where d == dv is an instance)."""
    for p in HEAD_DIMS:
        if p >= max(d, dv):
            return p
    raise ValueError(f"flash_attention: head dims {d} / {dv} above the "
                     f"largest instance {HEAD_DIMS[-1]}")


def pad_head_dims(q, k, v):
    """q, k and v zero-padded in their last dim to the instance
    ``padded_head_dim`` picks (the tensors themselves where they are
    already one): the kernel's input for a head dim it has no instance
    of.  The output's first Dv columns are then the attention of the
    unpadded inputs at the same scale."""
    P = padded_head_dim(k.shape[3], v.shape[3])
    if q.shape[3] == v.shape[3] == P:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, P - t.shape[3]))
                 for t in (q, k, v))


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
    return FlashAttention.apply(q, k, v, causal, scale, offset)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the kernel (or, on a CPU tensor, its
    plain version) and whose backward is :func:`attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, offset):
        out = _forward(q, k, v, causal, scale, offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, scale, offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        # a label for torch.profiler: the device time of a training step's
        # attention backward is this range's
        with torch.profiler.record_function("flash_attention.backward"):
            grads = attention_backward(q, k, v, out, dout, *ctx.args)
        return (*grads, None, None, None)


# query rows a backward block takes: its scores are [B, KVH, H/KVH · 512,
# keys] f32 (0.54 GB at TinyLlama's b 4, 32/4 heads, S 2 048), and a
# few such tensors live at once
BWD_BLOCK = 512


def attention_backward(q, k, v, out, dout, causal: bool, scale: float,
                       offset: int):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) with output
    ``out`` and upstream gradient ``dout``, in torch ops at full f32, a
    block of ``BWD_BLOCK`` query rows at a time: the block's row
    log-sum-exp is recomputed from q and k, P = exp(s − lse),
    dV += Pᵀ·dO, dS = P ∘ (dO·Vᵀ − rowsum(dO ∘ O)), dQ = scale · dS·K
    and dK += scale · dSᵀ·Q.  A block's rows are its H/KVH query heads
    over the block's positions, so dK and dV sum over each GQA group.
    With ``causal``, key j is visible to query i iff j <= i + ``offset``;
    a block reads only the keys its last row sees, and a row that sees
    no key has P = 0 (its output was 0).  Gradients in the inputs'
    dtypes."""
    B, H, sq, D = q.shape
    KVH, sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = H // KVH
    f32 = torch.float32
    qf = q.to(f32).reshape(B, KVH, g, sq, D)
    of = out.to(f32).reshape(B, KVH, g, sq, Dv)
    dof = dout.to(f32).reshape(B, KVH, g, sq, Dv)
    kf, vf = k.to(f32), v.to(f32)
    dq = torch.zeros((B, KVH, g, sq, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, KVH, sk, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, KVH, sk, Dv), dtype=f32, device=q.device)
    for r0 in range(0, sq, BWD_BLOCK):
        r1 = min(sq, r0 + BWD_BLOCK)
        n = min(sk, r1 + offset) if causal else sk
        if n <= 0:
            continue
        rows = (B, KVH, g * (r1 - r0))
        qb = qf[:, :, :, r0:r1].reshape(*rows, D)
        dob = dof[:, :, :, r0:r1].reshape(*rows, Dv)
        ob = of[:, :, :, r0:r1].reshape(*rows, Dv)
        kb, vb = kf[:, :, :n], vf[:, :, :n]
        s = ref.matmul_f32(qb, kb.transpose(-1, -2)) * scale
        if causal:
            seen = (torch.arange(n, device=q.device)[None, :]
                    <= torch.arange(r0, r1, device=q.device)[:, None] + offset)
            s = s.view(B, KVH, g, r1 - r0, n).masked_fill_(
                ~seen, float("-inf")).view(s.shape)
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0))
        del s
        dv[:, :, :n] += ref.matmul_f32(p.transpose(-1, -2), dob)
        ds = ref.matmul_f32(dob, vb.transpose(-1, -2))
        ds -= (dob * ob).sum(dim=-1, keepdim=True)
        ds *= p
        del p
        dq[:, :, :, r0:r1] = (ref.matmul_f32(ds, kb) * scale).view(
            B, KVH, g, r1 - r0, D)
        dk[:, :, :n] += ref.matmul_f32(ds.transpose(-1, -2), qb) * scale
    return (dq.reshape(B, H, sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def visible_pairs(sq: int, sk: int, causal: bool, offset: int) -> int:
    """(query, key) pairs the attention computes: all sq·sk, or with
    ``causal`` those with key j <= query i + ``offset``."""
    if not causal:
        return sq * sk
    # row i sees clamp(i + c, 0, sk) keys, c = offset + 1: none before
    # row lo, i + c from lo to hi, all sk from hi on
    c = offset + 1
    lo = min(sq, max(0, 1 - c))
    hi = min(sq, max(lo, sk - c))
    return (hi - lo) * c + (lo + hi - 1) * (hi - lo) // 2 + (sq - hi) * sk


def attention_flops(q, k, v, causal: bool, offset: int) -> int:
    """The forward's FLOPs: 2·(D + Dv) per visible (query, key) pair and
    query head (the two products, s = q·kᵀ and p·v)."""
    B, H, sq, D = q.shape
    return 2 * B * H * visible_pairs(sq, k.shape[2], causal, offset) * (
        D + v.shape[3])


@functools.cache
def _meta_op():
    """``flash_attention`` as a custom op on meta tensors, for the
    dry-run's counts (``launch.hlo_analysis``): its output shape, and its
    FLOPs registered with ``torch.utils.flop_counter`` (the plain
    version's [Sq, Sk] products would count the masked half and the
    score matrix the kernel never writes)."""
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::flash_attention_count",
                             mutates_args=())
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           offset: int) -> torch.Tensor:
        raise NotImplementedError("flash_attention_count takes meta tensors")

    @op.register_fake
    def _shape(q, k, v, causal, offset):
        return q.new_empty(q.shape[:3] + v.shape[3:])

    @register_flop_formula(torch.ops.repro_torch.flash_attention_count,
                           get_raw=True)
    def _flops(q, k, v, causal, offset, *args, out_val=None, **kwargs):
        return attention_flops(q, k, v, causal, offset)

    return op


_COUNTING = threading.local()


@contextlib.contextmanager
def counting():
    """Inside, ``flash_attention`` takes meta tensors: a shape-only
    custom op whose FLOPs ``torch.utils.flop_counter`` knows (the
    dry-run's counts); outside, a meta tensor is refused as any device
    but the CPU's and the card's."""
    prev = getattr(_COUNTING, "on", False)
    _COUNTING.on = True
    try:
        yield
    finally:
        _COUNTING.on = prev


def _forward(q, k, v, causal: bool, scale: float, offset: int):
    """The forward: the kernel on a CUDA tensor, the plain version on a
    CPU tensor; on meta tensors inside ``counting()`` a shape-only custom
    op."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       offset=offset)
    if q.device.type == "meta" and getattr(_COUNTING, "on", False):
        return _meta_op()(q, k, v, causal, offset)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: takes CPU tensors (plain version) "
                         f"or CUDA tensors (the kernel), got {q.device}")
    B, H, sq, D = q.shape
    KVH, sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q is {q.dtype}, expected float32 "
                        "or bfloat16")
    if (k.shape != (B, KVH, sk, D) or v.shape != (B, KVH, sk, Dv)
            or KVH == 0 or H % KVH):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}: k must be [B, KVH, Sk, D] and v [B, KVH, "
            "Sk, Dv] with H a multiple of KVH")
    q, k, v = (_rows(n, t, q.dtype, q.device)
               for n, t in (("q", q), ("k", k), ("v", v)))
    q, k, v = pad_head_dims(q, k, v)
    P = q.shape[3]
    planes = (split_kv(k, v) if route(q.dtype, P) == ROUTES[2]
              else (None, None))
    out = torch.empty((B, H, sq, P), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(p if p is None else p.data_ptr() for p in planes),
        B, H, KVH, sq, sk, P, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal), int(offset),
        int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out if P == Dv else out[..., :Dv]

"""Shared neural-net layers — functional PyTorch on plain tensors.

The port of the JAX package's ``models/layers.py``: the same functions,
arguments and layouts ([b, heads, s, d] for attention).  Full-sequence
attention goes through the ``flash_attention`` kernel on every device
(``kernels.ops.flash_attention``: the kernel on a CUDA tensor, its plain
version on a CPU tensor), as the JAX package's docstring says its Pallas
kernel replaces the blockwise jnp version on the accelerator; training
differentiates it through ``flash_attention.FlashAttention`` (the kernel
forward, the online-softmax backward in torch ops).  Decode
attention (one query against the cache) is plain torch: the JAX package
has no kernel for it.

``constrain`` is the JAX package's ``with_sharding_constraint`` against
the current mesh (``sharding.use_mesh``): a ``DTensor`` activation is
redistributed to the filtered spec; a plain tensor, or any tensor with no
mesh, is returned as it is.  On ``DTensor`` inputs ``blockwise_attention``
runs the kernel on each rank's local shard (``local_map``: batch over the
data axes, heads over ``"model"``).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import matmul_f32

__all__ = [
    "rms_norm",
    "apply_rope",
    "mrope_positions",
    "mlp",
    "blockwise_attention",
    "decode_attention",
    "constrain",
    "constrain_spec",
    "write_slot",
    "copy_state",
    "whole_parts",
    "merge_heads",
    "DP_AXES",
]

DP_AXES = ("pod", "data")  # batch shards over these when present

_NEG = -1e30


def constrain_spec(spec_axes, names) -> tuple:
    """``spec_axes`` filtered against the mesh axis ``names`` as JAX's
    ``constrain`` filters it: a name the mesh lacks becomes None, a tuple
    keeps the names the mesh has (None if it keeps none).  Entries follow
    ``sharding.partition``'s spec convention (a one-name tuple is the bare
    name)."""
    names = set(names)
    out = []
    for s in spec_axes:
        if s is None:
            out.append(None)
        elif isinstance(s, str):
            out.append(s if s in names else None)
        else:
            f = tuple(a for a in s if a in names)
            out.append(None if not f else f[0] if len(f) == 1 else f)
    return tuple(out)


def constrain(x: torch.Tensor, spec_axes) -> torch.Tensor:
    """The activation sharding constraint of the JAX package: ``x``
    redistributed to the ``DTensor`` placements of ``spec_axes`` filtered
    against the current mesh (``sharding.use_mesh``), so one model code
    runs on one device, the 16×16 pod and the 2×16×16 mesh.  With no
    current mesh, or for a plain tensor, ``x`` itself is returned."""
    from ..sharding.partition import current_mesh, placements

    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    target = placements(constrain_spec(spec_axes, mesh.mesh_dim_names), mesh)
    if any(p.is_partial() for p in x.placements):
        return _Reduce.apply(x, mesh, target)
    return x.redistribute(mesh, target)


class _Reduce(torch.autograd.Function):
    """``x.redistribute(mesh, target)`` from pending sums (``Partial``)
    whose gradient is replicated on the mesh dims the sum ran over (the
    gradient of a sum is the same on every term), as Megatron's
    all-reduce: ``DTensor``'s own backward would make that gradient a
    pending sum again, and the products before it would then replicate
    their weights to keep it."""

    @staticmethod
    def forward(ctx, x, mesh, target):
        ctx.source = x.placements
        return x.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        return g.redistribute(g.device_mesh, [
            Replicate() if p.is_partial() else p for p in ctx.source]), \
            None, None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated(mesh) -> list:
    """Every mesh dim ``Replicate()`` (a list: ``local_map`` reads a
    tuple as one placement list an output)."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def batch_placements(mesh, b: int, grad: bool = False) -> list:
    """Placements of a tensor whose dim 0 is a batch of ``b`` rows:
    ``Shard(0)`` on the data axes (``DP_AXES``) where b divides them,
    ``Replicate()`` elsewhere (and on mesh dims of size 1, as
    ``sharding.placements``).  ``grad``: the placements of the gradient
    of a weight every rank holds whole but applies to its own rows only —
    ``Partial()`` (a sum) over the data axes that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    split = b % math.prod(sizes[a] for a in names if a in DP_AXES) == 0
    return [(Partial() if grad else Shard(0))
            if a in DP_AXES and split and sizes[a] > 1 else Replicate()
            for a in names]


def whole_parts(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` ready to split dim ``dim`` into ``n`` parts (heads): on a
    ``DTensor``, a mesh axis that shards that dim into pieces that are
    not whole parts (2 KV heads on a 4-way ``"model"`` axis) is
    replicated first — a ``DTensor`` cannot unflatten an uneven split —
    and the result made contiguous.  A plain tensor is returned as it
    is."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dim %= t.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and n % t.device_mesh.size(i) else p
          for i, p in enumerate(t.placements)]
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    # a view of a slice (Mamba2's split of its projection) cannot be
    # reshaped in place: a plain reshape copies, a DTensor's may refuse
    return t.contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """x [..., n, hd] -> [..., n·hd].  On a ``DTensor`` the gradient that
    comes back is made splittable into the n heads first (``whole_parts``):
    the product after the merge may hand back a gradient whose last dim a
    mesh axis splits between heads (8 heads on 16 ranks)."""
    if not _is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _MergeHeads.apply(x)


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return whole_parts(g, -1, ctx.shape[-2]).reshape(ctx.shape)


def write_slot(cache: torch.Tensor, dim: int, pos: int,
               value: torch.Tensor) -> None:
    """``cache.select(dim, pos)[...] = value``, in place.  On a ``DTensor``
    cache the value is placed as the cache is on its other dims and
    written into the local shard of the rank that holds index ``pos`` of
    ``dim`` (the cache's sequence dim may be sharded): a ``DTensor`` has
    no in-place write into a slice of a sharded dim."""
    if not _is_dtensor(cache):
        idx = (slice(None),) * dim + (pos,)
        cache[idx] = value
        return
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    vpl = [Replicate() if isinstance(p, Shard) and p.dim == dim
           else Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) else p
           for p in cache.placements]
    local = (value.redistribute(mesh, vpl).to_local() if _is_dtensor(value)
             else distribute_tensor(value, mesh, vpl,
                                    src_data_rank=None).to_local())
    shape, off = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    i = pos - off[dim]
    if 0 <= i < shape[dim]:
        cache.to_local().select(dim, i).copy_(local)


def copy_state(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` — on a ``DTensor`` ``dst`` (a slot of a sharded
    decode cache) into its local shard, ``src`` placed as ``dst`` is."""
    if not _is_dtensor(dst):
        dst.copy_(src)
        return
    from torch.distributed.tensor import distribute_tensor

    local = (src.redistribute(dst.device_mesh, dst.placements).to_local()
             if _is_dtensor(src) else distribute_tensor(
                 src, dst.device_mesh, dst.placements,
                 src_data_rank=None).to_local())
    dst.to_local().copy_(local)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


# ------------------------------------------------------------------ RoPE
@functools.lru_cache(maxsize=64)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """1 / theta^(2i/dim), i < dim/2 (f32): the same for every layer and
    step, so made once per (dim, theta, device) — a decode step would
    otherwise spend four launches a layer rebuilding it."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(theta, exps)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions [..., s] -> angles [..., s, dim//2]."""
    freqs = _rope_freqs(dim, float(theta), positions.device)
    return positions[..., None].to(torch.float32) * freqs


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., s, d] with angles [..., s, d//2] (broadcast over heads)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = torch.cos(angles).to(x.dtype)
    s = torch.sin(angles).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(
    x: torch.Tensor,              # [b, h, s, d]
    positions: torch.Tensor,      # [b, s]  (or [b, 3, s] for mrope)
    rope_type: str = "full",
    theta: float = 10_000.0,
    sections: Tuple[int, ...] = (),
) -> torch.Tensor:
    d = x.shape[-1]
    if rope_type == "none":
        return x
    if rope_type == "full":
        return _rotate(x, _rope_angles(positions, d, theta)[:, None])
    if rope_type == "half":
        # chatglm-style 2d rope: rotary on the first half of head dims
        dr = d // 2
        ang = _rope_angles(positions, dr, theta)[:, None]
        return torch.cat([_rotate(x[..., :dr], ang), x[..., dr:]], dim=-1)
    if rope_type == "mrope":
        # qwen2-vl: frequency bands split into (t, h, w) sections, each
        # driven by its own position stream.  positions: [b, 3, s].
        if not sections or sum(sections) != d // 2:
            raise ValueError(f"mrope sections {sections} must sum to {d // 2}")
        full = _rope_angles(positions, d, theta)   # [b, 3, s, d/2]
        parts, start = [], 0
        for sec_i, sec in enumerate(sections):
            parts.append(full[:, sec_i, :, start: start + sec])
            start += sec
        return _rotate(x, torch.cat(parts, dim=-1)[:, None])
    raise ValueError(rope_type)


def mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text-only default: all three M-RoPE streams share positions."""
    return positions[:, None, :].expand(
        positions.shape[0], 3, positions.shape[1])


# ------------------------------------------------------------------- MLP
def mlp(x: torch.Tensor, p: dict, kind: str = "swiglu") -> torch.Tensor:
    """SwiGLU / GeGLU (tanh GELU, as ``jax.nn.gelu(approximate=True)``),
    or the ungated ``gelu`` MLP; full-f32 products."""
    g = matmul_f32(x, p["w1"])
    g = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
    if kind == "gelu":  # plain (whisper-style), no gate
        return matmul_f32(g, p["w2"])
    return matmul_f32(g * matmul_f32(x, p["w3"]), p["w2"])


# -------------------------------------------------------------- attention
def blockwise_attention(
    q: torch.Tensor,     # [b, n_heads, sq, d]
    k: torch.Tensor,     # [b, n_kv, sk, d]
    v: torch.Tensor,     # [b, n_kv, sk, dv]
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention through the ``flash_attention`` kernel,
    differentiable (``kernels.flash_attention.FlashAttention``): output
    [b, n_heads, sq, dv] with v's own head dim (MLA's 128 beside its
    192-dim q and k), scores scaled by d^-1/2.

    Query i sits at position ``q_offset + i`` (top-left alignment, as the
    JAX package's blockwise version): with ``causal`` it sees keys
    j <= q_offset + i.  The JAX version's block sizes, unrolling and
    causal-skip knobs shape its scan, not the function, and have no
    counterpart here: the kernel tiles, masks ragged edges and stops at
    the diagonal itself.

    On ``DTensor`` inputs (a sharded step) each rank launches the kernel
    on its local shard (``_sharded_attention``)."""
    if _is_dtensor(q):
        return _sharded_attention(q, k, v, causal, q_offset)
    return ops.flash_attention(q, k, v, causal=causal, offset=q_offset)


def _sharded_attention(q, k, v, causal: bool, q_offset: int):
    """Attention over ``DTensor``s through ``local_map``: the batch over
    the mesh's data axes (where it divides them), the query heads over
    ``"model"`` (where H divides it), and the kernel on each rank's local
    [b/dp, H/m, s, d] shard.  Key/value heads shard with the query heads
    where KVH divides the axis too; otherwise (e.g. 2 KV heads on a 4-way
    axis) they stay whole on every rank, and the rank's query heads are
    paired with their *global* KV heads before the call — the kernel's
    ``h // (H/KVH)`` would pair local head h with the wrong one — and
    their gradients are summed over ``"model"`` (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    b, H = q.shape[:2]
    KVH = k.shape[1]
    dp = math.prod(sizes[a] for a in names if a in DP_AXES)
    m = sizes.get("model", 1)
    batch = b % dp == 0
    heads = m > 1 and H % m == 0
    kv = heads and KVH % m == 0

    def pl(shard_heads, grad=False) -> list:
        out = []
        for a in names:
            if a in DP_AXES and batch and sizes[a] > 1:
                out.append(Shard(0))
            elif a == "model" and shard_heads:
                out.append(Shard(1))
            elif a == "model" and grad and heads:
                out.append(Partial())
            else:
                out.append(Replicate())
        return out

    g, Hl = H // KVH, H // m if heads else H
    r = mesh.get_local_rank("model") if heads and not kv else 0

    def local(ql, kl, vl):
        if heads and not kv:
            # the local query heads r·Hl + j read global KV head (r·Hl + j)//g
            if Hl % g == 0:
                kl = kl[:, r * Hl // g:(r + 1) * Hl // g]
                vl = vl[:, r * Hl // g:(r + 1) * Hl // g]
            else:
                idx = torch.div(r * Hl + torch.arange(Hl, device=kl.device),
                                g, rounding_mode="floor")
                kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
        return ops.flash_attention(ql, kl, vl, causal=causal, offset=q_offset)

    return local_map(
        local, out_placements=pl(heads),
        in_placements=(pl(heads), pl(kv), pl(kv)),
        in_grad_placements=(pl(heads), pl(kv, True), pl(kv, True)),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def decode_attention(
    q: torch.Tensor,        # [b, n_heads, 1, d]
    k_cache: torch.Tensor,  # [b, n_kv, S, d]
    v_cache: torch.Tensor,  # [b, n_kv, S, d]
    length,                 # int, or [b] tensor — valid cache slots
) -> torch.Tensor:
    """Single-token decode against the cache (plain torch, f32)."""
    b, h, _, d = q.shape
    n_kv, S = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = h // n_kv
    qg = whole_parts(q, 1, n_kv).reshape(b, n_kv, g, d).to(
        torch.float32) * d ** -0.5
    s = matmul_f32(qg, k_cache.to(torch.float32).transpose(-1, -2))
    if isinstance(length, torch.Tensor):
        length = length.reshape(-1, 1)
    valid = torch.arange(S, device=q.device)[None, :] < length
    s = torch.where(valid[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = matmul_f32(p, v_cache.to(torch.float32))
    return out.reshape(b, h, 1, dv).to(q.dtype)

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
has no kernel for it.  ``constrain`` (sharding) waits for the
distributed slice.
"""
from __future__ import annotations

import functools
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
]

_NEG = -1e30


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
    the diagonal itself."""
    return ops.flash_attention(q, k, v, causal=causal, offset=q_offset)


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
    qg = q.reshape(b, n_kv, g, d).to(torch.float32) * d ** -0.5
    s = matmul_f32(qg, k_cache.to(torch.float32).transpose(-1, -2))
    if isinstance(length, torch.Tensor):
        length = length.reshape(-1, 1)
    valid = torch.arange(S, device=q.device)[None, :] < length
    s = torch.where(valid[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = matmul_f32(p, v_cache.to(torch.float32))
    return out.reshape(b, h, 1, dv).to(q.dtype)

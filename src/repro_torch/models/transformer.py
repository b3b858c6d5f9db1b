"""Transformer building blocks of the dense family: GQA/MQA attention
(prefill and decode), the dense FFN and the pre-norm decoder block.

The port of the JAX package's ``models/transformer.py`` (its dense
subset).  Functional: ``block(p, x, ...) -> x`` over a dict of one
layer's tensors.  Decode variants write the new token's key and value
into the cache tensors they are given, in place (the JAX versions return
an updated copy), and return them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .config import ModelConfig
from .layers import (apply_rope, blockwise_attention, decode_attention, mlp,
                     rms_norm)
from ..kernels.ref import matmul_f32

__all__ = [
    "attention",
    "attention_prefill_cache",
    "attention_decode",
    "ffn",
    "decoder_block",
    "decoder_block_decode",
]

_NOT_PORTED = ("ROADMAP queue 1 item 15b (the MoE, MLA, SSM, hybrid, audio and "
               "VLM families)")


def _heads(x, w, n, hd):
    """[b, s, d] @ [d, n·hd] -> [b, n, s, hd] (a transposed view)."""
    b, s, _ = x.shape
    return matmul_f32(x, w).reshape(b, s, n, hd).transpose(1, 2)


def _qkv(x, p, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    return (_heads(x, p["wq"], cfg.n_heads, hd),
            _heads(x, p["wk"], cfg.n_kv_heads, hd),
            _heads(x, p["wv"], cfg.n_kv_heads, hd))


def _rope(t, positions, cfg: ModelConfig):
    return apply_rope(t, positions, cfg.rope_type, cfg.rope_theta,
                      cfg.mrope_sections)


def _out(o, p):
    b, _, s, _ = o.shape
    return matmul_f32(o.transpose(1, 2).reshape(b, s, -1), p["wo"])


def attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Full-sequence (prefill) GQA attention."""
    return attention_prefill_cache(x, p, cfg, positions, causal)[0]


def attention_prefill_cache(x, p, cfg: ModelConfig, positions,
                            causal: bool = True):
    """Prefill: returns (output, (k, v)) with k/v [b, kv, s, hd]."""
    q, k, v = _qkv(x, p, cfg)
    q = _rope(q, positions, cfg)
    k = _rope(k, positions, cfg)
    o = blockwise_attention(q, k, v, causal=causal)
    return _out(o, p), (k, v)


def attention_decode(
    x: torch.Tensor,            # [b, d] single token
    p: dict,
    cfg: ModelConfig,
    cache: Tuple[torch.Tensor, torch.Tensor],   # k/v [b, kv, S, hd]
    length: int,                # current cache fill
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    k_cache, v_cache = cache
    b = x.shape[0]
    S = k_cache.shape[2]
    # jax's dynamic_update_slice would clamp an out-of-range start and
    # overwrite slot S - 1; the port refuses instead
    if not 0 <= length < S:
        raise IndexError(f"attention_decode: cache position {length} outside "
                         f"a cache of {S} slots")
    pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    if cfg.rope_type == "mrope":
        pos = pos[:, None, :].expand(b, 3, 1)
    q, k, v = _qkv(x[:, None], p, cfg)
    q = _rope(q, pos, cfg)
    k = _rope(k, pos, cfg)
    k_cache[:, :, length] = k[:, :, 0]
    v_cache[:, :, length] = v[:, :, 0]
    o = decode_attention(q, k_cache, v_cache, length + 1)
    return matmul_f32(o.reshape(b, -1), p["wo"]), (k_cache, v_cache)


def ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.is_moe:
        raise NotImplementedError(f"MoE FFN: {_NOT_PORTED}")
    return mlp(x, p, cfg.mlp_type)


def decoder_block(x, p, cfg: ModelConfig, positions, causal=True):
    """Pre-norm transformer block."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attention(h, p["attn"], cfg, positions, causal=causal)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn(h, p["ffn"], cfg)


def decoder_block_decode(x, p, cfg: ModelConfig, cache, length):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h, cache = attention_decode(h, p["attn"], cfg, cache, length)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn(h[:, None], p["ffn"], cfg)[:, 0], cache

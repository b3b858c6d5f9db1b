"""Transformer building blocks: GQA/MQA and DeepSeek-V2's multi-head
latent attention (MLA), prefill and decode; the dense and MoE FFN; the
pre-norm decoder block.

The port of the JAX package's ``models/transformer.py``.  Functional:
``block(p, x, ...) -> x`` over a dict of one layer's tensors.  Decode
variants write the new token's key and value (MLA: its compressed
``ckv`` row) into the cache tensors they are given, in place (the JAX
versions return an updated copy), and return them; a position outside
the cache raises (JAX's ``dynamic_update_slice`` would clamp it).  On a
``DTensor`` cache (a sharded step) the write lands in the local shard of
the rank that holds the slot (``layers.write_slot``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .config import ModelConfig
from .layers import (DP_AXES, _is_dtensor, apply_rope, blockwise_attention,
                     constrain, decode_attention, merge_heads, mlp, rms_norm,
                     whole_parts, write_slot)
from .moe import moe_layer
from ..kernels.ref import matmul_f32

__all__ = [
    "attention",
    "attention_prefill_cache",
    "attention_decode",
    "mla_attention",
    "mla_attention_decode",
    "mla_attention_decode_absorbed",
    "ffn",
    "decoder_block",
    "decoder_block_decode",
]

def _heads(x, w, n, hd):
    """[b, s, d] @ [d, n·hd] -> [b, n, s, hd] (a transposed view)."""
    b, s, _ = x.shape
    return whole_parts(matmul_f32(x, w), -1, n).reshape(
        b, s, n, hd).transpose(1, 2)


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
    if s == 1 and _is_dtensor(o):
        # the same values: a DTensor would keep the transpose's strides,
        # with which matmul takes a batched product where the plain path
        # folds into one mm
        o = o.reshape(b, 1, -1)
    else:
        o = merge_heads(o.transpose(1, 2))
    return matmul_f32(o, p["wo"])


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
    _check_position("attention_decode", length, k_cache.shape[2])
    pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    if cfg.rope_type == "mrope":
        pos = pos[:, None, :].expand(b, 3, 1)
    q, k, v = _qkv(x[:, None], p, cfg)
    q = _rope(q, pos, cfg)
    k = _rope(k, pos, cfg)
    write_slot(k_cache, 2, length, k[:, :, 0])
    write_slot(v_cache, 2, length, v[:, :, 0])
    o = decode_attention(q, k_cache, v_cache, length + 1)
    return matmul_f32(o.reshape(b, -1), p["wo"]), (k_cache, v_cache)


def _check_position(name: str, length: int, slots: int) -> None:
    # jax's dynamic_update_slice would clamp an out-of-range start and
    # overwrite slot S - 1; the port refuses instead
    if not 0 <= length < slots:
        raise IndexError(f"{name}: cache position {length} outside a cache "
                         f"of {slots} slots")


# ----------------------------------------------------------------- MLA
def _mla_q(x, p, cfg: ModelConfig, positions):
    """(q_nope, roped q_rope), each [b, H, s, ·]."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _heads(x, p["wq"], cfg.n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, "full",
                                   cfg.rope_theta)


def _mla_qkv(x, p, cfg: ModelConfig, positions):
    """DeepSeek-V2 multi-head latent attention: KV compressed to kv_lora
    dims + a decoupled shared RoPE key.  Returns q [b, H, s, dn + dr],
    k [b, H, s, dn + dr], v [b, H, s, dv] and ckv [b, s, lora + dr]
    (the rope key not yet roped, as JAX's)."""
    b, s, _ = x.shape
    H, dr = cfg.n_heads, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    ckv = matmul_f32(x, p["kv_down"])
    c, k_rope = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    k_rope = apply_rope(k_rope[:, None], positions, "full", cfg.rope_theta)
    k_nope = _heads(c, p["k_up"], H, cfg.qk_nope_dim)
    v = _heads(c, p["v_up"], H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(b, H, s, dr)], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v, ckv


def mla_attention(x, p, cfg: ModelConfig, positions) -> torch.Tensor:
    """Full-sequence (prefill) MLA: q/k of dn + dr dims, v of dv, through
    the ``flash_attention`` kernel."""
    q, k, v, _ = _mla_qkv(x, p, cfg, positions)
    return _out(blockwise_attention(q, k, v, causal=True), p)


def _mla_decode_q(x, p, cfg: ModelConfig, cache, length):
    """The decode step's (q_nope, roped q_rope) [b, H, 1, ·], with the
    token's ckv row (its rope key roped) written into ``cache`` [b, S,
    lora + dr] at ``length``."""
    b = x.shape[0]
    lora = cfg.kv_lora
    _check_position("mla_attention_decode", length, cache.shape[1])
    pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    xq = x[:, None]
    q_nope, q_rope = _mla_q(xq, p, cfg, pos)
    ckv = matmul_f32(xq, p["kv_down"])[:, 0]
    kr = apply_rope(ckv[:, None, None, lora:], pos, "full",
                    cfg.rope_theta)[:, 0, 0]
    write_slot(cache, 1, length, torch.cat([ckv[..., :lora], kr], dim=-1))
    return q_nope, q_rope


def mla_attention_decode(x, p, cfg: ModelConfig, cache, length):
    """One token of MLA against the compressed cache [b, S, lora + dr]
    (roped keys): k_nope and v are rebuilt from the whole cache, in the
    dtype JAX promotes the cache and the weights to (f32 for a bf16 model
    over an f32 cache)."""
    b = x.shape[0]
    H, dr = cfg.n_heads, cfg.qk_rope_dim
    q_nope, q_rope = _mla_decode_q(x, p, cfg, cache, length)
    S = cache.shape[1]
    dt = torch.promote_types(cache.dtype, p["k_up"].dtype)
    c, k_rope = cache[..., :cfg.kv_lora].to(dt), cache[..., cfg.kv_lora:]
    k_nope = _heads(c, p["k_up"].to(dt), H, cfg.qk_nope_dim)
    v = _heads(c, p["v_up"].to(dt), H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, None].expand(b, H, S, dr).to(dt)],
                  dim=-1)
    o = decode_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                         length + 1)
    return matmul_f32(o.reshape(b, -1), p["wo"]), cache


def mla_attention_decode_absorbed(x, p, cfg: ModelConfig, cache, length):
    """MLA decode with the up-projections absorbed (``cfg.mla_absorb``):
    scores act on the compressed cache through q_nope·W_ukᵀ, the output
    is (p·c)·W_uv; k_nope and v never materialise.  All in f32."""
    b = x.shape[0]
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    lora = cfg.kv_lora
    f32 = torch.float32
    q_nope, q_rope = _mla_decode_q(x, p, cfg, cache, length)
    c = cache[..., :lora].to(f32)                              # [b, S, lora]
    k_rope = cache[..., lora:].to(f32)                         # [b, S, dr]
    k_up3 = p["k_up"].reshape(lora, H, dn).to(f32)
    v_up3 = p["v_up"].reshape(lora, H, dv).to(f32)
    # q_abs[b, h] = q_nope[b, h] · k_up3[:, h]ᵀ
    q_abs = matmul_f32(q_nope[:, :, 0].to(f32).transpose(0, 1),
                       k_up3.permute(1, 2, 0)).transpose(0, 1)   # [b, H, lora]
    s = (matmul_f32(q_abs, c.transpose(1, 2))
         + matmul_f32(q_rope[:, :, 0].to(f32), k_rope.transpose(1, 2))) * (
             (dn + dr) ** -0.5)                                 # [b, H, S]
    valid = torch.arange(cache.shape[1], device=x.device) < length + 1
    s = torch.where(valid, s, -1e30)
    out_c = matmul_f32(torch.softmax(s, dim=-1), c)            # [b, H, lora]
    o = matmul_f32(out_c.transpose(0, 1), v_up3.transpose(0, 1))  # [H, b, dv]
    o = o.transpose(0, 1).reshape(b, H * dv).to(x.dtype)
    return matmul_f32(o, p["wo"]), cache


# ------------------------------------------------------------------ FFN
def ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.is_moe:
        return moe_layer(x, p, cfg)
    return mlp(x, p, cfg.mlp_type)


# -------------------------------------------------------- decoder block
def decoder_block(x, p, cfg: ModelConfig, positions, causal=True):
    """Pre-norm transformer block; its input and output constrained to
    batch over the data axes (and, with ``cfg.seq_shard``, sequence over
    ``"model"``), as the JAX package constrains them.  On ``DTensor``s the
    attention and FFN outputs are constrained too: a row-parallel product
    (heads or mlp over ``"model"``) leaves a pending sum (``Partial``),
    which ``DTensor`` would carry through the next norm and then replicate
    the next weights to keep; the constraint reduces it where GSPMD
    would."""
    act_spec = (DP_AXES, "model" if cfg.seq_shard else None, None)
    x = constrain(x, act_spec)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.is_mla:
        h = mla_attention(h, p["attn"], cfg, positions)
    else:
        h = attention(h, p["attn"], cfg, positions, causal=causal)
    x = x + constrain(h, act_spec)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return constrain(x + constrain(ffn(h, p["ffn"], cfg), act_spec), act_spec)


def decoder_block_decode(x, p, cfg: ModelConfig, cache, length):
    """One token through a block; ``cache`` is (k, v) [b, kv, S, hd], or
    for MLA the ckv tensor [b, S, lora + dr].  The token's activations are
    constrained to batch over the data axes (the branches' outputs too,
    as in ``decoder_block``)."""
    act = (DP_AXES, None)
    x = constrain(x, act)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.is_mla and cfg.mla_absorb:
        h, cache = mla_attention_decode_absorbed(h, p["attn"], cfg, cache,
                                                 length)
    elif cfg.is_mla:
        h, cache = mla_attention_decode(h, p["attn"], cfg, cache, length)
    else:
        h, cache = attention_decode(h, p["attn"], cfg, cache, length)
    x = x + constrain(h, act)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + constrain(ffn(h[:, None], p["ffn"], cfg)[:, 0], act), cache

"""Mixture-of-experts layer — group-wise sort-based dispatch.

The port of the JAX package's ``models/moe.py``.  Tokens are routed
within their sequence group (the leading batch axis): top-k of the
router's softmax, a stable sort of the (token, choice) pairs by expert,
each pair's rank within its expert, and the first ``capacity`` pairs of
each expert kept; the rest go to an overflow row that is discarded.
Every integer (the top-k, the order, the ranks, the slots) equals the
JAX package's:

* ``lax.top_k`` puts the lower index first among equal values; here the
  top k come from a *stable* descending sort, which does the same;
* ``jnp.argsort`` is stable; ``torch.argsort`` is stable only when asked
  (``stable=True``), and otherwise which pairs an expert's capacity
  drops could differ.

The router and its softmax run in f32; the expert products are batched
full-f32 products (``ref.matmul_f32``: [E, b·C, d] by [E, d, f]), as
every other product of the port's LM.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (DP_AXES, _is_dtensor, batch_placements, constrain, mlp,
                     replicated)
from ..kernels.ref import matmul_f32

__all__ = ["capacity", "combine", "dispatch", "moe_layer", "route"]


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Slots per expert for a group of ``group_tokens`` tokens:
    ceil(s·k·cf/E) rounded up to a multiple of 8, at least 8."""
    c = math.ceil(
        group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(x: torch.Tensor, router: torch.Tensor,
          cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router's choice for x [b, s, d]: (gates [b, s, k] f32,
    renormalised over the top k, and expert ids [b, s, k] int64, the
    largest probability first, ties to the lower expert id)."""
    logits = matmul_f32(x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.top_k], idx[..., :cfg.top_k]
    return gates / torch.sum(gates, dim=-1, keepdim=True), idx


def _experts(eb: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """The expert FFNs on eb [b, E, C, d]: one batched product per
    weight over [E, b·C, d]."""
    b, E, C, d = eb.shape
    xe = eb.transpose(0, 1).reshape(E, b * C, d)
    g = matmul_f32(xe, p["we1"])
    g = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
    out = matmul_f32(g * matmul_f32(xe, p["we3"]), p["we2"])
    return out.reshape(E, b, C, d).transpose(0, 1)


def _dispatch(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The group-local dispatch of x [b, s, d] (everything batched over
    b): the expert buffer eb [b, E, C, d] and what the combine needs —
    (eb, slot, keep, order, gates)."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, s)
    sk = s * k
    dev = x.device

    gates, idx = route(x, router, cfg)

    e_flat = idx.reshape(b, sk)
    order = torch.argsort(e_flat, dim=1, stable=True)          # [b, sk]
    e_sorted = torch.gather(e_flat, 1, order)
    t_sorted = order // k                                      # token in group
    start = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(b, E).contiguous())
    rank = torch.arange(sk, device=dev)[None] - torch.gather(start, 1, e_sorted)
    keep = rank < C
    slot = torch.where(keep, e_sorted * C + rank, E * C)       # overflow bin

    rows = torch.arange(b, device=dev)[:, None]
    x_sorted = x[rows, t_sorted]                               # [b, sk, d]
    buf = torch.zeros((b * (E * C + 1), d), dtype=x.dtype, device=dev)
    buf.index_add_(0, (rows * (E * C + 1) + slot).reshape(-1),
                   x_sorted.reshape(-1, d))
    eb = buf.view(b, E * C + 1, d)[:, :-1].reshape(b, E, C, d)
    return eb, slot, keep, order, gates


def _combine(out_e, slot, keep, order, gates, k: int, dtype) -> torch.Tensor:
    """Undo the sort and weight by the gates: out_e [b, E, C, d] ->
    [b, s, d] in ``dtype`` (x's)."""
    b, E, C, d = out_e.shape
    sk = order.shape[1]
    dev = out_e.device
    rows = torch.arange(b, device=dev)[:, None]
    flat = torch.cat([out_e.reshape(b, E * C, d),
                      torch.zeros((b, 1, d), dtype=dtype, device=dev)], 1)
    del out_e
    picked = flat[rows, slot] * keep[..., None].to(dtype)      # [b, sk, d]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(sk, device=dev).expand(b, sk).contiguous())
    per_tk = picked[rows, inv].reshape(b, sk // k, k, d)
    return matmul_f32(gates.to(dtype)[:, :, None], per_tk)[:, :, 0]


def dispatch(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """``moe_layer``'s dispatch of x [b, s, d]: (eb, slot, keep, order,
    gates).  On ``DTensor``s each rank routes its own groups (batch rows;
    the router whole on every rank, its gradient summed over the data
    axes), so every integer equals the unsharded dispatch's."""
    if not _is_dtensor(x):
        return _dispatch(x, router, cfg)
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rows = batch_placements(mesh, x.shape[0])
    return local_map(
        lambda xl, rl: _dispatch(xl, rl, cfg), out_placements=(rows,) * 5,
        in_placements=(rows, replicated(mesh)),
        in_grad_placements=(rows, batch_placements(mesh, x.shape[0],
                                                   grad=True)),
        device_mesh=mesh, redistribute_inputs=True)(x, router)


def combine(out_e, slot, keep, order, gates, k: int, dtype):
    """``moe_layer``'s combine of the experts' outputs out_e [b, E, C,
    d] -> [b, s, d]; on ``DTensor``s each rank combines its own groups,
    every expert's rows gathered to it."""
    if not _is_dtensor(out_e):
        return _combine(out_e, slot, keep, order, gates, k, dtype)
    from torch.distributed.tensor.experimental import local_map

    mesh = out_e.device_mesh
    rows = batch_placements(mesh, out_e.shape[0])
    return local_map(
        lambda *a: _combine(*a, k, dtype), out_placements=rows,
        in_placements=(rows,) * 5, device_mesh=mesh,
        redistribute_inputs=True)(out_e, slot, keep, order, gates)


def moe_layer(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: [b, s, d] -> [b, s, d].  p: router, we1/we3/we2, shared.  On
    ``DTensor``s (a sharded step) the dispatch and the combine run on
    each rank's groups (``local_map``), and the expert buffers shard
    groups over the data axes and experts over ``"model"`` (EP), as the
    JAX package constrains them."""
    eb, slot, keep, order, gates = dispatch(x, p["router"], cfg)
    eb = constrain(eb, (DP_AXES, "model", None, None))
    out = combine(
        constrain(_experts(eb, p, cfg), (DP_AXES, "model", None, None)),
        slot, keep, order, gates, cfg.top_k, x.dtype)
    if cfg.n_shared_experts:
        out = out + mlp(x, p["shared"], cfg.mlp_type)
    return out

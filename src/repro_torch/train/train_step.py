"""Training step: loss → grad → AdamW, with microbatch gradient
accumulation and an optional int8 gradient compressor — the port of
the JAX package's ``train/train_step.py``.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over detached
copies of the parameter leaves marked ``requires_grad_()``; the
microbatch scan becomes a loop whose gradients are summed and then
divided, in the JAX scan's order.

The step runs as well on ``DTensor`` leaves (parameters placed by
``sharding.param_shardings``, the batch by ``batch_shardings``, inside
``sharding.use_mesh``): the loss is made replicated, and each gradient
is redistributed to its parameter's placements — the reduction GSPMD
fuses into JAX's step — before the optimizer sees it.  A step on
``DTensor``s outside any ``use_mesh`` block runs under its parameters'
mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models import train_loss
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, OptState, adamw_update
from .tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainConfig", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # gradient accumulation steps
    compress_grads: bool = False   # int8 error-feedback (cross-pod)
    opt: AdamWConfig = AdamWConfig()


def _split_microbatches(batch: Dict, n: int) -> Dict:
    def re(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of {n} "
                             "microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    return {k: re(v) for k, v in batch.items()}


def _compress_int8(g: torch.Tensor) -> torch.Tensor:
    """One-shot int8 quantization with a per-tensor scale (round half
    to even, as ``jnp.round``), back to f32."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` (the loss: a pending sum over the batch's shards)
    as a replicated one; a plain tensor as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _placed_as(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` with its parameter ``p``'s placements."""
    if not _is_dtensor(p):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros of ``p``'s shape (and placements, for a ``DTensor``)."""
    if _is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns step(params, opt_state, batch) -> (params, opt, metrics):
    ``batch`` a dict of [b, s] integer tensors on the parameters'
    device, ``metrics`` f32 scalars ``loss``, ``grad_norm``, ``lr``."""

    def value_and_grad(params, mb):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = _replicated(train_loss(leaves, mb, cfg))
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        return loss.detach(), tree_map(_placed_as, params,
                                       tree_unflatten(params, grads))

    def step(params, opt_state: OptState, batch):
        from ..sharding.partition import current_mesh, use_mesh

        first = tree_leaves(params)[0]
        if _is_dtensor(first) and current_mesh() is None:
            with use_mesh(first.device_mesh):
                return _step(params, opt_state, batch)
        return _step(params, opt_state, batch)

    def _step(params, opt_state: OptState, batch):
        n = tcfg.microbatches
        if n > 1:
            mbs = _split_microbatches(batch, n)
            gsum = tree_map(_zeros_f32, params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(n):
                l, g = value_and_grad(params, {k: v[i]
                                               for k, v in mbs.items()})
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / n, gsum)
            loss = lsum / n
        else:
            loss, grads = value_and_grad(params, batch)

        with torch.no_grad():
            if tcfg.compress_grads:
                grads = tree_map(_compress_int8, grads)
            # a label for torch.profiler: the optimizer's device time
            with torch.profiler.record_function("adamw_update"):
                params, opt_state, om = adamw_update(params, grads, opt_state,
                                                     tcfg.opt)
        return params, opt_state, dict(loss=loss, **om)

    return step

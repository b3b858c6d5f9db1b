"""AdamW over a parameter tree — the port of the JAX package's
``train/optimizer.py``.

Functions over a nested dict of tensors, in float32 tensor arithmetic:
the schedule, the ``b ** step`` corrections and the clip scale are f32
tensors, never Python floats, and every expression keeps the JAX
package's order (decay added to the Adam step, then scaled by the
learning rate), so an update equals JAX's to f32 rounding.  Leaves are
visited in JAX's flatten order (dict keys sorted).  Not
``torch.optim.AdamW``: it orders decay and update differently and has
neither the clip nor the schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "abstract_opt_state",
           "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: Any = torch.float32


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor   # int32 scalar


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_opt_state(params_abstract,
                       cfg: AdamWConfig = AdamWConfig()) -> OptState:
    """``adamw_init``'s state as meta tensors (no allocation): moments of
    each parameter's shape in ``cfg.moment_dtype``, a scalar int32
    ``step``."""
    meta = lambda p: torch.empty(p.shape, dtype=cfg.moment_dtype,
                                 device="meta")
    return OptState(mu=tree_map(meta, params_abstract),
                    nu=tree_map(meta, params_abstract),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 10 % of ``cfg.lr``; ``step``
    an f32 tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in f32, summed leaf by leaf in order."""
    tot = 0
    for x in tree_leaves(tree):
        tot = tot + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(tot)


def adamw_update(params, grads, state: OptState,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step: returns (params, OptState, {grad_norm, lr})."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    lr = _schedule(cfg, stepf)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    c1 = 1 - torch.pow(cfg.b1, stepf)
    c2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                m.to(cfg.moment_dtype), v.to(cfg.moment_dtype))

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), OptState(mu=pick(1), nu=pick(2), step=step), dict(
        grad_norm=gn, lr=lr)

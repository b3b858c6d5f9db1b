"""Weights that both packages load.

``numpy_params`` draws a parameter tree in the JAX package's layout and
distribution (N(0, 1) · fan_in^-1/2, ones for norms and Mamba2's ``D``,
zeros for its ``A_log`` and ``dt_bias``) from
``np.random.default_rng(seed)``; the JAX package takes it as it is
(``jax.numpy.asarray`` of every leaf) and ``params_from_numpy`` carries
it to torch, so the two packages run the same weights.  Any tree of
numpy arrays in that layout carries across the same way.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .model import _put, fan_in, flat_items, param_specs

__all__ = ["numpy_params", "params_from_numpy"]


def numpy_params(cfg: ModelConfig, seed: int = 0) -> Dict:
    """Seeded float32 weights: one ``default_rng(seed)`` stream drawn
    leaf by leaf in ``param_specs`` order; a constant leaf (ones, zeros)
    draws nothing from it."""
    rng = np.random.default_rng(seed)
    out: Dict = {}
    for path, spec in flat_items(param_specs(cfg)):
        if spec.init == "ones":
            v = np.ones(spec.shape, np.float32)
        elif spec.init in ("zeros", "a_log"):
            v = np.zeros(spec.shape, np.float32)
        else:
            v = rng.standard_normal(spec.shape, dtype=np.float32)
            v *= np.float32(fan_in(spec.shape) ** -0.5)
        _put(out, path, v)
    return out


def params_from_numpy(tree: Dict, cfg: ModelConfig, device="cuda",
                      dtype=torch.float32) -> Dict:
    """The same tree as tensors of ``dtype`` on ``device``; every leaf
    must have the shape ``param_specs(cfg)`` gives it."""
    dev = resolve_device(device)
    want = dict(flat_items(param_specs(cfg)))
    got = dict(flat_items(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter tree has {sorted(got)}, expected "
                         f"{sorted(want)}")
    out: Dict = {}
    for path, arr in got.items():
        if tuple(arr.shape) != want[path].shape:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                             f"{want[path].shape}")
        _put(out, path, torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=dtype))
    return out

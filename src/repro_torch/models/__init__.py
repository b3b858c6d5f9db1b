"""Model zoo, every family (dense, MoE, VLM, SSM, hybrid, audio): the
JAX package's ``repro.models`` API on PyTorch, training loss included
(sharding and the dry-run's specs are not ported)."""
from .config import ModelConfig, reduced
from .model import (
    SHAPE_SETS,
    DenseLM,
    LayerTree,
    cache_specs,
    forward,
    init_cache,
    init_params,
    prefill,
    serve_step,
    shape_applicable,
    train_loss,
)

__all__ = [
    "ModelConfig",
    "reduced",
    "SHAPE_SETS",
    "DenseLM",
    "LayerTree",
    "cache_specs",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
    "serve_step",
    "shape_applicable",
    "train_loss",
]

"""Model zoo, the dense and MoE families: the JAX package's
``repro.models`` API on PyTorch, training loss included for the dense
family (sharding and the dry-run's specs are not ported)."""
from .config import ModelConfig, reduced
from .model import (
    SHAPE_SETS,
    DecoderBlock,
    DenseLM,
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
    "DecoderBlock",
    "DenseLM",
    "cache_specs",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
    "serve_step",
    "shape_applicable",
    "train_loss",
]

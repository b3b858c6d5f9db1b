"""Model zoo, the dense family: the JAX package's ``repro.models`` API
on PyTorch (training, sharding and the dry-run's specs are not ported)."""
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
]

"""Model zoo, every family (dense, MoE, VLM, SSM, hybrid, audio): the
JAX package's ``repro.models`` API on PyTorch, training loss included,
with the abstract values (meta tensors) that the sharding rules and
the dry-run place."""
from .config import ModelConfig, reduced
from .model import (
    SHAPE_SETS,
    DenseLM,
    LayerTree,
    abstract_params,
    cache_specs,
    forward,
    init_cache,
    init_params,
    input_specs,
    logical_axes,
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
    "abstract_params",
    "cache_specs",
    "forward",
    "init_cache",
    "init_params",
    "input_specs",
    "logical_axes",
    "prefill",
    "serve_step",
    "shape_applicable",
    "train_loss",
]

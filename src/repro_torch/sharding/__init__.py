"""The LM sharding rules on ``DeviceMesh`` / ``DTensor`` — the JAX
package's ``repro.sharding`` without its jax<0.5 ``shard_map`` shim."""
from .partition import (
    LOGICAL_RULES,
    MeshShape,
    Sharding,
    batch_shardings,
    cache_shardings,
    data_axes,
    distribute,
    param_shardings,
    placements,
    resolve_spec,
)

__all__ = [
    "LOGICAL_RULES",
    "MeshShape",
    "Sharding",
    "batch_shardings",
    "cache_shardings",
    "data_axes",
    "distribute",
    "param_shardings",
    "placements",
    "resolve_spec",
]

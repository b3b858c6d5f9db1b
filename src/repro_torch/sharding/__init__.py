"""The LM sharding rules on ``DeviceMesh`` / ``DTensor`` — the JAX
package's ``repro.sharding`` without its jax<0.5 ``shard_map`` shim
(``use_mesh`` takes the place of its ``set_mesh``)."""
from .partition import (
    LOGICAL_RULES,
    MeshShape,
    Sharding,
    batch_shardings,
    cache_shardings,
    current_mesh,
    data_axes,
    distribute,
    param_shardings,
    placements,
    resolve_spec,
    use_mesh,
)

__all__ = [
    "LOGICAL_RULES",
    "MeshShape",
    "Sharding",
    "batch_shardings",
    "cache_shardings",
    "current_mesh",
    "data_axes",
    "distribute",
    "param_shardings",
    "placements",
    "resolve_spec",
    "use_mesh",
]

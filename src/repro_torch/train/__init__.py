"""Training substrate on PyTorch: AdamW, the train step with microbatch
accumulation, checkpoint/restart (file-compatible with the JAX
package's), ``remesh`` onto a new ``DeviceMesh`` and straggler
detection — the JAX package's ``repro.train``."""
from .optimizer import (AdamWConfig, OptState, abstract_opt_state,
                        adamw_init, adamw_update)
from .train_step import TrainConfig, make_train_step
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .elastic import StragglerDetector, remesh

__all__ = [
    "AdamWConfig",
    "OptState",
    "abstract_opt_state",
    "adamw_init",
    "adamw_update",
    "TrainConfig",
    "make_train_step",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "StragglerDetector",
    "remesh",
]

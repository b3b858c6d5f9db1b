"""Streaming edge events: incremental θ maintenance + hierarchy repair
(the port of the JAX package's ``repro.streaming``).

``events`` batches and coalesces edge inserts/deletes into
micro-epochs; ``delta`` computes exact wedge-local support deltas and
the dirty-partition set; ``update`` owns the live
:class:`~repro_torch.streaming.update.StreamState` whose per-epoch
output is bit-identical to a from-scratch re-peel (the machine-checked
claim — see ``tests/test_torch_streaming.py``).
"""
from .events import (  # noqa: F401
    EdgeEvent,
    apply_events,
    coalesce,
    load_trace,
    make_random_events,
    save_trace,
)
from .update import EpochReport, StreamConfig, StreamState  # noqa: F401

__all__ = [
    "EdgeEvent",
    "apply_events",
    "coalesce",
    "load_trace",
    "make_random_events",
    "save_trace",
    "EpochReport",
    "StreamConfig",
    "StreamState",
]

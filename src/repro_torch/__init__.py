"""PyTorch port of PBNG (parallel peeling of bipartite networks) for
NVIDIA Hopper.

A second package beside the JAX reference ``repro``: the csr engine's
tip and wing decomposition, its FD drivers and four hand-written CUDA
kernels (``repro_torch/kernels/csrc``).  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  See ``repro_torch/README.md``.
"""
from .core.graph import (
    PAPER_PROXIES,
    BipartiteGraph,
    from_tsv,
    paper_proxy_dataset,
    powerlaw_bipartite,
    random_bipartite,
)
from .core.peel import tip_decomposition, wing_decomposition
from .core.peelspec import PeelResult, PeelStats

__all__ = [
    "BipartiteGraph",
    "PAPER_PROXIES",
    "PeelResult",
    "PeelStats",
    "from_tsv",
    "paper_proxy_dataset",
    "powerlaw_bipartite",
    "random_bipartite",
    "tip_decomposition",
    "wing_decomposition",
]

"""PyTorch port of PBNG (parallel peeling of bipartite networks) for
NVIDIA Hopper.

A second package beside the JAX reference ``repro``: tip and wing
decomposition on the csr, beindex and dense engines with the csr FD
drivers, the real-graph path (out-of-core ingest, tiled ⋈init), the
hierarchy of dense subgraphs and its query service, the dense-family
LM serving path (``repro_torch.models``, ``repro_torch.serve``), and
twelve hand-written CUDA kernels (``repro_torch/kernels/csrc``).  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.  See ``repro_torch/README.md``.
"""
from .core.graph import (
    PAPER_PROXIES,
    BipartiteGraph,
    from_tsv,
    paper_proxy_dataset,
    powerlaw_bipartite,
    random_bipartite,
)
from .core.beindex import BEIndex, build_beindex
from .core.csr import TileStats, iter_wedge_tiles, tiled_butterfly_init
from .core.peel import (tip_decomposition, wing_decomposition,
                        wing_decomposition_bepc)
from .core.peelspec import PeelResult, PeelStats
from .data import IngestedGraph, ingest_edges, load_ingested
from .hierarchy import (
    Hierarchy,
    HierarchyService,
    HQuery,
    build_hierarchy,
    load_hierarchy,
    pack_forest,
    save_hierarchy,
)

__all__ = [
    "BEIndex",
    "BipartiteGraph",
    "HQuery",
    "Hierarchy",
    "HierarchyService",
    "IngestedGraph",
    "PAPER_PROXIES",
    "PeelResult",
    "PeelStats",
    "TileStats",
    "build_beindex",
    "build_hierarchy",
    "from_tsv",
    "ingest_edges",
    "iter_wedge_tiles",
    "load_hierarchy",
    "load_ingested",
    "pack_forest",
    "paper_proxy_dataset",
    "powerlaw_bipartite",
    "random_bipartite",
    "save_hierarchy",
    "tiled_butterfly_init",
    "tip_decomposition",
    "wing_decomposition",
    "wing_decomposition_bepc",
]

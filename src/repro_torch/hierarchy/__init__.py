"""Hierarchy of dense subgraphs: θ → packed forest → queries → service.

* :mod:`build`     — θ → packed forest (min-label propagation of every
  level's components on the device, numpy assembly).
* :mod:`query`     — O(1)/O(log) queries on the forest's device tensors
  (containment, subgraph masks, LCA, density profiles).
* :mod:`serialize` — versioned flat-npz save/load, file-compatible with
  the JAX package.
* :mod:`serve`     — :class:`HierarchyService`, a slot-batched query
  engine over device tensors.
* :mod:`pool`      — :class:`ForestPool`, many tenants' forests stacked
  into shape-bucketed device tensors behind an LRU artifact cache.
* :mod:`multiserve` — :class:`MultiTenantService`, cross-tenant
  slot-batched mixed-op serving: one dispatch signature per shape
  bucket, counted.
"""
from .build import Hierarchy, build_hierarchy
from .multiserve import MTQuery, MultiTenantService
from .pool import ForestPool, PoolFull
from .query import (
    PackedForest,
    density_profile,
    depth_and_up,
    extend_up,
    lca_entities,
    lca_nodes,
    max_k_containing,
    node_of,
    pack_forest,
    subgraph_at,
    top_densest_leaves,
)
from .serialize import FORMAT_VERSION, load_hierarchy, save_hierarchy
from .serve import OPS, HierarchyService, HQuery

__all__ = [
    "Hierarchy",
    "build_hierarchy",
    "PackedForest",
    "pack_forest",
    "max_k_containing",
    "node_of",
    "subgraph_at",
    "lca_nodes",
    "lca_entities",
    "density_profile",
    "top_densest_leaves",
    "FORMAT_VERSION",
    "save_hierarchy",
    "load_hierarchy",
    "HierarchyService",
    "HQuery",
    "OPS",
    "depth_and_up",
    "extend_up",
    "ForestPool",
    "PoolFull",
    "MTQuery",
    "MultiTenantService",
]

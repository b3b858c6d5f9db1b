"""Dirty-subtree hierarchy repair for streaming updates (the port of the
JAX package's ``hierarchy/repair.py``).

The forest is a pure function of (graph, θ): per-level component
labels → deterministic host assembly (:func:`build._assemble_from_labels`).
Levels are mutually independent fixpoints, so repair recomputes ONLY
the dirty levels' label rows on the device and splices them into the
cached label matrix; clean rows are carried over through the monotone
old→new entity id map (min-id component representatives survive a
monotone relabeling).  The assembly then re-runs in full — it is
host-side, and running it unchanged is what makes the repaired forest
**bit-identical** to a from-scratch build (asserted after every epoch
by ``tests/test_torch_streaming.py`` and ``chip_smoke.py``).

Level k is *clean* iff the previous epoch computed it, its member set
(entities with θ ≥ k) is unchanged by key, and no structurally touched
entity is a member on either side — membership gives the same vertex
set, untouchedness gives the same butterfly connectivity, so the
components match.  A θ-changed entity dirties exactly the levels in
(min(θold, θnew), max(θold, θnew)] where its membership flips; a
touched / inserted / deleted entity dirties every level it belongs to
on either side.

**Where the label cache lives: host memory.**  The cache is the (L, n)
int64 label matrix of the previous epoch.  On tip-1m (100 000 U
vertices, 1 152 levels) that is 921.6 MB, and as much again for the
epoch's new matrix while it is assembled.  Both fit either memory, but
every consumer of a row is on the host: the labelling
(``_component_labels_per_level``) already copies each level block back
for the numpy assembly, and the clean rows are remapped by host index
arrays.  Keeping the cache on the card would add a copy of every carried
row each epoch and save nothing.

:func:`dirty_subtrees` is the serving-side view of the same locality:
preorder stamps make each dirty node's subtree a contiguous
``ent_order[estart:eend)`` slice of the packed forest, so the
stale-but-bounded window during repair is a handful of slices, not the
whole forest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import obs
from ..core.graph import BipartiteGraph
from ..core.peel import PeelResult
from ..device import resolve_device
from .build import (
    _BIG,
    Hierarchy,
    _assemble_from_labels,
    _component_labels_per_level,
)

__all__ = ["LabelCache", "repair_hierarchy", "dirty_subtrees"]


@dataclasses.dataclass
class LabelCache:
    """Per-level component labels of the previous epoch (the reusable
    half of the forest build)."""

    levels: np.ndarray   # (L,) int64 ascending distinct θ levels ≥ 1
    labels: np.ndarray   # (L, n_entities) int64; _BIG marks dead entities
    theta: np.ndarray    # (n_entities,) int64 — θ the labels were built at


def _dirty_levels(
    levels_new: np.ndarray,
    cache: LabelCache,
    theta_new: np.ndarray,
    old_common: np.ndarray,
    new_common: np.ndarray,
    touched_old: np.ndarray,
    touched_new: np.ndarray,
) -> np.ndarray:
    """Bool mask over ``levels_new``: which levels must recompute."""
    L = levels_new.size
    diff = np.zeros(L + 1, dtype=np.int64)

    def mark(lo_excl: np.ndarray, hi_incl: np.ndarray) -> None:
        # dirty every level k with lo_excl < k <= hi_incl
        a = np.searchsorted(levels_new, lo_excl, side="right")
        b = np.searchsorted(levels_new, hi_incl, side="right")
        keep = a < b
        np.add.at(diff, a[keep], 1)
        np.add.at(diff, b[keep], -1)

    theta_old = cache.theta
    old_only = np.ones(theta_old.size, dtype=bool)
    old_only[old_common] = False
    new_only = np.ones(theta_new.size, dtype=bool)
    new_only[new_common] = False
    # touched / inserted / deleted: dirty every level they belong to
    prefix_hi = np.concatenate([
        theta_old[old_only | touched_old],
        theta_new[new_only | touched_new],
    ])
    if prefix_hi.size:
        mark(np.zeros(1, dtype=np.int64),
             np.asarray([prefix_hi.max()], dtype=np.int64))
    # θ-changed survivors: membership flips in (min, max]
    to = theta_old[old_common]
    tn = theta_new[new_common]
    chg = to != tn
    if chg.any():
        mark(np.minimum(to[chg], tn[chg]), np.maximum(to[chg], tn[chg]))
    dirty = np.cumsum(diff[:L]) > 0
    dirty |= ~np.isin(levels_new, cache.levels)
    return dirty


def repair_hierarchy(
    g: BipartiteGraph,
    result: Union[PeelResult, np.ndarray],
    kind: str = "wing",
    side: str = "u",
    cache: Optional[LabelCache] = None,
    old_common: Optional[np.ndarray] = None,
    new_common: Optional[np.ndarray] = None,
    touched_old: Optional[np.ndarray] = None,
    touched_new: Optional[np.ndarray] = None,
    meta: Optional[Dict] = None,
    level_block: int = 32,
    device="cuda",
) -> Tuple[Hierarchy, LabelCache, int, int]:
    """Rebuild the forest, recomputing only the dirty levels (their
    labels on ``device``).

    With ``cache=None`` every level computes fresh (the first epoch /
    the full-build fallback).  Returns ``(hierarchy, new_cache,
    levels_dirty, levels_total)``; the hierarchy is bit-identical to
    ``build_hierarchy(g, result, kind, side)`` however many levels were
    reused."""
    if kind not in ("wing", "tip"):
        raise ValueError(kind)
    dev = resolve_device(device)
    gg = g if (kind == "wing" or side == "u") else g.transpose()
    if isinstance(result, PeelResult):
        theta = np.asarray(result.theta, dtype=np.int64)
        prov = result.provenance()
    else:
        theta = np.asarray(result, dtype=np.int64)
        prov = {}
    n_ent = gg.m if kind == "wing" else gg.n_u
    if theta.shape != (n_ent,):
        raise ValueError(
            f"theta has shape {theta.shape}, expected ({n_ent},) for "
            f"kind={kind!r}")

    levels = np.unique(theta[theta > 0])
    L = levels.size
    if cache is None:
        dirty = np.ones(L, dtype=bool)
    else:
        dirty = _dirty_levels(
            levels, cache, theta, old_common, new_common,
            touched_old, touched_new)
    n_dirty = int(dirty.sum())

    with obs.span("hierarchy.repair", cat="hierarchy", kind=kind,
                  levels=L, levels_dirty=n_dirty):
        labels = np.empty((L, n_ent), dtype=np.int64)
        if cache is not None and n_dirty < L:
            # carry clean rows through the monotone old→new id map:
            # label values are member entity ids (all common on a clean
            # level), so translating them preserves the component min
            old2new = np.full(cache.theta.size, _BIG, dtype=np.int64)
            old2new[old_common] = new_common
            old_row = {int(k): i for i, k in enumerate(cache.levels)}
            for i in np.where(~dirty)[0]:
                row_old = cache.labels[old_row[int(levels[i])]]
                row = np.full(n_ent, _BIG, dtype=np.int64)
                vals = row_old[old_common]
                alive = vals != _BIG
                mapped = np.where(alive, old2new[np.where(alive, vals, 0)],
                                  _BIG)
                row[new_common] = mapped
                labels[i] = row
        if n_dirty:
            with obs.span("hierarchy.labels", cat="hierarchy",
                          levels=n_dirty):
                fresh = _component_labels_per_level(
                    gg, theta, levels[dirty], kind,
                    level_block=level_block, device=dev)
            labels[dirty] = fresh

        h = _assemble_from_labels(
            gg, theta, levels, labels, kind, side, prov, meta)
    return h, LabelCache(levels.copy(), labels, theta.copy()), n_dirty, L


def dirty_subtrees(
    h: Hierarchy, entity_ids: np.ndarray
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """The packed-forest regions an affected entity set can invalidate.

    Returns ``(nodes, slices)``: the affected entities' home nodes and
    the merged ``[estart, eend)`` intervals of their subtrees in
    ``ent_order`` — contiguous by the preorder stamps, so a serving
    layer can bound answer staleness during repair to Σ slice lengths
    entities instead of flagging the whole forest."""
    entity_ids = np.asarray(entity_ids)
    if entity_ids.size == 0:
        return np.zeros(0, dtype=np.int64), []
    nodes = np.unique(h.entity_node[entity_ids]).astype(np.int64)
    ivs = sorted((int(h.estart[x]), int(h.eend[x])) for x in nodes)
    merged: List[Tuple[int, int]] = []
    for lo, hi in ivs:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return nodes, merged

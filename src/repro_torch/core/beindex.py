"""Bloom-Edge-Index (BE-Index, §2.3) — paper-faithful butterfly index.

A *maximal priority bloom* is a (2,k)-biclique whose dominant 2-vertex set
contains the bloom's highest-priority vertex (priority = decreasing degree
over the combined vertex set, ties by id).  Every butterfly lives in
exactly one bloom (property 2); an edge shares k−1 butterflies with its
twin and 1 with every other bloom edge (property 1).

Construction happens on the device that the caller names, in plain
torch ops: every wedge slot of a CSR is enumerated and filtered, and
stable sorts group the slots into blooms; the four flat arrays come
back to the host once, as numpy.  Peeling consumes them on the device:
CD rounds through int32 ``index_add_`` (``core.peel._wing_update``),
the replacement for the paper's atomics, and the whole FD phase through
one ``fd_wing_beindex`` launch, whose int32 atomics are the paper's (no
``index_add_``; ``core.peel._wing_fd_beindex``).  The port of the JAX
package's ``core/beindex.py`` (a host loop): the same enumeration order
and bloom numbering, so every array is equal to the reference's.

Flat layout (all int32):
    bloom_k[nb]       initial bloom number (alive twin pairs)
    link_edge[L]      link -> edge id          (grouped by bloom)
    link_twin[L]      link -> twin edge id
    link_bloom[L]     link -> bloom id
Each twin *pair* contributes two links (e, t) and (t, e), adjacent:
pair j is links 2j and 2j + 1 (the FD pack reads it so).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import BipartiteGraph
from .peelspec import _t

__all__ = ["BEIndex", "build_beindex"]


@dataclasses.dataclass(frozen=True)
class BEIndex:
    """Flat Bloom-Edge-Index (§2.3): every (edge, twin) pair of every
    maximal priority bloom as parallel link arrays."""

    nb: int
    bloom_k: np.ndarray     # (nb,) int32 — #twin pairs per bloom
    link_edge: np.ndarray   # (L,) int32
    link_twin: np.ndarray   # (L,) int32
    link_bloom: np.ndarray  # (L,) int32

    @property
    def n_links(self) -> int:
        """Number of (edge, twin, bloom) links in the index."""
        return int(self.link_edge.shape[0])

    def total_butterflies(self) -> int:
        """⋈(G) = Σ_B C(k_B, 2) — every butterfly sits in one bloom."""
        k = self.bloom_k.astype(np.int64)
        return int((k * (k - 1) // 2).sum())

    def edge_support(self, m: int) -> np.ndarray:
        """⋈_e = Σ_{B∋e} (k_B − 1) — support init straight from the index."""
        out = np.zeros(m, dtype=np.int64)
        np.add.at(out, self.link_edge,
                  self.bloom_k[self.link_bloom].astype(np.int64) - 1)
        return out


def _priority_labels(g: BipartiteGraph) -> np.ndarray:
    """Combined-vertex labels: 0 = highest degree (highest priority)."""
    du, dv = g.degrees()
    deg = np.concatenate([du, dv])
    order = np.lexsort((np.arange(deg.size), -deg))
    labels = np.empty(deg.size, dtype=np.int64)
    labels[order] = np.arange(deg.size)
    return labels


def build_beindex(g: BipartiteGraph, device=None) -> BEIndex:
    """Enumerate maximal priority blooms from both vertex sides.

    For a same-side pair {a, b} with higher-priority member h, the bloom's
    non-dominant set is every common neighbour ``mid`` with
    label(mid) > label(h).  Blooms with k < 2 hold no butterflies and are
    dropped.  Cost: Σ_mid C(d_mid, 2) wedge slots, enumerated on
    ``device`` (default the CPU) by :func:`_wedge_slots` in the order
    (mid, i, j) of the reference's loop, then grouped by stable sorts:
    a bloom's wedges keep mid order, and blooms are numbered by their
    first-seen wedge, the loop's dict insertion order."""
    dev = torch.device("cpu" if device is None else device)
    key, e_lo, e_hi = _wedge_slots(*_wedge_inputs(g, dev))
    keep = key >= 0
    key, e_lo, e_hi = key[keep], e_lo[keep], e_hi[keep]
    # group equal keys; stable, so a group's first element is its
    # first-seen wedge and its wedges stay in enumeration (mid) order
    key, perm = torch.sort(key, stable=True)
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    group = torch.cumsum(head, 0) - 1
    start = torch.nonzero(head).flatten()
    size = torch.diff(start, append=start.new_tensor([key.numel()]))
    blooms = torch.nonzero(size >= 2).flatten()
    blooms = blooms[torch.argsort(perm[start[blooms]])]
    bid = torch.full_like(size, -1)
    bid[blooms] = torch.arange(blooms.numel(), device=dev)
    wedge_bid = bid[group]
    inb = wedge_bid >= 0
    wedge_bid, order = torch.sort(wedge_bid[inb], stable=True)
    wedge = perm[inb][order]
    lo, hi = e_lo[wedge], e_hi[wedge]
    # each wedge is a twin pair: links (e_lo, e_hi) and (e_hi, e_lo)
    return BEIndex(
        nb=int(blooms.numel()),
        bloom_k=_host(size[blooms]),
        link_edge=_host(torch.stack([lo, hi], 1).flatten()),
        link_twin=_host(torch.stack([hi, lo], 1).flatten()),
        link_bloom=_host(wedge_bid.repeat_interleave(2)),
    )


def _wedge_inputs(g: BipartiteGraph, dev: torch.device) -> tuple:
    """:func:`_wedge_slots`' inputs on ``dev``: the combined-id CSR
    (U vertex u -> u, V vertex v -> n_u + v; each row in edge-index
    order, by a stable sort), its row offsets and the int32 priority
    labels."""
    du, dv = g.degrees()
    deg = np.concatenate([du, dv])
    row_off = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_off[1:])
    e = _t(g.edges, dev).to(torch.int64)
    u, v = e[:, 0], e[:, 1] + g.n_u
    row = torch.sort(torch.cat([u, v]), stable=True).indices
    nbr = torch.cat([v, u])[row].to(torch.int32)
    eid = torch.arange(g.m, dtype=torch.int32, device=dev).repeat(2)[row]
    return (nbr, eid, _t(row_off, dev),
            _t(_priority_labels(g).astype(np.int32), dev))


def _wedge_slots(nbr, eid, row_off, label):
    """Every wedge slot of a combined-id CSR, in the order (mid, i, j),
    i < j, of the reference's loop.  ``nbr``/``eid`` (2m,) int32 and
    ``row_off`` (n + 1,) int64 are the CSR, ``label`` (n,) the priority
    labels.  Returns int64 keys min·n + max of the slot's two endpoints,
    −1 where label(mid) > min(label(a), label(b)) fails, and int32
    ``e_lo``/``e_hi``, the edge ids joining mid to the smaller / larger
    endpoint."""
    n = label.shape[0]
    dev = nbr.device
    pos = torch.arange(nbr.shape[0], device=dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   row_off[1:] - row_off[:-1])
    after = row_off[rows + 1] - pos - 1     # slots (i, j > i) of each i
    first = torch.repeat_interleave(pos, after)
    start = torch.cumsum(after, 0) - after
    second = (first + 1 + torch.arange(first.shape[0], device=dev)
              - start[first])
    mid = rows[first]
    a, b = nbr[first].to(torch.int64), nbr[second].to(torch.int64)
    keep = label[mid] > torch.minimum(label[a], label[b])
    key = torch.where(keep, torch.minimum(a, b) * n + torch.maximum(a, b), -1)
    lo_a = a < b
    ea, eb = eid[first], eid[second]
    return key, torch.where(lo_a, ea, eb), torch.where(lo_a, eb, ea)


def _host(x: torch.Tensor) -> np.ndarray:
    """An int32 host copy of a device tensor."""
    return x.to(torch.int32).cpu().numpy()

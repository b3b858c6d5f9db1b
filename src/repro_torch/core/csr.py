"""Sparse csr peeling engine — the wedge-list butterfly machinery.

Host side (numpy, copied from the JAX package's ``core/csr.py`` so the
two packages build the same arrays): the graph's V-side CSR is flattened
into a **wedge list** — every pair of edges sharing a V center — grouped
by U-endpoint *pair*.  A butterfly is two wedges of one pair, so every
count reduces to per-pair wedge counts W_p:

    pair butterflies       = C(W_p, 2)
    ⋈_u (vertex support)   = Σ_{p ∋ u} C(W_p, 2)
    ⋈_e (edge support)     = Σ_{wedges w ∋ e} (W_{p(w)} − 1)

Device side (torch): the incremental peeling updates — only butterflies
incident to peeled entities are recomputed (the BE-Index widow/survivor
algebra with pairs playing the role of blooms).  Every segment sum is an
int32 ``index_add_``, so θ stays exact; the slot variants route the
per-row reductions through the hand-written kernels
(``kernels.ops``), exact while counts stay below 2²⁴ (pack-time guards).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels import ops as kops
from .graph import BipartiteGraph

__all__ = [
    "Wedges",
    "PaddedCSR",
    "build_wedges",
    "pad_segments",
    "TileLayout",
    "TileStats",
    "iter_wedge_tiles",
    "tile_layout",
    "tile_slot_matrix",
    "tiled_butterfly_init",
    "pack_wedge_slots",
    "directed_pair_incidence",
    "pack_tip_slots",
    "pack_update_slots",
    "wedge_workload",
    "pair_wedge_counts",
    "vertex_butterflies_csr",
    "edge_butterflies0",
    "total_butterflies_csr",
    "tip_delta_csr",
    "tip_delta_slots",
    "wing_loss_csr",
    "wing_update_csr",
    "wing_loss_slots",
    "wing_update_slots",
]

_INT_LIMIT = 2 ** 31 - 1  # device counts are int32; guard exactness


# =====================================================================
# Host-side construction (numpy; array-equal to the JAX package)
# =====================================================================
@dataclasses.dataclass(frozen=True)
class Wedges:
    """Flattened wedge list of a bipartite graph (centers on the V side).

    A wedge is an ordered triple (u_a, v, u_b) with u_a < u_b; it is
    stored as its two edge ids plus the id of its U-endpoint *pair*.
    All arrays are host numpy; engines move them to device once.
    """

    n_u: int
    n_v: int
    m: int
    n_pairs: int
    pair_a: np.ndarray      # (n_pairs,) int32 — smaller U endpoint
    pair_b: np.ndarray      # (n_pairs,) int32 — larger U endpoint
    wedge_pair: np.ndarray  # (n_wedges,) int32 — pair id per wedge
    wedge_e1: np.ndarray    # (n_wedges,) int32 — edge (pair_a, center)
    wedge_e2: np.ndarray    # (n_wedges,) int32 — edge (pair_b, center)
    W0: np.ndarray          # (n_pairs,) int64 — static full-graph wedge count

    @property
    def n_wedges(self) -> int:
        """Number of enumerated wedges (= Σ_v C(d_v, 2))."""
        return int(self.wedge_pair.shape[0])

    def pair_butterflies0(self) -> np.ndarray:
        """Static C(W0, 2) per pair (V side never peeled ⇒ valid for tip)."""
        w = self.W0
        bf = w * (w - 1) // 2
        if bf.size and int(bf.max()) > _INT_LIMIT:
            raise OverflowError("pair butterfly counts exceed int32 range")
        return bf


def build_wedges(g: BipartiteGraph) -> Wedges:
    """Enumerate every wedge (V center, U endpoints) — vectorized numpy.

    Work and memory are O(Σ_v C(d_v, 2)); no n² anywhere.  Neighbor lists
    in ``csr_v`` are u-sorted, so pair endpoints come out ordered.
    """
    off, nbr, eid = g.csr_v()
    deg = np.diff(off)
    pos = np.arange(nbr.size, dtype=np.int64)
    center = np.repeat(np.arange(g.n_v, dtype=np.int64), deg)
    # position p pairs with every later position of the same center
    row_len = off[center + 1] - pos - 1 if nbr.size else np.zeros(0, np.int64)
    total = int(row_len.sum()) if nbr.size else 0
    if total == 0:
        empty32 = np.zeros(0, dtype=np.int32)
        return Wedges(
            n_u=g.n_u, n_v=g.n_v, m=g.m, n_pairs=0,
            pair_a=empty32, pair_b=empty32, wedge_pair=empty32,
            wedge_e1=empty32, wedge_e2=empty32,
            W0=np.zeros(0, dtype=np.int64),
        )
    e1_pos = np.repeat(pos, row_len)
    starts = np.cumsum(row_len) - row_len
    k = np.arange(total, dtype=np.int64) - np.repeat(starts, row_len)
    e2_pos = e1_pos + 1 + k
    a = nbr[e1_pos].astype(np.int64)
    b = nbr[e2_pos].astype(np.int64)
    key = a * g.n_u + b
    pair_key, wedge_pair = np.unique(key, return_inverse=True)
    if pair_key.size > _INT_LIMIT:
        raise OverflowError("pair count exceeds int32 range")
    return Wedges(
        n_u=g.n_u, n_v=g.n_v, m=g.m, n_pairs=int(pair_key.size),
        pair_a=(pair_key // g.n_u).astype(np.int32),
        pair_b=(pair_key % g.n_u).astype(np.int32),
        wedge_pair=wedge_pair.astype(np.int32),
        wedge_e1=eid[e1_pos].astype(np.int32),
        wedge_e2=eid[e2_pos].astype(np.int32),
        W0=np.bincount(wedge_pair, minlength=pair_key.size).astype(np.int64),
    )


def wedge_workload(g: BipartiteGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Paper's range-selection workload proxy Σ_{v∈N_u} d_v, per side.

    Dense engine computes this as A @ d_v; here it is two bincounts."""
    du, dv = g.degrees()
    if g.m == 0:
        return np.zeros(g.n_u, np.int64), np.zeros(g.n_v, np.int64)
    wu = np.bincount(g.edges[:, 0], weights=dv[g.edges[:, 1]], minlength=g.n_u)
    wv = np.bincount(g.edges[:, 1], weights=du[g.edges[:, 0]], minlength=g.n_v)
    return wu.astype(np.int64), wv.astype(np.int64)


# =====================================================================
# Bounded-tile wedge enumeration + ⋈init (the out-of-core counting path)
# =====================================================================
@dataclasses.dataclass
class TileStats:
    """What the tiled ⋈init did: tile, wedge and pair counts, the
    largest tile and the largest kernel slot matrix."""

    n_tiles: int = 0
    n_wedges: int = 0          # Σ over tiles (== untiled wedge count)
    n_pairs: int = 0           # Σ distinct pairs (tiles don't split pairs)
    peak_tile_wedges: int = 0  # largest single tile
    peak_slot_bytes: int = 0   # largest slot matrix, n_rows·width·4 (0 = host path)


def iter_wedge_tiles(source, tile_wedges: int = 1 << 20):
    """Yield wedge batches ``(a, b, e1, e2)`` of ≈ ``tile_wedges`` each
    (host numpy int64; a copy of the JAX package's generator).

    The full wedge list is O(Σ_v C(d_v, 2)); this never materializes it.
    Wedges are grouped by their **smaller U endpoint** ``a`` and a tile
    covers a contiguous U range chosen greedily from the exact
    per-vertex wedge counts, so every wedge of pair {a, b} lands in one
    tile and per-tile pair counts are globally complete.  A hub vertex
    whose own wedge count exceeds ``tile_wedges`` is a tile by itself.

    ``source`` is anything with ``n_u``/``n_v``/``m`` and ``csr_v()``
    (``BipartiteGraph`` or ``data.ingest.IngestedGraph``, whose CSR is
    memory-mapped, so the graph itself stays on disk).
    """
    off, nbr, eid = source.csr_v()
    n_u = source.n_u
    if nbr.size == 0:
        return
    deg = np.diff(off)
    pos = np.arange(nbr.size, dtype=np.int64)
    center = np.repeat(np.arange(source.n_v, dtype=np.int64), deg)
    tail = (off[center + 1] - pos - 1).astype(np.int64)
    # exact wedge count per minimum endpoint, and V-CSR positions
    # grouped by that endpoint (stable sort keeps center order)
    w_u = np.bincount(nbr, weights=tail, minlength=n_u).astype(np.int64)
    by_u = np.argsort(nbr, kind="stable")
    eoff = np.zeros(n_u + 1, dtype=np.int64)
    np.cumsum(np.bincount(nbr, minlength=n_u), out=eoff[1:])
    cw = np.cumsum(w_u)
    u0 = 0
    base = 0
    while u0 < n_u:
        u1 = int(np.searchsorted(cw, base + tile_wedges, side="right"))
        u1 = min(max(u1, u0 + 1), n_u)
        base = int(cw[u1 - 1])
        P = by_u[eoff[u0]:eoff[u1]]
        u0 = u1
        t = tail[P]
        total = int(t.sum())
        if total == 0:
            continue
        e1_pos = np.repeat(P, t)
        starts = np.cumsum(t) - t
        k = np.arange(total, dtype=np.int64) - np.repeat(starts, t)
        e2_pos = e1_pos + 1 + k
        yield (
            nbr[e1_pos].astype(np.int64),
            nbr[e2_pos].astype(np.int64),
            eid[e1_pos].astype(np.int64),
            eid[e2_pos].astype(np.int64),
        )


def tiled_butterfly_init(
    source,
    tile_wedges: int = 1 << 20,
    use_pallas: bool = False,
    width: int = 512,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, int, TileStats]:
    """⋈init under bounded memory: (sup_e, sup_u, total, stats).

    Streams :func:`iter_wedge_tiles` and reduces each tile to per-pair
    wedge counts W; a pair's wedges never straddle tiles, so the int64
    outputs are bit-identical to :func:`edge_butterflies0` /
    :func:`vertex_butterflies_csr` / :func:`total_butterflies_csr`.

    Without ``use_pallas`` this is the JAX package's host path (numpy).
    With it (the JAX package's name for the kernel route) each tile runs
    in torch on ``device``: the wedge keys are sorted there, the slot
    matrix — one ``width``-wide int32 row per pair segment, a hub pair
    spanning several rows — is allocated at its ``_row_bucket`` size and
    filled by a scatter of ones (the pair key and two edge ids, 24
    bytes per wedge, cross to the card, never the mostly-zero matrix),
    ``wedge_count_tile`` sums the rows
    exactly in int32, and the per-pair totals and the four support
    scatters are int64 ``index_add_`` — no 2²⁴ ceiling anywhere.  Only
    the three results come back to the host.

    Either route ends with one ``counting.tiles`` counter sample of the
    :class:`TileStats` when the obs layer is on.
    """
    n_u, m = source.n_u, source.m
    stats = TileStats()
    tiles = iter_wedge_tiles(source, tile_wedges)
    if use_pallas:
        from .peel import resolve_device

        out = _tiled_init_device(tiles, n_u, m, width,
                                 resolve_device(device), stats)
    else:
        out = _tiled_init_host(tiles, n_u, m, stats)
    obs.counter("counting.tiles", dict(
        tiles=stats.n_tiles, wedges=stats.n_wedges, pairs=stats.n_pairs,
        peak_tile_wedges=stats.peak_tile_wedges,
        peak_slot_bytes=stats.peak_slot_bytes))
    return out


def _tiled_init_host(tiles, n_u, m, stats):
    """The host route of :func:`tiled_butterfly_init` (numpy)."""
    sup_e = np.zeros(m, dtype=np.int64)
    sup_u = np.zeros(n_u, dtype=np.int64)
    total = 0
    for a, b, e1, e2 in tiles:
        nk = a.size
        key = a * n_u + b
        order = np.argsort(key, kind="stable")
        ks = key[order]
        newp = np.empty(nk, dtype=bool)
        newp[0] = True
        np.not_equal(ks[1:], ks[:-1], out=newp[1:])
        starts_p = np.flatnonzero(newp)
        pid = np.cumsum(newp) - 1
        W = np.diff(np.append(starts_p, nk)).astype(np.int64)
        bf = W * (W - 1) // 2
        np.add.at(sup_u, ks[starts_p] // n_u, bf)
        np.add.at(sup_u, ks[starts_p] % n_u, bf)
        total += int(bf.sum())
        contrib = W[pid] - 1
        np.add.at(sup_e, e1[order], contrib)
        np.add.at(sup_e, e2[order], contrib)
        _tile_done(stats, nk, starts_p.size)
    return sup_e, sup_u, total, stats


def _tile_done(stats: TileStats, n_wedges: int, n_pairs: int) -> None:
    stats.n_tiles += 1
    stats.n_wedges += n_wedges
    stats.n_pairs += n_pairs
    stats.peak_tile_wedges = max(stats.peak_tile_wedges, n_wedges)


class TileLayout(NamedTuple):
    """One tile's wedges sorted by pair on the device, and the slot of
    each wedge in the tile's slot matrix (see :func:`tile_layout`)."""

    keys: torch.Tensor           # (nk,) int64 pair key a·n_u + b, sorted
    order: torch.Tensor          # (nk,) int64 the stable sort permutation
    pair_start: torch.Tensor     # (n_pairs,) int64 first sorted wedge of each pair
    pair_of: torch.Tensor        # (nk,) int64 pair index of each sorted wedge
    rows_per_pair: torch.Tensor  # (n_pairs,) int64 ceil(W / width)
    flat: torch.Tensor           # (nk,) int64 slot of each wedge, row·wpad + col
    n_rows: int                  # slot rows in use
    wpad: int                    # row stride: width rounded up to 128


def tile_layout(a: np.ndarray, b: np.ndarray, n_u: int, width: int,
                device) -> TileLayout:
    """Sort one tile's wedges (``iter_wedge_tiles``) by pair key on
    ``device`` and lay each pair's wedges out as ``width``-wide slot
    rows (a hub pair spans several rows)."""
    dev = torch.device(device)
    i64 = torch.int64
    nk = a.size
    ks, order = torch.sort(torch.from_numpy(a * n_u + b).to(dev), stable=True)
    newp = torch.ones(nk, dtype=torch.bool, device=dev)
    torch.ne(ks[1:], ks[:-1], out=newp[1:])
    starts_p = newp.nonzero().squeeze(1)
    pid = torch.cumsum(newp, 0) - 1
    cnt = torch.diff(starts_p, append=starts_p.new_tensor([nk]))
    within = torch.arange(nk, dtype=i64, device=dev) - starts_p[pid]
    rows_per_pair = (cnt + (width - 1)) // width
    row_base = torch.cumsum(rows_per_pair, 0) - rows_per_pair
    wpad = -(-width // 128) * 128   # the kernel wrapper's column multiple
    flat = (row_base[pid] + within // width) * wpad + within % width
    return TileLayout(ks, order, starts_p, pid, rows_per_pair, flat,
                      int(rows_per_pair.sum()), wpad)


def tile_slot_matrix(lay: TileLayout) -> torch.Tensor:
    """The tile's int32 0/1 slot matrix, built where the layout lies:
    ``_row_bucket(n_rows, 8)`` rows of ``wpad`` slots, zeros, then a
    scatter of ones at each wedge's slot."""
    slots = torch.zeros((kops._row_bucket(lay.n_rows, 8), lay.wpad),
                        dtype=torch.int32, device=lay.flat.device)
    slots.view(-1)[lay.flat] = 1
    return slots


def _tiled_init_device(tiles, n_u, m, width, dev, stats):
    """The kernel route of :func:`tiled_butterfly_init`, one tile at a
    time on ``dev`` (int64 throughout except the int32 row partials)."""
    i64 = torch.int64
    sup_e = torch.zeros(m, dtype=i64, device=dev)
    sup_u = torch.zeros(n_u, dtype=i64, device=dev)
    total = torch.zeros((), dtype=i64, device=dev)
    for a, b, e1, e2 in tiles:
        lay = tile_layout(a, b, n_u, width, dev)
        stats.peak_slot_bytes = max(stats.peak_slot_bytes,
                                    lay.n_rows * width * 4)
        row_sums = kops.tile_row_counts(tile_slot_matrix(lay), lay.n_rows)
        n_pairs_t = lay.pair_start.numel()
        row_to_pair = torch.repeat_interleave(
            torch.arange(n_pairs_t, dtype=i64, device=dev), lay.rows_per_pair)
        W = torch.zeros(n_pairs_t, dtype=i64, device=dev).index_add_(
            0, row_to_pair, row_sums.to(i64))
        bf = W * (W - 1) // 2
        pk = lay.keys[lay.pair_start]
        sup_u.index_add_(0, pk // n_u, bf)
        sup_u.index_add_(0, pk % n_u, bf)
        total += bf.sum()
        contrib = W[lay.pair_of] - 1
        sup_e.index_add_(0, torch.from_numpy(e1).to(dev)[lay.order], contrib)
        sup_e.index_add_(0, torch.from_numpy(e2).to(dev)[lay.order], contrib)
        _tile_done(stats, a.size, n_pairs_t)
    return (sup_e.cpu().numpy(), sup_u.cpu().numpy(), int(total.item()),
            stats)


# =====================================================================
# Padded-CSR device representation (pairs-major slots for the kernel)
# =====================================================================
@dataclasses.dataclass(frozen=True)
class PaddedCSR:
    """Row-padded CSR block: row r holds segment r's items, −1 padded.

    The device-friendly face of a ragged grouping — the row count padded
    to a multiple of 8, the width to a multiple of 128 (the JAX
    package's tiling, kept so both packages build the same arrays).
    """

    n_rows: int             # real segment count
    n_rows_pad: int         # rows after padding to row_mult
    width: int              # slots per row (a lane_mult multiple)
    idx: np.ndarray         # (n_rows_pad, width) int32, −1 = padding
    valid: np.ndarray       # (n_rows_pad, width) bool


def pad_segments(
    seg_ids: np.ndarray,
    n_rows: int,
    row_mult: int = 8,
    lane_mult: int = 128,
) -> PaddedCSR:
    """Pack item → segment assignments into a :class:`PaddedCSR`.

    ``idx[r, c]`` is the original item index of segment r's c-th member.
    """
    counts = np.bincount(seg_ids, minlength=max(n_rows, 1))
    width = max(int(counts.max()) if counts.size else 1, 1)
    width = -(-width // lane_mult) * lane_mult
    n_rows_pad = -(-max(n_rows, 1) // row_mult) * row_mult
    idx = np.full((n_rows_pad, width), -1, dtype=np.int32)
    valid = np.zeros((n_rows_pad, width), dtype=bool)
    if seg_ids.size:
        order = np.argsort(seg_ids, kind="stable")
        sorted_ids = seg_ids[order]
        off = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts[:n_rows], out=off[1:])
        col = np.arange(seg_ids.size, dtype=np.int64) - off[sorted_ids]
        idx[sorted_ids, col] = order.astype(np.int32)
        valid[sorted_ids, col] = True
    return PaddedCSR(
        n_rows=n_rows, n_rows_pad=n_rows_pad, width=width, idx=idx, valid=valid
    )


def pack_wedge_slots(w: Wedges) -> PaddedCSR:
    """Pairs-major wedge slots: row p lists pair p's wedge indices."""
    return pad_segments(w.wedge_pair, w.n_pairs)


def directed_pair_incidence(
    w: Wedges, pair_bf0: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed pair-incidence triple ``(dst, src, bf)`` — each pair
    {a, b} as two entries (dst=a, src=b) and (dst=b, src=a) carrying
    the static butterfly count.  THE tip-CD layout convention, shared
    by the vertex-major kernel slots (:func:`pack_tip_slots`) and the
    distributed CD shards (``distributed.shard_tip_pairs``): vertex
    dst loses bf when src peels."""
    dst = np.concatenate([w.pair_a, w.pair_b]).astype(np.int64)
    src = np.concatenate([w.pair_b, w.pair_a]).astype(np.int64)
    val = np.concatenate([pair_bf0, pair_bf0]).astype(np.int32)
    return dst, src, val


def pack_tip_slots(
    w: Wedges, pair_bf0: np.ndarray, sup: Optional[np.ndarray] = None
) -> dict:
    """Vertex-major pair slots for the tip CD kernel route.

    Row u lists vertex u's incident pairs as directed entries: each pair
    {a, b} appears twice — once in row a with partner b, once in row b
    with partner a — so a peel round's delta for u is the row sum of
    pair butterflies whose partner was peeled (``kernels.ops
    .tip_slot_loss``; rows ARE vertices, so no scatter back).  ``bf`` is
    0 on padding slots (algebra-neutral), ``partner`` the sentinel n.

    Per-row sums are bounded by the vertex's ⋈ support; past 2²⁴ those
    stop being exact f32 integers, so refuse up front like
    :func:`pack_update_slots` (supports only decrease — checking ⋈init
    once is sufficient).  Pass the caller's precomputed ⋈init as
    ``sup`` to skip recomputing it for the guard."""
    n = w.n_u
    if sup is None:
        sup = vertex_butterflies_csr(w)
    if sup.size and int(sup.max()) >= 2 ** 24:
        raise OverflowError(
            "tip supports exceed f32 integer range (2^24); "
            "use the segment_sum path (use_pallas=False)"
        )
    dst, src, val = directed_pair_incidence(w, pair_bf0)
    packed = pad_segments(dst, n)
    partner = np.full(packed.idx.shape, n, dtype=np.int32)
    bf = np.zeros(packed.idx.shape, dtype=np.int32)
    if dst.size:
        idx = np.maximum(packed.idx, 0)
        partner = np.where(packed.valid, src[idx], n).astype(np.int32)
        bf = np.where(packed.valid, val[idx], 0).astype(np.int32)
    return dict(partner=partner, bf=bf, n=n)


def pack_update_slots(w: Wedges) -> dict:
    """Slot-layout companion arrays for the support-update kernel.

    ``e1``/``e2`` map each slot to its wedge's two edge ids (sentinel m
    on padding slots, so peeled-flag gathers and loss scatters are safe
    without masking); ``valid`` marks real slots — the engine's initial
    alive matrix."""
    # the kernel carries W_p, W_p-1 and c_p as f32; past 2^24 those stop
    # being exact integers and rint() re-integerization silently corrupts
    # supports — refuse up front like every other exactness boundary
    # (W only decreases, so checking the static W0 once is sufficient)
    if w.W0.size and int(w.W0.max()) >= 2 ** 24:
        raise OverflowError(
            "pair wedge counts exceed f32 integer range (2^24); "
            "use the segment_sum path (use_pallas=False)"
        )
    packed = pack_wedge_slots(w)
    if w.n_wedges:
        idx = np.maximum(packed.idx, 0)
        e1 = np.where(packed.valid, w.wedge_e1[idx], w.m).astype(np.int32)
        e2 = np.where(packed.valid, w.wedge_e2[idx], w.m).astype(np.int32)
    else:
        e1 = np.full(packed.idx.shape, w.m, np.int32)
        e2 = e1.copy()
    return dict(
        e1=e1, e2=e2, valid=packed.valid,
        n_pairs=w.n_pairs, n_rows_pad=packed.n_rows_pad, m=w.m,
    )


def vertex_butterflies_csr(w: Wedges, side: str = "u") -> np.ndarray:
    """⋈ per U vertex (tip support init) — exact int64, host output."""
    assert side == "u", "transpose the graph for the V side"
    bf = w.pair_butterflies0()
    out = np.zeros(w.n_u, dtype=np.int64)
    if w.n_pairs:
        np.add.at(out, w.pair_a, bf)
        np.add.at(out, w.pair_b, bf)
    return out


def edge_butterflies0(w: Wedges) -> np.ndarray:
    """Full-graph ⋈_e — exact int64, host numpy (wing support init).

    Supports only ever decrease during peeling, so engines that verify
    this fits int32 once at init stay exact all the way down."""
    out = np.zeros(w.m, dtype=np.int64)
    if w.n_wedges:
        contrib = w.W0[w.wedge_pair] - 1
        np.add.at(out, w.wedge_e1, contrib)
        np.add.at(out, w.wedge_e2, contrib)
    return out


def total_butterflies_csr(w: Wedges) -> int:
    """⋈(G) = Σ_p C(W_p, 2) — exact int64 on host."""
    return int(w.pair_butterflies0().sum())


# =====================================================================
# Device-side counting and incremental updates (torch)
# =====================================================================
def _seg(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of ``x`` by ``ids`` into ``max(n, 1)`` slots, in the
    dtype of ``x`` (int32 throughout the engine)."""
    out = torch.zeros(max(n, 1), dtype=x.dtype, device=x.device)
    return out.index_add_(0, ids, x)


def pair_wedge_counts(
    w: Wedges,
    alive_e: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Alive wedge count W_p per pair (int32, ``max(n_pairs, 1)``), on
    ``alive_e``'s device if given, else on ``device`` (refused where it
    names a card that is missing).

    ``use_pallas`` (the JAX package's name for the kernel route) runs the
    per-pair reduction through the ``wedge_count`` kernel over the
    pairs-major slot matrix instead of a segment sum."""
    if alive_e is not None:
        device = alive_e.device
    else:
        from .peel import resolve_device
        device = resolve_device(device)
    wp = torch.from_numpy(w.wedge_pair).to(device)
    if alive_e is None:
        alive_w = torch.ones((w.n_wedges,), dtype=torch.bool, device=device)
    else:
        alive_w = (alive_e[torch.from_numpy(w.wedge_e1).to(device)]
                   & alive_e[torch.from_numpy(w.wedge_e2).to(device)])
    if not use_pallas:
        return _seg(alive_w.to(torch.int32), wp, w.n_pairs)
    packed = pack_wedge_slots(w)
    idx = torch.from_numpy(np.maximum(packed.idx, 0)).to(device)
    valid = torch.from_numpy(packed.valid).to(device)
    slots = valid & alive_w[idx] if w.n_wedges else valid
    W, _ = kops.pair_wedge_counts(slots)
    return torch.round(W[: max(w.n_pairs, 1)]).to(torch.int32)


def tip_delta_csr(
    peeled_u: torch.Tensor,   # (n,) bool — U vertices peeled this round
    pair_a: torch.Tensor,
    pair_b: torch.Tensor,
    pair_bf: torch.Tensor,    # (n_pairs,) int32 — static C(W0, 2)
    n: int,
) -> torch.Tensor:
    """Δ⋈_u' = Σ_{u peeled} butterflies shared by pair (u', u).

    Pair butterfly counts are static because V is never peeled, so the
    update is O(n_pairs)."""
    loss_a = torch.where(peeled_u[pair_b], pair_bf, 0)
    loss_b = torch.where(peeled_u[pair_a], pair_bf, 0)
    return _seg(loss_a, pair_a, n) + _seg(loss_b, pair_b, n)


def tip_delta_slots(
    peeled_u: torch.Tensor,       # (n,) bool — U vertices peeled this round
    slot_partner: torch.Tensor,   # (n_rows_pad, K) int32, sentinel n
    slot_bf: torch.Tensor,        # (n_rows_pad, K) int32, 0 on padding
    n: int,
) -> torch.Tensor:
    """:func:`tip_delta_csr` through the ``wedge_count`` kernel: the
    per-vertex reduction runs as row sums over the vertex-major slot
    layout (:func:`pack_tip_slots`).  Exact while supports < 2²⁴
    (guarded at pack time)."""
    pe = torch.cat([peeled_u, peeled_u.new_zeros((1,))])
    vals = torch.where(pe[slot_partner], slot_bf, 0)
    loss = kops.tip_slot_loss(vals)
    return torch.round(loss[:n]).to(torch.int32)


def wing_loss_csr(
    peeled_e: torch.Tensor,   # (m,) bool — edges peeled this round
    alive_w: torch.Tensor,    # (n_wedges,) bool
    W: torch.Tensor,          # (n_pairs,) int32 — alive wedge count per pair
    we1: torch.Tensor,
    we2: torch.Tensor,
    wp: torch.Tensor,
    n_pairs: int,
    m: int,
):
    """Per-edge butterfly loss of one peel round (BE-Index algebra on
    pairs).  A wedge dies when either of its edges is peeled; a surviving
    edge of a dying wedge loses W_old − 1 (widow), an edge of a surviving
    wedge loses c_p, the pair's dying wedges (survivor).

    Returns (alive_w', W', loss, n_updates)."""
    pe1 = peeled_e[we1]
    pe2 = peeled_e[we2]
    w_dies = alive_w & (pe1 | pe2)
    c = _seg(w_dies.to(torch.int32), wp, n_pairs)
    surv = alive_w & ~w_dies
    cw = c[wp]
    surv_loss = torch.where(surv, cw, 0)
    wm1 = W[wp] - 1
    loss = (
        _seg(torch.where(w_dies & ~pe1, wm1, 0) + surv_loss, we1, m)
        + _seg(torch.where(w_dies & ~pe2, wm1, 0) + surv_loss, we2, m)
    )
    n_updates = ((w_dies & (~pe1 | ~pe2)).sum()
                 + (surv & (cw > 0)).sum()).to(torch.int32)
    return alive_w & ~w_dies, W - c, loss, n_updates


def wing_loss_slots(
    peeled_e: torch.Tensor,       # (m,) bool — edges peeled this round
    alive_slots: torch.Tensor,    # (rows, K) bool — slot-layout alive
    W_rows: torch.Tensor,         # (rows,) int32 — alive wedges per row
    slot_e1: torch.Tensor,        # (rows, K) int32, sentinel m
    slot_e2: torch.Tensor,
    m: int,
):
    """:func:`wing_loss_csr` through the ``support_update`` kernel: the
    per-row reduction and per-slot losses run over a pairs-major slot
    layout, only the scatter onto edges stays an ``index_add_``.  Rows
    are the pairs of one graph (CD) or the flattened partition × pair
    stack of the unfused batched FD.  Exact while W < 2²⁴ (guarded at
    pack time).

    Returns (alive_slots', c_row (rows,) int32, loss (m,), n_updates)."""
    pe_pad = torch.cat([peeled_e, peeled_e.new_zeros((1,))])
    pe1 = pe_pad[slot_e1]
    pe2 = pe_pad[slot_e2]
    c1, c2, c_row = kops.support_update(pe1, pe2, alive_slots, W_rows)
    c1 = torch.round(c1).to(torch.int32)
    c2 = torch.round(c2).to(torch.int32)
    c_row = torch.round(c_row).to(torch.int32)
    loss = (_seg(c1.reshape(-1), slot_e1.reshape(-1), m + 1)[:m]
            + _seg(c2.reshape(-1), slot_e2.reshape(-1), m + 1)[:m])
    dies = alive_slots & (pe1 | pe2)
    surv = alive_slots & ~dies
    n_updates = ((dies & (~pe1 | ~pe2)).sum()
                 + (surv & (c_row[:, None] > 0)).sum()).to(torch.int32)
    return alive_slots & ~dies, c_row, loss, n_updates


def wing_update_slots(
    peeled_e: torch.Tensor,       # (m,) bool — edges peeled this round
    alive_slots: torch.Tensor,    # (n_rows_pad, K) bool — slot-layout alive
    W: torch.Tensor,              # (n_pairs,) int32 — alive wedges per pair
    support: torch.Tensor,        # (m,) int32
    slot_e1: torch.Tensor,        # (n_rows_pad, K) int32, sentinel m
    slot_e2: torch.Tensor,
    n_pairs: int,
    m: int,
):
    """:func:`wing_update_csr` through the ``support_update`` kernel over
    the graph's pairs-major slot matrix (:func:`pack_update_slots`).

    Returns (alive_slots', W', support', n_updates)."""
    W_rows = torch.zeros((alive_slots.shape[0],), dtype=torch.int32,
                         device=W.device)
    W_rows[:n_pairs] = W[:n_pairs]
    alive_slots, c_row, loss, n_updates = wing_loss_slots(
        peeled_e, alive_slots, W_rows, slot_e1, slot_e2, m)
    return alive_slots, W - c_row[:n_pairs], support - loss, n_updates


def wing_update_csr(
    peeled_e: torch.Tensor,
    alive_w: torch.Tensor,
    W: torch.Tensor,
    support: torch.Tensor,
    we1: torch.Tensor,
    we2: torch.Tensor,
    wp: torch.Tensor,
    n_pairs: int,
    m: int,
):
    """One batched incremental support update (see :func:`wing_loss_csr`).
    Returns (alive_w', W', support', n_updates)."""
    alive_w, W, loss, n_updates = wing_loss_csr(
        peeled_e, alive_w, W, we1, we2, wp, n_pairs, m)
    return alive_w, W, support - loss, n_updates

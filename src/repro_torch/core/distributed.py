"""Distributed PBNG on ``torch.distributed`` (the port of the JAX
package's ``core/distributed.py``).

Maps the paper's two phases onto the ranks of a ``DeviceMesh``
(``launch/mesh.py``): where the JAX package ``shard_map``-s over
``P(axis)``, rank r holds block r of the padded leading axis, and a
``psum`` is an int32 ``all_reduce`` over the mesh dimension's group.

* **CD** (coarse): the peeling structure (BE-Index *links* for the
  beindex engine, the flat *wedge list* / *pair list* for the csr tip
  and wing engines) is split into blocks over the ranks; each round
  every rank computes its partial dying counts and per-entity losses
  with int32 ``index_add_`` and :func:`_all_reduce_staged` combines
  them: two reductions a round for the link / wedge layouts, one for
  the aligned layouts and for tip.  Supports are replicated, and every
  rank runs the same host ``cd_loop`` on them.
* **FD** (fine): partitions are stacked, padded to a multiple of the
  world size, and rank r peels its contiguous block in one batched loop
  (``peelspec._fd_while_vmapped``) with the segment-sum update of the
  JAX package's bodies — **no collective at all**.  One ``all_gather``
  after it brings every rank the whole θ and the round counts.

Every collective goes through :func:`_all_reduce_staged` or
:func:`_all_gather`, which count it under the phase it runs in (``cd``,
``fd`` or ``result``, :func:`collective_counts`): the port's
counterpart of the JAX package's HLO collective counts.  The dense
tip CD is the one that gathers: the row blocks A and the alive flags,
as the JAX package's program does, and the recounted rows, which JAX's
single controller reads from the devices without a collective.

Every rank builds the graph, the wedge list and the layouts itself from
the same numpy; nothing is scattered.  Every padded slot names a
sentinel row (edge m, pair n_pairs / Pmax, bloom nb / Bmax, vertex n)
that exists in the arrays it indexes: the JAX package's gathers clamp
out-of-range ids, where the card would fault.

The csr FD partition packers (numpy) live in ``core.fdpack``, shared
with the single-device engines; the beindex packer, which only this
module uses, lives here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from functools import wraps
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import counting, csr, fdpack
from .beindex import BEIndex, build_beindex
from .graph import BipartiteGraph
from .peel import _fd_tip_vmapped, _fd_wing_vmapped, _tip_fd_vmapped_csr
from .peelspec import (
    FixedTarget,
    PeelResult,
    PeelSpec,
    PeelStats,
    _fd_while_vmapped,
    _host,
    _t,
    cd_loop,
)
from .. import obs
from ..device import resolve_device
from ..kernels.ref import matmul_f32

__all__ = [
    "ShardedWingState",
    "ShardedCSRState",
    "collective_counts",
    "reset_collective_counts",
    "shard_links",
    "shard_links_bloom_aligned",
    "shard_wedges",
    "shard_wedges_pair_aligned",
    "shard_tip_pairs",
    "make_cd_round",
    "make_cd_round_bloom",
    "make_cd_round_csr",
    "make_cd_round_csr_pair_aligned",
    "make_cd_round_tip_csr",
    "make_tip_cd_recount",
    "cd_round_sharded",
    "cd_round_sharded_csr",
    "pack_fd_partitions",
    "fd_peel_sharded",
    "fd_peel_sharded_csr",
    "fd_peel_sharded_tip_csr",
    "distributed_wing_decomposition",
    "distributed_tip_decomposition",
]

_I32 = torch.int32


# =====================================================================
# Collectives — the only two ways this module talks to other ranks
# =====================================================================
_COUNTS = {"cd": 0, "fd": 0, "result": 0}
_PHASE = ["cd"]


def collective_counts() -> dict:
    """Collectives issued by this module in this process, by phase
    (``cd``, ``fd``, ``result``); a staged reduction counts once per
    stage."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    """Set every phase's collective count to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0


@contextlib.contextmanager
def _phase(name: str):
    """Count the collectives issued inside the block under ``name``."""
    prev, _PHASE[0] = _PHASE[0], name
    try:
        yield
    finally:
        _PHASE[0] = prev


def _dims(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _all_reduce_staged(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """One logical psum, in place: an int32 sum over ``axis``'s ranks.

    ``axis`` is a mesh dimension name (one ``all_reduce`` over its
    group) or a tuple of names, e.g. ``("grp", "loc")`` on a 2-D mesh
    (``launch.mesh.make_peel_mesh_2d``), reduced innermost first: within
    each group of co-located ranks, then across groups — the JAX
    package's ``reversed(axis)``.  Every CD reduction is an int32 sum,
    so every grouping is exact and the staged result is bit-identical
    to the flat one."""
    for a in reversed(_dims(axis)):
        dist.all_reduce(x, group=mesh.get_group(a))
        _COUNTS[_PHASE[0]] += 1
    return x


def _all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in mesh order (one
    list-form ``all_gather``, which gloo and NCCL both take)."""
    out = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(out, x.contiguous())
    _COUNTS[_PHASE[0]] += 1
    return torch.cat(out)


def _position(mesh, axis) -> Tuple[int, int]:
    """(this rank's block index, number of blocks) for ``P(axis)``.

    ``axis`` must name every mesh dimension in the mesh's order, and the
    mesh must hold the ranks 0..world-1 in row-major order (what
    ``launch.mesh`` builds), so block index = global rank."""
    names = tuple(mesh.mesh_dim_names or ())
    if _dims(axis) != names:
        raise ValueError(
            f"axis={axis!r} must name every mesh dimension in order "
            f"{names!r}")
    n_dev = mesh.size()
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the mesh must hold ranks 0..world-1 in order")
    return dist.get_rank(), n_dev


def _rank_device(mesh, device) -> torch.device:
    """This rank's device: ``device`` if given, else the mesh's device
    type on card ``LOCAL_RANK % device_count`` (refused where there is
    no card)."""
    if device is not None:
        return resolve_device(device)
    if mesh.device_type != "cuda":
        return resolve_device(mesh.device_type)
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def _block(x: np.ndarray, idx: int, n_dev: int) -> np.ndarray:
    """Block ``idx`` of ``n_dev`` contiguous blocks of x's leading axis
    (its length a multiple of n_dev) — what ``P(axis)`` hands a device."""
    b = x.shape[0] // n_dev
    return x[idx * b:(idx + 1) * b]


def _pad1(x: torch.Tensor) -> torch.Tensor:
    """x with one zero appended: the sentinel row a padded slot reads."""
    return torch.cat([x, x.new_zeros((1,))])


# =====================================================================
# CD — link-sharded rounds
# =====================================================================
@dataclasses.dataclass
class ShardedWingState:
    """Link-sharded CD state of one rank: its block of the link arrays,
    supports / bloom numbers replicated (O(m) + O(nb), tiny next to the
    links)."""

    le: torch.Tensor          # (L_pad / n_dev,) link -> edge (sentinel m)
    lt: torch.Tensor          # link -> twin
    lb: torch.Tensor          # link -> bloom (sentinel nb)
    alive_link: torch.Tensor  # this rank's block
    k_alive: torch.Tensor     # (nb,) replicated
    support: torch.Tensor     # (m,) replicated
    nb: int
    m: int


def shard_links(be: BEIndex, m: int, n_dev: int, rank: int,
                device) -> ShardedWingState:
    """Pad the link arrays to a multiple of n_dev and keep block
    ``rank``.  Pad links point at a sentinel dead bloom/edge and start
    dead."""
    L = be.n_links
    pad = (-L) % max(n_dev, 1)

    def padded(x, fill):
        full = np.concatenate([x, np.full(pad, fill, dtype=x.dtype)])
        return _t(_block(full, rank, n_dev), device)

    alive = np.concatenate([np.ones(L, bool), np.zeros(pad, bool)])
    return ShardedWingState(
        le=padded(be.link_edge, m), lt=padded(be.link_twin, m),
        lb=padded(be.link_bloom, be.nb),
        alive_link=_t(_block(alive, rank, n_dev), device),
        k_alive=_t(be.bloom_k.astype(np.int32), device),
        support=_t(be.edge_support(m).astype(np.int32), device),
        nb=be.nb, m=m,
    )


def make_cd_round(mesh, axis, nb: int, m: int):
    """The link-sharded CD round: ``round_fn(peeled_pad, alive_link,
    k_alive, support_pad, le, lt, lb) -> (alive_link, k_alive,
    support_pad)`` on this rank's link block, two reductions (the dying
    counts c, then the losses)."""
    def round_fn(peeled_pad, alive_link, k_alive, support_pad, le, lt, lb):
        pe = peeled_pad[le]
        pt = peeled_pad[lt]
        pair_dies = alive_link & (pe | pt)
        canon = le < lt
        c = _all_reduce_staged(
            csr._seg((pair_dies & canon).to(_I32), lb, nb + 1), mesh, axis)
        widow = alive_link & ~pe & pt
        surv = alive_link & ~pair_dies
        contrib = (torch.where(widow, _pad1(k_alive)[lb] - 1, 0)
                   + torch.where(surv, c[lb], 0))
        loss = _all_reduce_staged(csr._seg(contrib, le, m + 1), mesh, axis)
        return alive_link & ~pair_dies, k_alive - c[:nb], support_pad - loss

    return round_fn


def cd_round_sharded(round_fn, st: ShardedWingState, peeled: torch.Tensor
                     ) -> ShardedWingState:
    """One CD peeling round. ``peeled`` is the (m,) frontier mask."""
    alive_link, k_alive, support_pad = round_fn(
        _pad1(peeled), st.alive_link, st.k_alive, _pad1(st.support),
        st.le, st.lt, st.lb)
    return dataclasses.replace(
        st, alive_link=alive_link, k_alive=k_alive, support=support_pad[:-1])


# =====================================================================
# Aligned ("segment-on-one-shard") layouts — shared scaffolding
# =====================================================================
# Baseline CD pays TWO reductions per round when its grouping segments
# (blooms for beindex, U-pairs for csr wing) straddle shards: one for
# the dying counts, one for the losses.  If every segment's items live
# on ONE shard the count state is shard-local and a round costs a
# single reduction.  The greedy-balance placement and the scatter into
# [n_dev, Lmax] blocks are identical for every such layout (bloom-,
# pair- and vertex-aligned); only the per-item arrays differ.
def _greedy_balance(counts: np.ndarray, n_dev: int):
    """LPT-greedy segment→shard placement shared by the aligned
    one-reduction CD layouts.

    Segments (blooms / U-pairs / vertices) are placed largest-first onto
    the least-loaded shard (heap, O(S log n_dev) — ties break to the
    lowest shard id).  Everything else is vectorized numpy: per shard,
    segments keep ascending-id order.  Returns ``(shard_of, local_id,
    seg_start, loads, n_local)`` — per segment its shard, shard-local id
    and first item column; per shard its item load and segment count."""
    import heapq

    S = int(counts.size)
    if S == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, np.zeros(n_dev, np.int64), np.zeros(n_dev, np.int64)
    shard_of = np.zeros(S, dtype=np.int64)
    heap = [(0, s) for s in range(max(n_dev, 1))]
    heapq.heapify(heap)
    for sid in np.argsort(-counts, kind="stable"):
        load, s = heapq.heappop(heap)
        shard_of[sid] = s
        heapq.heappush(heap, (load + int(counts[sid]), s))
    order = np.argsort(shard_of, kind="stable")   # group by shard, id-sorted
    grouped = shard_of[order]
    starts = np.flatnonzero(np.r_[True, np.diff(grouped) > 0])
    sizes = np.diff(np.r_[starts, S])
    rank = np.arange(S, dtype=np.int64) - np.repeat(starts, sizes)
    local_id = np.empty(S, dtype=np.int64)
    local_id[order] = rank
    cs = np.cumsum(counts[order]) - counts[order]  # items before, global
    seg_start = np.empty(S, dtype=np.int64)
    seg_start[order] = cs - np.repeat(cs[starts], sizes)
    loads = np.bincount(
        shard_of, weights=counts.astype(np.float64), minlength=n_dev
    ).astype(np.int64)
    n_local = np.bincount(shard_of, minlength=n_dev)
    return shard_of, local_id, seg_start, loads, n_local


def _aligned_layout(seg_ids: np.ndarray, n_seg: int, n_dev: int):
    """Entity-agnostic core of every aligned layout: greedy-balance
    segments over shards by item count, keeping ALL of a segment's items
    on one shard, and compute the block scatter.

    Returns ``(order, sh, pos, shard_of, loc_seg, Lmax, Smax,
    counts)``: sort the item arrays by ``order``, then
    ``arr_s[sh, pos] = arr[order]`` fills the [n_dev, Lmax] blocks;
    ``shard_of``/``loc_seg`` give each segment's shard and shard-local
    id (Smax = max local segments); ``counts`` the per-segment item
    counts."""
    order = np.argsort(seg_ids, kind="stable")
    sorted_seg = seg_ids[order]
    counts = np.bincount(seg_ids, minlength=n_seg)
    shard_of, loc_seg, seg_start, loads, n_local = _greedy_balance(
        counts, n_dev)
    Lmax = max(int(loads.max()) if n_dev else 1, 1)
    Smax = max(int(n_local.max()) if n_local.size else 1, 1)
    if sorted_seg.size:
        off = np.zeros(n_seg + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        sh = shard_of[sorted_seg]
        pos = (np.arange(sorted_seg.size, dtype=np.int64)
               - off[sorted_seg] + seg_start[sorted_seg])
    else:
        sh = pos = np.zeros(0, dtype=np.int64)
    return order, sh, pos, shard_of, loc_seg, Lmax, Smax, counts


def shard_links_bloom_aligned(be: BEIndex, m: int, n_dev: int) -> dict:
    """Greedy-balance blooms over shards by link count so every bloom's
    links land on ONE rank; returns [n_dev, ...] numpy blocks with
    shard-local bloom ids (sentinel Bmax)."""
    order, sh, pos, shard_of, loc_bloom, Lmax, Bmax, _ = _aligned_layout(
        be.link_bloom, be.nb, n_dev)
    le, lt, lb = (be.link_edge[order], be.link_twin[order],
                  be.link_bloom[order])

    le_s = np.full((n_dev, Lmax), m, np.int32)
    lt_s = np.full((n_dev, Lmax), m, np.int32)
    lb_s = np.full((n_dev, Lmax), Bmax, np.int32)
    alive = np.zeros((n_dev, Lmax), bool)
    k0 = np.zeros((n_dev, Bmax), np.int32)
    if lb.size:
        le_s[sh, pos] = le
        lt_s[sh, pos] = lt
        lb_s[sh, pos] = loc_bloom[lb]
        alive[sh, pos] = True
    if be.nb:
        k0[shard_of, loc_bloom] = be.bloom_k
    return dict(le=le_s, lt=lt_s, lb=lb_s, alive=alive, k0=k0,
                Bmax=Bmax, m=m)


def make_cd_round_bloom(mesh, axis, Bmax: int, m: int):
    """One-reduction CD round over bloom-aligned shards: ``round_fn(
    peeled_pad, alive_link, k_alive, support_pad, le, lt, lb)`` on this
    rank's row of :func:`shard_links_bloom_aligned` (k_alive its (Bmax,)
    local bloom numbers)."""
    def round_fn(peeled_pad, alive_link, k_alive, support_pad, le, lt, lb):
        pe = peeled_pad[le]
        pt = peeled_pad[lt]
        pair_dies = alive_link & (pe | pt)
        canon = le < lt
        c = csr._seg((pair_dies & canon).to(_I32), lb, Bmax + 1)  # local
        widow = alive_link & ~pe & pt
        surv = alive_link & ~pair_dies
        contrib = (torch.where(widow, _pad1(k_alive)[lb] - 1, 0)
                   + torch.where(surv, c[lb], 0))
        loss = _all_reduce_staged(csr._seg(contrib, le, m + 1), mesh, axis)
        return alive_link & ~pair_dies, k_alive - c[:Bmax], support_pad - loss

    return round_fn


# =====================================================================
# CD — wedge-sharded rounds for the csr engine (no BE-Index anywhere)
# =====================================================================
@dataclasses.dataclass
class ShardedCSRState:
    """Wedge-sharded CD state of one rank: its block of the flat wedge
    list, per-pair counts W and supports replicated."""

    we1: torch.Tensor      # (L_pad / n_dev,) wedge -> edge 1 (sentinel m)
    we2: torch.Tensor      # wedge -> edge 2
    wp: torch.Tensor       # wedge -> pair (sentinel n_pairs)
    alive_w: torch.Tensor  # this rank's block
    W_pad: torch.Tensor    # (n_pairs+1,) replicated — alive wedges/pair
    support: torch.Tensor  # (m,) replicated
    n_pairs: int
    m: int


def _wing_sup0(wed: csr.Wedges) -> np.ndarray:
    sup0 = csr.edge_butterflies0(wed)
    if sup0.size and int(sup0.max()) > 2 ** 31 - 1:
        raise OverflowError("wing supports exceed int32; shard the graph")
    return sup0


def shard_wedges(wed: csr.Wedges, n_dev: int, rank: int,
                 device) -> ShardedCSRState:
    """Pad the wedge list to a multiple of n_dev (at least n_dev) and
    keep block ``rank``.  Pad wedges point at the sentinel edge m / pair
    n_pairs and start dead."""
    L = wed.n_wedges
    m = wed.m
    n_pairs = wed.n_pairs
    pad = (-L) % max(n_dev, 1)
    if L + pad == 0:
        pad = max(n_dev, 1)

    def padded(x, fill):
        full = np.concatenate([x, np.full(pad, fill, dtype=x.dtype)])
        return _t(_block(full, rank, n_dev), device)

    sup0 = _wing_sup0(wed)
    W_pad = np.zeros(n_pairs + 1, dtype=np.int32)
    W_pad[:n_pairs] = wed.W0.astype(np.int32)
    alive = np.concatenate([np.ones(L, bool), np.zeros(pad, bool)])
    return ShardedCSRState(
        we1=padded(wed.wedge_e1, m), we2=padded(wed.wedge_e2, m),
        wp=padded(wed.wedge_pair, n_pairs),
        alive_w=_t(_block(alive, rank, n_dev), device),
        W_pad=_t(W_pad, device),
        support=_t(sup0.astype(np.int32), device),
        n_pairs=n_pairs, m=m,
    )


def make_cd_round_csr(mesh, axis, n_pairs: int, m: int):
    """The wedge-sharded csr CD round (``wing_loss_csr`` algebra, two
    reductions): ``round_fn(peeled_pad, alive_w, W_pad, support_pad,
    we1, we2, wp) -> (alive_w, W_pad, support_pad)``."""
    def round_fn(peeled_pad, alive_w, W_pad, support_pad, we1, we2, wp):
        pe1 = peeled_pad[we1]
        pe2 = peeled_pad[we2]
        w_dies = alive_w & (pe1 | pe2)
        c = _all_reduce_staged(
            csr._seg(w_dies.to(_I32), wp, n_pairs + 1), mesh, axis)
        surv_loss = torch.where(alive_w & ~w_dies, c[wp], 0)
        wm1 = W_pad[wp] - 1
        loss = (
            csr._seg(torch.where(w_dies & ~pe1, wm1, 0) + surv_loss,
                     we1, m + 1)
            + csr._seg(torch.where(w_dies & ~pe2, wm1, 0) + surv_loss,
                       we2, m + 1))
        loss = _all_reduce_staged(loss, mesh, axis)
        return alive_w & ~w_dies, W_pad - c, support_pad - loss

    return round_fn


def cd_round_sharded_csr(round_fn, st: ShardedCSRState, peeled: torch.Tensor
                         ) -> ShardedCSRState:
    """One csr CD peeling round. ``peeled`` is the (m,) frontier mask."""
    alive_w, W_pad, support_pad = round_fn(
        _pad1(peeled), st.alive_w, st.W_pad, _pad1(st.support),
        st.we1, st.we2, st.wp)
    return dataclasses.replace(
        st, alive_w=alive_w, W_pad=W_pad, support=support_pad[:-1])


# =====================================================================
# CD variant — pair-aligned wedge sharding, one reduction
# =====================================================================
def shard_wedges_pair_aligned(wed: csr.Wedges, n_dev: int) -> dict:
    """Greedy-balance pairs over shards by wedge count, keeping all of a
    pair's wedges on one shard with shard-local pair ids.  Returns
    [n_dev, ...] numpy blocks: ``we1``/``we2`` (sentinel edge m), ``wp``
    (local pair ids, sentinel Pmax), ``alive``, ``W0`` (local alive
    wedge counts, [n_dev, Pmax]), plus ``Pmax`` and ``m``."""
    m = wed.m
    n_pairs = wed.n_pairs
    order, sh, pos, shard_of, loc_pair, Lmax, Pmax, counts = (
        _aligned_layout(wed.wedge_pair, n_pairs, n_dev))
    we1, we2, wp = (wed.wedge_e1[order], wed.wedge_e2[order],
                    wed.wedge_pair[order])

    we1_s = np.full((n_dev, Lmax), m, np.int32)
    we2_s = np.full((n_dev, Lmax), m, np.int32)
    wp_s = np.full((n_dev, Lmax), Pmax, np.int32)
    alive = np.zeros((n_dev, Lmax), bool)
    W0 = np.zeros((n_dev, Pmax), np.int32)
    if wp.size:
        we1_s[sh, pos] = we1
        we2_s[sh, pos] = we2
        wp_s[sh, pos] = loc_pair[wp]
        alive[sh, pos] = True
    if n_pairs:
        W0[shard_of, loc_pair] = counts
    return dict(we1=we1_s, we2=we2_s, wp=wp_s, alive=alive, W0=W0,
                Pmax=Pmax, m=m)


def make_cd_round_csr_pair_aligned(mesh, axis, Pmax: int, m: int):
    """One-reduction csr CD round over pair-aligned wedge shards: c_p
    and W_p are rank-local (a pair's wedges never straddle ranks), so
    the per-edge loss reduction is the only collective a round.
    ``round_fn(peeled_pad, alive_w, W_loc, support_pad, we1, we2, wp)``
    on this rank's row of :func:`shard_wedges_pair_aligned`."""
    def round_fn(peeled_pad, alive_w, W_loc, support_pad, we1, we2, wp):
        pe1 = peeled_pad[we1]
        pe2 = peeled_pad[we2]
        w_dies = alive_w & (pe1 | pe2)
        c = csr._seg(w_dies.to(_I32), wp, Pmax + 1)    # local
        surv_loss = torch.where(alive_w & ~w_dies, c[wp], 0)
        wm1 = _pad1(W_loc - 1)[wp]
        loss = (
            csr._seg(torch.where(w_dies & ~pe1, wm1, 0) + surv_loss,
                     we1, m + 1)
            + csr._seg(torch.where(w_dies & ~pe2, wm1, 0) + surv_loss,
                       we2, m + 1))
        loss = _all_reduce_staged(loss, mesh, axis)   # the only collective
        return alive_w & ~w_dies, W_loc - c[:Pmax], support_pad - loss

    return round_fn


# =====================================================================
# CD — tip csr: sharded pair incidence, one reduction a round always
# =====================================================================
# Tip's CD update has no cross-round sharded state: pair butterfly
# counts are static (V is never peeled), so a round is a gather + a
# segment sum over directed pair entries (vertex u loses bf(u, u') when
# partner u' peels) and the per-vertex loss reduction is the only
# collective whatever the layout.  ``aligned=True`` keeps all of a
# vertex's entries on one rank (the greedy balance), round-robin blocks
# otherwise.
def shard_tip_pairs(
    wed: csr.Wedges, pair_bf0: np.ndarray, n_dev: int,
    aligned: bool = False,
) -> dict:
    """Shard the directed pair-incidence list for the tip csr CD.

    Each pair {a, b} becomes two directed entries (dst=a, src=b) and
    (dst=b, src=a) carrying the static butterfly count, so a round's
    loss for dst is Σ bf over entries whose src peeled.  Returns
    [n_dev, Lmax] numpy blocks ``dst``/``src`` (global vertex ids,
    sentinel n) and ``bf`` (0 on padding — algebra-neutral)."""
    n = wed.n_u
    dst, src, val = csr.directed_pair_incidence(wed, pair_bf0)
    n_dev = max(n_dev, 1)
    if aligned:
        order, sh, pos, _, _, Lmax, _, _ = _aligned_layout(dst, n, n_dev)
        dst_s = np.full((n_dev, Lmax), n, np.int32)
        src_s = np.full((n_dev, Lmax), n, np.int32)
        bf_s = np.zeros((n_dev, Lmax), np.int32)
        if dst.size:
            dst_s[sh, pos] = dst[order]
            src_s[sh, pos] = src[order]
            bf_s[sh, pos] = val[order]
    else:
        L = dst.size
        Lmax = max(-(-L // n_dev), 1)
        pad = n_dev * Lmax - L
        dst_s = np.concatenate(
            [dst, np.full(pad, n, np.int64)]).astype(np.int32)
        src_s = np.concatenate(
            [src, np.full(pad, n, np.int64)]).astype(np.int32)
        bf_s = np.concatenate([val, np.zeros(pad, np.int32)])
        dst_s = dst_s.reshape(n_dev, Lmax)
        src_s = src_s.reshape(n_dev, Lmax)
        bf_s = bf_s.reshape(n_dev, Lmax)
    return dict(dst=dst_s, src=src_s, bf=bf_s, n=n)


def make_cd_round_tip_csr(mesh, axis, n: int):
    """One-reduction tip csr CD round: ``round_fn(peeled_pad,
    support_pad, dst, src, bf) -> support_pad`` on this rank's row of
    :func:`shard_tip_pairs`, either layout."""
    def round_fn(peeled_pad, support_pad, dst, src, bf):
        contrib = torch.where(peeled_pad[src], bf, 0)
        loss = _all_reduce_staged(csr._seg(contrib, dst, n + 1), mesh, axis)
        return support_pad - loss

    return round_fn


# =====================================================================
# CD — dense tip fallback: row-sharded batch re-counts
# =====================================================================
def make_tip_cd_recount(mesh, axis, n: int, n_dev: int):
    """The row-sharded tip batch re-count; returns ``(fn, rows/shard)``.

    ``fn(A_blk, alive_blk) -> (n_pad,) f32`` re-counts the butterflies
    of this rank's rows (A gathered every round, as the JAX package's
    program gathers it — O(n²) work and memory, which is why
    ``engine="csr"`` is the default), then gathers every rank's rows:
    three ``all_gather`` a call.  The products are full f32 whatever the
    process's TF32 setting; a row sum stays exact while supports are
    below 2²⁴ (every partial sum is at most its row's support)."""
    blk = -(-n // n_dev)

    def fn(A_blk, alive_blk):
        row0 = _position(mesh, axis)[0] * blk
        A_full = _all_gather(A_blk, mesh)
        alive_full = _all_gather(alive_blk, mesh)
        Am = A_full * alive_full[:, None].to(A_full.dtype)
        W = matmul_f32(A_blk * alive_blk[:, None].to(A_blk.dtype), Am.T)
        rows = row0 + torch.arange(A_blk.shape[0], device=W.device)
        cols = torch.arange(A_full.shape[0], device=W.device)
        W = torch.where(rows[:, None] == cols[None, :], 0.0, W)
        return _all_gather(torch.sum(W * (W - 1.0) * 0.5, dim=1), mesh)

    return fn, blk


# =====================================================================
# FD — beindex packer (alg.5)
# =====================================================================
def pack_fd_partitions(
    g: BipartiteGraph, be: BEIndex, part: np.ndarray, sup_init: np.ndarray,
    n_parts: int, pad_to: Optional[int] = None,
) -> dict:
    """Build [n_parts, ...] stacked local sub-indices (alg.5).

    Local ids per partition; twins outside the partition map to a
    sentinel never-peeled slot.  Everything padded so partitions stack.
    """
    ple = part[be.link_edge]
    plt_ = part[be.link_twin]
    canon_full = be.link_edge < be.link_twin
    per = []
    for i in range(n_parts):
        mine_idx = np.where(part == i)[0]
        loc = np.full(g.m, -1, dtype=np.int64)
        loc[mine_idx] = np.arange(mine_idx.size)
        pair_ge = (ple >= i) & (plt_ >= i)
        # only links anchored at a local (peelable) edge; cross-partition
        # pairs therefore appear exactly once
        keep = pair_ge & (ple == i)
        k_init = np.zeros(be.nb, dtype=np.int64)
        np.add.at(k_init, be.link_bloom[pair_ge & canon_full], 1)
        kl_e, kl_t, kl_b = (be.link_edge[keep], be.link_twin[keep],
                            be.link_bloom[keep])
        twin_local = part[kl_t] == i
        # count each dying pair once: both-local pairs via id order,
        # cross pairs via their single link
        canon = np.where(twin_local, kl_e < kl_t, True)
        blooms = np.unique(kl_b)
        bloc = np.full(be.nb + 1, 0, dtype=np.int64)
        if blooms.size:
            bloc[blooms] = np.arange(blooms.size)
        per.append(dict(
            edges=mine_idx,
            le=loc[kl_e], lt=np.where(twin_local, loc[kl_t], -1),
            lb=bloc[kl_b], canon=canon,
            k0=k_init[blooms],
            sup0=sup_init[mine_idx],
        ))
    Lmax = max((p["le"].size for p in per), default=1) or 1
    Emax = max((p["edges"].size for p in per), default=1) or 1
    Bmax = max((p["k0"].size for p in per), default=1) or 1
    if pad_to:
        Lmax, Emax, Bmax = (max(Lmax, pad_to), max(Emax, pad_to),
                            max(Bmax, pad_to))

    def pk(key, size, fill, dtype=np.int32):
        out = np.full((n_parts, size), fill, dtype=dtype)
        for i, p in enumerate(per):
            x = p[key]
            out[i, : x.size] = x
        return out

    # sentinel local edge id = Emax (extra never-peeled slot)
    le = pk("le", Lmax, Emax)
    lt = np.where(pk("lt", Lmax, -1) < 0, Emax,
                  pk("lt", Lmax, -1)).astype(np.int32)
    canon = pk("canon", Lmax, 0, dtype=bool)
    alive0 = np.zeros((n_parts, Lmax), dtype=bool)
    for i, p in enumerate(per):
        alive0[i, : p["le"].size] = True
    mine = np.zeros((n_parts, Emax), dtype=bool)
    sup0 = np.zeros((n_parts, Emax), dtype=np.int32)
    gids = np.zeros((n_parts, Emax), dtype=np.int32)
    for i, p in enumerate(per):
        mine[i, : p["edges"].size] = True
        sup0[i, : p["edges"].size] = p["sup0"]
        gids[i, : p["edges"].size] = p["edges"]
    k0 = pk("k0", Bmax, 0)
    return dict(
        le=le, lt=lt, lb=pk("lb", Lmax, Bmax - 1), alive0=alive0,
        canon=canon, k0=k0, sup0=sup0, mine=mine, gids=gids,
        sizes=(Lmax, Emax, Bmax),
    )


# =====================================================================
# FD — partition-stacked, collective-free
# =====================================================================
# Each body peels a (B, ...) block of stacked partitions in one batched
# loop — what ``shard_map(jax.vmap(body))`` runs on a device — with the
# segment-sum update of the JAX package's per-partition body; the ids
# of partition b are offset into a segment range of their own.
def _offsets(B: int, width: int, device) -> torch.Tensor:
    return (torch.arange(B, dtype=_I32, device=device) * width)[:, None]


def _fd_body_beindex(le, lt, lb, alive0, canon, k0, sup0, mine):
    """Peel a block of beindex partitions bottom-up with the alg.6
    widow/survivor update: one batched loop, no collectives."""
    B, Emax = mine.shape
    L = le.shape[1]
    Bmax = k0.shape[1]
    dev = mine.device
    off_e = _offsets(B, Emax + 1, dev)
    leg = (le + off_e).reshape(-1)
    ltg = (lt + off_e).reshape(-1)
    lbg = (lb + _offsets(B, Bmax, dev)).reshape(-1)
    canon = canon.reshape(-1)
    zero = torch.zeros((), dtype=_I32, device=dev)

    def update(S, aux):
        alive_link, k_alive = aux
        pe = torch.cat([S, S.new_zeros((B, 1))], dim=1).reshape(-1)
        p_e = pe[leg]
        p_t = pe[ltg]
        pair_dies = alive_link & (p_e | p_t)
        c = csr._seg((pair_dies & canon).to(_I32), lbg, B * Bmax)
        widow = alive_link & ~p_e & p_t
        surv = alive_link & ~pair_dies
        contrib = (torch.where(widow, k_alive[lbg] - 1, 0)
                   + torch.where(surv, c[lbg], 0))
        loss = csr._seg(contrib, leg, B * (Emax + 1))
        return (loss.reshape(B, Emax + 1)[:, :Emax],
                (alive_link & ~pair_dies, k_alive - c), zero)

    theta, rounds, _ = _fd_while_vmapped(
        mine, sup0, update, (alive0.reshape(-1), k0.reshape(-1)))
    return theta, rounds


def _fd_body_csr(we1, we2, wp, alive0, W0, sup0, mine):
    """Peel a block of csr wing partitions bottom-up
    (``peel._fd_wing_vmapped``: ``csr.wing_loss_csr`` over the block's
    offset wedge lists): one batched loop, no collectives."""
    B, Emax = mine.shape
    Pmax = W0.shape[1]
    off_e = _offsets(B, Emax + 1, mine.device)
    theta, rounds, _, _ = _fd_wing_vmapped(
        (we1 + off_e).reshape(-1), (we2 + off_e).reshape(-1),
        (wp + _offsets(B, Pmax, mine.device)).reshape(-1),
        alive0.reshape(-1), W0.reshape(-1), mine, sup0, n_pairs=B * Pmax)
    return theta, rounds


def _fd_body_tip_csr(pa, pb, bf, mine, sup0):
    """Peel a block of csr tip partitions bottom-up with the static
    pair-butterfly update (``peel._fd_tip_vmapped`` over the block's
    offset pair lists): one batched loop, no collectives."""
    B, Emax = mine.shape
    off = _offsets(B, Emax, mine.device)
    theta, rounds, _, _ = _fd_tip_vmapped(
        (pa + off).reshape(-1), (pb + off).reshape(-1), bf.reshape(-1),
        mine, sup0)
    return theta, rounds


def _fd_body_tip_dense(A, mine, sup0):
    """Peel a block of dense tip partitions bottom-up: the static
    pairwise-butterfly matrix of each partition (full-f32 product), then
    one matrix-vector update a round; no collectives.

    A: [B, Umax, nv] rows of each partition (zero-padded), mine [B,
    Umax], sup0 [B, Umax] f32."""
    W = matmul_f32(A, A.transpose(1, 2))
    W = W * (1.0 - torch.eye(W.shape[1], dtype=W.dtype, device=W.device))
    pair_bf = W * (W - 1.0) * 0.5
    zero = torch.zeros((), dtype=_I32, device=A.device)

    def update(S, aux):
        loss = matmul_f32(pair_bf, S.to(pair_bf.dtype)[:, :, None])[:, :, 0]
        return torch.round(loss).to(_I32), aux, zero

    theta, rounds, _ = _fd_while_vmapped(
        mine, torch.round(sup0).to(_I32), update, None)
    return theta, rounds


def _fd_run_sharded(body, packed: dict, keys: Tuple[str, ...], mesh, axis,
                    device) -> Tuple[np.ndarray, np.ndarray]:
    """Shared FD launcher: pad the partition axis to a multiple of the
    world size, peel this rank's block (no collective: counted under
    ``fd``), then one ``all_gather`` of every rank's (θ, rounds) (under
    ``result``).  Returns host (theta [n_parts, E], rounds [n_parts])."""
    idx, n_dev = _position(mesh, axis)
    n_parts = packed[keys[0]].shape[0]
    blk = -(-n_parts // n_dev)

    def block(x):
        b = x[idx * blk:(idx + 1) * blk]
        fill = np.zeros((blk - b.shape[0],) + x.shape[1:], dtype=x.dtype)
        return _t(np.concatenate([b, fill]), device)

    args = tuple(block(packed[k]) for k in keys)
    with _phase("fd"):
        if blk:
            theta, rounds = body(*args)
        else:
            theta = torch.zeros(args[-1].shape[:2], dtype=_I32, device=device)
            rounds = torch.zeros((0,), dtype=_I32, device=device)
    with _phase("result"):
        both = _all_gather(
            torch.cat([theta.to(_I32), rounds.to(_I32)[:, None]], dim=1),
            mesh).cpu().numpy()
    return both[:n_parts, :-1], both[:n_parts, -1]


def fd_peel_sharded(packed: dict, mesh, axis, device
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Peel all beindex partitions concurrently: a block of partitions
    per rank, batched within it.  Returns (theta, rounds) in packed
    local layout, on every rank."""
    return _fd_run_sharded(
        _fd_body_beindex, packed,
        ("le", "lt", "lb", "alive0", "canon", "k0", "sup0", "mine"),
        mesh, axis, device)


def fd_peel_sharded_csr(packed: dict, mesh, axis, device
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """csr wing counterpart of :func:`fd_peel_sharded` over
    ``fdpack.pack_fd_partitions_csr``'s stacks."""
    return _fd_run_sharded(
        _fd_body_csr, packed,
        ("we1", "we2", "wp", "alive0", "W0", "sup0", "mine"),
        mesh, axis, device)


def fd_peel_sharded_tip_csr(packed: dict, mesh, axis, device
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """csr tip counterpart of :func:`fd_peel_sharded` over the stacked
    local pair lists (``fdpack.pack_fd_partitions_tip_csr`` with
    ``stacked=True``)."""
    return _fd_run_sharded(
        _fd_body_tip_csr, packed,
        ("st_pa", "st_pb", "st_bf", "mine", "sup0"),
        mesh, axis, device)


# =====================================================================
# End-to-end distributed decompositions
# =====================================================================
def _scatter_theta(theta, packed, theta_loc, n_parts):
    """Map packed-local θ back to global entity ids."""
    for i in range(n_parts):
        mine = packed["mine"][i]
        theta[packed["gids"][i][mine]] = theta_loc[i][mine]


def _finish(theta, part, ranges, sup_init, stats, extras, return_result,
            seconds):
    """Assemble the (theta, stats[, PeelResult]) return of the
    distributed decompositions: JSON-able stats dict with the mesh
    extras, full provenance (and the host-clock ``seconds`` of spec
    setup, CD and FD) only when asked for."""
    stats_out = stats.as_dict()
    stats_out.update(extras)
    if not return_result:
        return theta, stats_out
    result = PeelResult(
        theta=theta, part=part, ranges=ranges,
        support_init=sup_init, stats=stats, seconds=seconds,
    )
    return theta, stats_out, result


def _record_fd_sharded(n_parts: int, rounds) -> None:
    """Record a sharded FD's per-partition round counts into the active
    timeline collector (per-round rows stay on the ranks; totals are
    exact), as the JAX package records its ``shard_map`` FD."""
    col = obs.active_collector()
    if col is not None and n_parts:
        r = np.asarray(rounds).reshape(-1)[:n_parts]
        col.record_fd_counts(
            "sharded", list(range(n_parts)), r.astype(np.int64).tolist())


def _with_obs(kind: str):
    """Wrap a distributed decomposition entry with the observability
    collector: a ``peel``-cat span around the run, a timeline built from
    the collector (CD rounds recorded live by ``cd_loop``; FD round
    counts recorded by the sharded/vmapped FD sections), its trace
    events, and attachment to the returned stats dict / PeelResult.
    With the obs layer off this adds one ``is None`` check."""
    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            with obs.maybe_collect() as col:
                with obs.span(f"peel.{fn.__name__}", cat="peel",
                              kind=kind):
                    out = fn(*args, **kwargs)
            if col is not None:
                tl = col.build()
                tracer = obs.get_tracer()
                if tracer is not None:
                    tl.emit_trace_events(tracer)
                out[1]["timeline"] = tl.summary()
                if len(out) == 3:
                    out[2].timeline = tl
            return out
        return wrapper
    return deco


def _cd(spec, P_parts, stats, total):
    """The CD loop, its collectives counted under ``cd``; returns
    (part, sup_init, ranges, n_parts, seconds)."""
    t0 = time.perf_counter()
    with obs.span("cd", cat="cd"), _phase("cd"):
        out = cd_loop(spec, P_parts, stats,
                      target=FixedTarget(float(total), P_parts))
    return (*out, time.perf_counter() - t0)


def _fd_stats(stats, rounds) -> None:
    rounds = np.asarray(rounds)
    stats.rho_fd_total = int(rounds.sum())
    stats.rho_fd_max = int(rounds.max()) if rounds.size else 0


@_with_obs("wing")
def distributed_wing_decomposition(
    g: BipartiteGraph,
    mesh,
    axis="peel",
    P_parts: int = 8,
    be: Optional[BEIndex] = None,
    bloom_aligned: bool = False,
    engine: str = "beindex",
    pair_aligned: bool = False,
    aligned: Optional[bool] = None,
    device=None,
    return_result: bool = False,
):
    """Full PBNG wing decomposition over the ranks of ``mesh``.

    ``engine="beindex"``: link-sharded CD rounds (two reductions;
    ``bloom_aligned=True`` the one-reduction layout) + link-packed FD.
    ``engine="csr"``: wedge-sharded CD rounds + wedge-packed FD —
    O(Σ deg²) memory end to end, no BE-Index built; ``pair_aligned=True``
    keeps all of a pair's wedges on one rank, so CD pays one reduction
    a round instead of two.  FD is collective-free either way.
    ``aligned`` is the entity-agnostic spelling (the CLI's flag): it
    maps to ``pair_aligned`` for csr and ``bloom_aligned`` for beindex.

    Every rank of the mesh calls this with the same arguments and gets
    the same ``(theta, stats)`` (``return_result=True`` appends the
    :class:`~repro_torch.core.peelspec.PeelResult`, whose ``seconds``
    split spec setup, CD and FD).  ``device`` defaults to the mesh's
    device type on this rank's card (``LOCAL_RANK``); there is no CPU
    default.

    Example (four gloo ranks on the CPU, under ``torch.distributed.run``)::

        init_peel_group("cpu")
        mesh = make_peel_mesh(device="cpu")
        theta, stats = distributed_wing_decomposition(
            g, mesh, engine="csr", pair_aligned=True)
    """
    if engine not in ("beindex", "csr"):
        raise ValueError(engine)
    if aligned is not None:
        if engine == "csr":
            pair_aligned = aligned
        else:
            bloom_aligned = aligned
    if pair_aligned and engine != "csr":
        raise ValueError(
            "pair_aligned shards the wedge list: csr engine only "
            "(the beindex analogue is bloom_aligned)"
        )
    if engine == "csr":
        if bloom_aligned or be is not None:
            raise ValueError(
                "engine='csr' builds no BE-Index: bloom_aligned/be "
                "only apply to engine='beindex'"
            )
        return _distributed_wing_csr(
            g, mesh, axis, P_parts, pair_aligned=pair_aligned,
            device=device, return_result=return_result)
    t0 = time.perf_counter()
    dev = _rank_device(mesh, device)
    idx, n_dev = _position(mesh, axis)
    if be is None:
        be = build_beindex(g, dev)
    m = g.m
    if bloom_aligned:
        packed = shard_links_bloom_aligned(be, m, n_dev)
        round_fn = make_cd_round_bloom(mesh, axis, packed["Bmax"], m)
        bl = {k: _t(packed[k][idx], dev)
              for k in ("alive", "k0", "le", "lt", "lb")}
        support = _t(be.edge_support(m).astype(np.int32), dev)
    else:
        st = shard_links(be, m, n_dev, idx, dev)
        round_fn = make_cd_round(mesh, axis, st.nb, m)
        support = st.support

    def step(active: np.ndarray) -> np.ndarray:
        nonlocal st, support
        peeled = _t(active, dev)
        if bloom_aligned:
            bl["alive"], bl["k0"], support_pad = round_fn(
                _pad1(peeled), bl["alive"], bl["k0"], _pad1(support),
                bl["le"], bl["lt"], bl["lb"])
            support = support_pad[:-1]
            return _host(support)
        st = cd_round_sharded(round_fn, st, peeled)
        return _host(st.support)

    stats = PeelStats(engine="beindex", fd_driver="device")
    sup0 = _host(support)
    spec = PeelSpec(
        kind="wing", n=m, sup0=sup0,
        workload=lambda s: np.maximum(s, 1), est=lambda s: s,
        cd_step=step,
    )
    t1 = time.perf_counter()
    part, sup_init, ranges, n_parts, cd_s = _cd(spec, P_parts, stats,
                                                sup0.sum())
    t2 = time.perf_counter()
    with obs.span("fd", cat="fd", driver="sharded") as sp:
        packed = pack_fd_partitions(g, be, part, sup_init, n_parts)
        theta_loc, rounds = fd_peel_sharded(packed, mesh, axis, dev)
        if sp is not None:
            sp.update(rounds=int(rounds.sum()))
    theta = np.zeros(m, dtype=np.int64)
    _scatter_theta(theta, packed, theta_loc, n_parts)
    _fd_stats(stats, rounds)
    _record_fd_sharded(n_parts, rounds)
    return _finish(
        theta, part, ranges, sup_init, stats,
        dict(n_parts=n_parts, n_links=be.n_links, n_dev=int(n_dev)),
        return_result,
        dict(spec=t1 - t0, cd=cd_s, fd=time.perf_counter() - t2))


def _distributed_wing_csr(
    g: BipartiteGraph, mesh, axis, P_parts: int,
    pair_aligned: bool = False, device=None, return_result: bool = False,
):
    """csr engine over the mesh: wedge-sharded CD + wedge-packed FD;
    ``pair_aligned`` swaps the round-robin wedge blocks for the
    pair-aligned layout (one reduction a CD round instead of two)."""
    t0 = time.perf_counter()
    dev = _rank_device(mesh, device)
    idx, n_dev = _position(mesh, axis)
    wed = csr.build_wedges(g)
    m = g.m
    if pair_aligned:
        packed = shard_wedges_pair_aligned(wed, n_dev)
        round_fn = make_cd_round_csr_pair_aligned(
            mesh, axis, packed["Pmax"], m)
        pa = {k: _t(packed[k][idx], dev)
              for k in ("alive", "W0", "we1", "we2", "wp")}
        support = _t(_wing_sup0(wed).astype(np.int32), dev)
    else:
        st = shard_wedges(wed, n_dev, idx, dev)
        round_fn = make_cd_round_csr(mesh, axis, st.n_pairs, m)
        support = st.support

    def step(active: np.ndarray) -> np.ndarray:
        nonlocal st, support
        peeled = _t(active, dev)
        if pair_aligned:
            pa["alive"], pa["W0"], support_pad = round_fn(
                _pad1(peeled), pa["alive"], pa["W0"], _pad1(support),
                pa["we1"], pa["we2"], pa["wp"])
            support = support_pad[:-1]
            return _host(support)
        st = cd_round_sharded_csr(round_fn, st, peeled)
        return _host(st.support)

    stats = PeelStats(engine="csr", fd_driver="device")
    sup0 = _host(support)
    spec = PeelSpec(
        kind="wing", n=m, sup0=sup0,
        workload=lambda s: np.maximum(s, 1), est=lambda s: s,
        cd_step=step,
    )
    t1 = time.perf_counter()
    part, sup_init, ranges, n_parts, cd_s = _cd(spec, P_parts, stats,
                                                sup0.sum())
    t2 = time.perf_counter()
    with obs.span("fd", cat="fd", driver="sharded") as sp:
        packed = fdpack.pack_fd_partitions_csr(wed, part, sup_init, n_parts)
        theta_loc, rounds = fd_peel_sharded_csr(packed, mesh, axis, dev)
        if sp is not None:
            sp.update(rounds=int(rounds.sum()))
    theta = np.zeros(m, dtype=np.int64)
    _scatter_theta(theta, packed, theta_loc, n_parts)
    _fd_stats(stats, rounds)
    _record_fd_sharded(n_parts, rounds)
    return _finish(
        theta, part, ranges, sup_init, stats,
        dict(cd_sharding="pair_aligned" if pair_aligned else "wedge",
             n_parts=n_parts, n_wedges=wed.n_wedges,
             n_pairs=wed.n_pairs, n_dev=n_dev),
        return_result,
        dict(spec=t1 - t0, cd=cd_s, fd=time.perf_counter() - t2))


@_with_obs("tip")
def distributed_tip_decomposition(
    g: BipartiteGraph,
    mesh,
    axis="peel",
    side: str = "u",
    P_parts: int = 8,
    engine: str = "csr",
    aligned: bool = False,
    fd_driver: str = "device",
    device=None,
    return_result: bool = False,
):
    """Full PBNG tip decomposition over the ranks of ``mesh``.

    ``engine="csr"`` (default): the directed pair-incidence list is
    sharded (``aligned=True`` keeps all of a vertex's entries on one
    rank) and every CD round pays exactly one reduction (pair
    butterflies are static: there is no dying-count collective); FD
    stacks the disjoint per-partition pair lists and peels a block of
    them per rank with zero collectives (``fd_driver="device"``), or
    runs ``peel._tip_fd_vmapped_csr`` — one batched loop over every
    partition, unfused — on every rank, on its own device, which needs
    no collective either (``fd_driver="vmapped"``).

    ``engine="dense"``: the explicit O(n²) fallback — row-sharded
    batch re-counts for CD (each round gathers the row blocks, the alive
    flags and the recounted rows), stacked matrix-cascade partitions for
    FD.

    θ is bit-identical across both engines and to the single-device
    engines; the rest as :func:`distributed_wing_decomposition`."""
    if engine not in ("csr", "dense"):
        raise ValueError(engine)
    if fd_driver not in ("device", "vmapped"):
        raise ValueError(fd_driver)
    if engine == "dense" and (aligned or fd_driver != "device"):
        raise ValueError(
            "aligned / fd_driver='vmapped' need the wedge list: "
            "engine='csr' only")
    gg = g if side == "u" else g.transpose()
    if engine == "csr":
        return _distributed_tip_csr(
            gg, mesh, axis, side, P_parts, aligned=aligned,
            fd_driver=fd_driver, device=device, return_result=return_result)
    return _distributed_tip_dense(
        gg, mesh, axis, side, P_parts, device=device,
        return_result=return_result)


def _distributed_tip_csr(
    gg: BipartiteGraph, mesh, axis, side: str, P_parts: int,
    aligned: bool = False, fd_driver: str = "device", device=None,
    return_result: bool = False,
):
    """csr tip over the mesh: one-reduction pair-incidence CD + stacked
    pair FD."""
    t0 = time.perf_counter()
    dev = _rank_device(mesh, device)
    idx, n_dev = _position(mesh, axis)
    wed = csr.build_wedges(gg)
    n = gg.n_u
    pair_bf0 = wed.pair_butterflies0()
    sup0 = csr.vertex_butterflies_csr(wed)
    if sup0.size and int(sup0.max()) > 2 ** 31 - 1:
        raise OverflowError("tip supports exceed int32; shard the graph")
    wu, _ = csr.wedge_workload(gg)
    wedge_w = wu.astype(np.float64)

    blocks = shard_tip_pairs(wed, pair_bf0, n_dev, aligned=aligned)
    round_fn = make_cd_round_tip_csr(mesh, axis, n)
    dst, src, bf = (_t(blocks[k][idx], dev) for k in ("dst", "src", "bf"))
    state = dict(support=_t(sup0.astype(np.int32), dev))

    def step(active: np.ndarray) -> np.ndarray:
        state["support"] = round_fn(
            _pad1(_t(active, dev)), _pad1(state["support"]), dst, src,
            bf)[:-1]
        return _host(state["support"])

    stats = PeelStats(engine="csr", fd_driver=fd_driver, side=side)
    # the same ≥1 workload clamp as the dense distributed path, so the
    # two engines pick identical range boundaries
    spec = PeelSpec(
        kind="tip", n=n, sup0=sup0,
        workload=lambda s: np.maximum(wedge_w, 1),
        est=lambda s: wedge_w,
        cd_step=step,
    )
    t1 = time.perf_counter()
    part, sup_init, ranges, n_parts, cd_s = _cd(spec, P_parts, stats,
                                                wedge_w.sum())
    t2 = time.perf_counter()
    theta = np.zeros(n, dtype=np.int64)
    if n_parts:
        with obs.span("fd", cat="fd", driver=fd_driver) as sp:
            if fd_driver == "vmapped":
                # every rank peels every partition on its own device;
                # the vmapped wrapper drains its own counter rings
                with _phase("fd"):
                    rounds = _tip_fd_vmapped_csr(
                        wed, pair_bf0, part, sup_init, theta, n_parts,
                        False, dev)
            else:
                packed = fdpack.pack_fd_partitions_tip_csr(
                    wed, pair_bf0, part, sup_init, n_parts, stacked=True)
                theta_loc, rounds = fd_peel_sharded_tip_csr(
                    packed, mesh, axis, dev)
                _scatter_theta(theta, packed, theta_loc, n_parts)
                _record_fd_sharded(n_parts, rounds)
            if sp is not None:
                sp.update(rounds=int(np.asarray(rounds).sum()))
        _fd_stats(stats, rounds)
    return _finish(
        theta, part, ranges, sup_init, stats,
        dict(cd_sharding="vertex_aligned" if aligned else "pair",
             n_parts=n_parts, n_wedges=wed.n_wedges,
             n_pairs=wed.n_pairs, n_dev=n_dev),
        return_result,
        dict(spec=t1 - t0, cd=cd_s, fd=time.perf_counter() - t2))


def _distributed_tip_dense(
    gg: BipartiteGraph, mesh, axis, side: str, P_parts: int, device=None,
    return_result: bool = False,
):
    """Dense tip over the mesh: row-sharded batch re-counts for CD,
    stacked matrix-cascade partitions for FD — the explicit O(n²)
    fallback behind ``engine="dense"``."""
    t0 = time.perf_counter()
    dev = _rank_device(mesh, device)
    idx, n_dev = _position(mesh, axis)
    n, nv = gg.n_u, gg.n_v
    A_np = gg.adjacency()
    recount_fn, blk = make_tip_cd_recount(mesh, axis, n, n_dev)
    n_pad = blk * n_dev
    A_blk = _t(_block(np.pad(A_np, ((0, n_pad - n), (0, 0))), idx, n_dev),
               dev)
    alive_pad = np.ones(n_pad, bool)
    alive_pad[n:] = False

    def recount() -> torch.Tensor:
        return recount_fn(A_blk, _t(_block(alive_pad, idx, n_dev), dev))

    with _phase("cd"):
        sup_f = recount()
    counting.assert_exact(sup_f)
    sup0 = np.rint(sup_f.cpu().numpy()).astype(np.int64)[:n]
    wedge_w = np.rint(counting.vertex_wedge_workload(
        _t(A_np, dev)).cpu().numpy()).astype(np.int64)

    def step(active: np.ndarray) -> np.ndarray:
        alive_pad[:n] &= ~active
        return np.rint(recount().cpu().numpy()).astype(np.int64)[:n]

    stats = PeelStats(engine="dense", fd_driver="device", side=side)
    # range-selection weights clamp to ≥1 so zero-wedge vertices still
    # advance the cumulative-workload scan
    spec = PeelSpec(
        kind="tip", n=n, sup0=sup0,
        workload=lambda s: np.maximum(wedge_w, 1),
        est=lambda s: wedge_w,
        cd_step=step,
    )
    t1 = time.perf_counter()
    part, sup_init, ranges, n_parts, cd_s = _cd(spec, P_parts, stats,
                                                wedge_w.sum())
    t2 = time.perf_counter()

    # ---- FD: stack padded partitions, a block of them per rank
    rows_per = [np.where(part == i)[0] for i in range(n_parts)]
    Umax = max(max((r.size for r in rows_per), default=1), 1)
    pad_parts = -(-max(n_parts, 1) // n_dev) * n_dev
    A_st = np.zeros((pad_parts, Umax, nv), np.float32)
    mine = np.zeros((pad_parts, Umax), bool)
    sup_st = np.zeros((pad_parts, Umax), np.float32)
    gids = np.zeros((pad_parts, Umax), np.int64)
    for i, r in enumerate(rows_per):
        A_st[i, : r.size] = A_np[r]
        mine[i, : r.size] = True
        sup_st[i, : r.size] = sup_init[r]
        gids[i, : r.size] = r
    with obs.span("fd", cat="fd", driver="sharded") as sp:
        theta_st, rounds = _fd_run_sharded(
            _fd_body_tip_dense, dict(A=A_st, mine=mine, sup=sup_st),
            ("A", "mine", "sup"), mesh, axis, dev)
        rounds = rounds[:n_parts]
        if sp is not None:
            sp.update(rounds=int(rounds.sum()))
    theta = np.zeros(n, np.int64)
    _scatter_theta(theta, dict(mine=mine, gids=gids),
                   theta_st.astype(np.int64), n_parts)
    _fd_stats(stats, rounds)
    _record_fd_sharded(n_parts, rounds)
    return _finish(
        theta, part, ranges, sup_init, stats,
        dict(n_parts=n_parts, n_dev=n_dev),
        return_result,
        dict(spec=t1 - t0, cd=cd_s, fd=time.perf_counter() - t2))

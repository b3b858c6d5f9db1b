"""FD partition packers of the csr engine (numpy, host side).

Copied from the JAX package's ``core/distributed.py`` so both packages
stack the same per-partition arrays; ``tests/test_torch_csr.py`` holds
them array-equal.  The sharded CD/FD paths of that module are not ported
yet (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import csr
from .peelspec import _bucket_pad

__all__ = [
    "pack_fd_partitions_csr",
    "pack_fd_partitions_tip_csr",
]


def pack_fd_partitions_csr(
    wed: csr.Wedges, part: np.ndarray, sup_init: np.ndarray,
    n_parts: int, pad_to: Optional[int] = None,
    bucket: bool = False, slots: bool = False, flat: bool = False,
) -> dict:
    """Stack per-partition wedge sub-lists into [n_parts, ...] arrays.

    Partition i's sub-structure = wedges with both edges in partitions
    ≥ i (the same induced subgraph the single-device csr FD uses); edge
    ids are partition-local with a sentinel slot Emax for never-peeled
    later-partition edges, pair ids are relabeled per partition.

    ``bucket=True`` rounds the stacked dims (Lmax, Emax, Pmax) up to
    quarter-power-of-two buckets (``peelspec._bucket_pad``), as the JAX
    package does to bound its recompiles; the port keeps it so both
    packages stack the same shapes.

    ``flat=True`` additionally emits the ragged-concatenated arrays the
    single-device single-dispatch driver consumes (see
    :func:`_pack_fd_flat_csr` — the touching-wedge lists are disjoint,
    so concatenation carries zero padding waste).

    ``slots=True`` additionally packs each partition's wedge list into
    the pairs-major slot layout of the ``fd_round_wing`` and
    ``support_update`` kernels (`core.csr.PaddedCSR` per partition,
    stacked): ``slot_e1``/``slot_e2`` are [n_parts, R, K]
    partition-local edge ids (sentinel Emax on padding slots),
    ``slot_valid`` the initial alive matrix.  Rows of all partitions
    share one (R, K) shape, so one launch per round covers every
    partition."""
    m = part.size
    pe1 = part[wed.wedge_e1] if wed.n_wedges else np.zeros(0, np.int32)
    pe2 = part[wed.wedge_e2] if wed.n_wedges else np.zeros(0, np.int32)
    pmin = np.minimum(pe1, pe2)
    per = []
    for i in range(n_parts):
        mine_idx = np.where(part == i)[0]
        loc = np.full(m, -1, dtype=np.int64)
        loc[mine_idx] = np.arange(mine_idx.size)
        keep_ge = (pe1 >= i) & (pe2 >= i)
        # only wedges TOUCHING partition i can die during FD_i (edges of
        # later partitions never peel here), and survivor charges from
        # untouched ≥i wedges land only on discarded later-partition
        # edges — so the wedge list holds the touching wedges while the
        # untouched ones fold into the static W0 count (they stay alive
        # the whole phase).  Exact, and it makes the stacked lists
        # disjoint across partitions: each wedge appears exactly once,
        # in partition min(part[e1], part[e2]).
        keep = keep_ge & (pmin == i)
        kwe1 = wed.wedge_e1[keep]
        kwe2 = wed.wedge_e2[keep]
        pair_ids, wp_loc = np.unique(wed.wedge_pair[keep],
                                     return_inverse=True)
        cnt_ge = np.bincount(wed.wedge_pair[keep_ge],
                             minlength=max(wed.n_pairs, 1))
        per.append(dict(
            edges=mine_idx,
            we1=np.where(part[kwe1] == i, loc[kwe1], -1),
            we2=np.where(part[kwe2] == i, loc[kwe2], -1),
            wp=wp_loc,
            W0=(cnt_ge[pair_ids] if pair_ids.size
                else np.zeros(1, np.int64)),
            sup0=sup_init[mine_idx],
        ))
    Lmax = max((p["we1"].size for p in per), default=1) or 1
    Emax = max((p["edges"].size for p in per), default=1) or 1
    Pmax = max((p["W0"].size for p in per), default=1) or 1
    if bucket:
        Lmax = _bucket_pad(Lmax)
        Emax = _bucket_pad(Emax, floor=8)
        Pmax = _bucket_pad(Pmax, floor=8)
    if pad_to:
        Lmax, Emax, Pmax = (max(Lmax, pad_to), max(Emax, pad_to),
                            max(Pmax, pad_to))

    def pk(key, size, fill, dtype=np.int32):
        out = np.full((n_parts, size), fill, dtype=dtype)
        for i, p in enumerate(per):
            x = p[key]
            out[i, : x.size] = x
        return out

    # sentinel local edge id = Emax (extra never-peeled slot); pad wedges
    # carry pair 0 but start dead, so they contribute nothing
    w1 = pk("we1", Lmax, -1)
    w2 = pk("we2", Lmax, -1)
    we1 = np.where(w1 < 0, Emax, w1).astype(np.int32)
    we2 = np.where(w2 < 0, Emax, w2).astype(np.int32)
    alive0 = np.zeros((n_parts, Lmax), dtype=bool)
    mine = np.zeros((n_parts, Emax), dtype=bool)
    sup0 = np.zeros((n_parts, Emax), dtype=np.int32)
    gids = np.zeros((n_parts, Emax), dtype=np.int32)
    for i, p in enumerate(per):
        alive0[i, : p["we1"].size] = True
        mine[i, : p["edges"].size] = True
        sup0[i, : p["edges"].size] = p["sup0"]
        gids[i, : p["edges"].size] = p["edges"]
    packed = dict(
        we1=we1, we2=we2, wp=pk("wp", Lmax, 0), alive0=alive0,
        W0=pk("W0", Pmax, 0), sup0=sup0, mine=mine, gids=gids,
        sizes=(Lmax, Emax, Pmax),
    )
    if flat:
        packed.update(_pack_fd_flat_csr(per, n_parts, Emax, bucket=bucket))
    if slots:
        packed.update(_pack_fd_slots_csr(per, n_parts, Emax, bucket=bucket))
    return packed


def _pack_fd_flat_csr(per: list, n_parts: int, Emax: int,
                      bucket: bool = False) -> dict:
    """Ragged-concatenated wedge arrays for the single-dispatch FD.

    The touching-wedge lists are disjoint across partitions, so instead
    of stacking them [n_parts, Lmax] (up to Lmax/mean padding waste) the
    single-device vmapped driver concatenates them into ONE flat list
    with pre-globalized segment ids: partition b's local edge e becomes
    segment b·(Emax+1)+e, its local pair p becomes base_b+p.  Per-round
    work is then O(Σ|list_i|) regardless of partition imbalance.  Pad
    wedges (bucketed tail) point at partition 0's sentinel edge and a
    dedicated dead pair and start dead."""
    sizes = [p["wp"].size for p in per]
    npairs = [int(p["W0"].size) for p in per]
    pair_base = np.zeros(n_parts + 1, dtype=np.int64)
    np.cumsum(npairs, out=pair_base[1:])
    Ptot = int(pair_base[-1])
    Wtot = int(sum(sizes))
    Wpad = Wtot
    Ppad = Ptot + 1
    if bucket:
        Wpad = _bucket_pad(max(Wtot, 1))
        Ppad = _bucket_pad(Ptot + 1, floor=8)
    fe1 = np.full(Wpad, Emax, dtype=np.int32)   # partition-0 sentinel
    fe2 = np.full(Wpad, Emax, dtype=np.int32)
    fwp = np.full(Wpad, Ptot, dtype=np.int32)   # dedicated dead pair
    falive = np.zeros(Wpad, dtype=bool)
    fW0 = np.zeros(Ppad, dtype=np.int32)
    pos = 0
    for i, p in enumerate(per):
        k = p["wp"].size
        off = i * (Emax + 1)
        e1 = np.where(p["we1"] < 0, Emax, p["we1"]) + off
        e2 = np.where(p["we2"] < 0, Emax, p["we2"]) + off
        fe1[pos: pos + k] = e1
        fe2[pos: pos + k] = e2
        fwp[pos: pos + k] = p["wp"] + pair_base[i]
        falive[pos: pos + k] = True
        fW0[pair_base[i]: pair_base[i + 1]] = p["W0"]
        pos += k
    return dict(flat_we1=fe1, flat_we2=fe2, flat_wp=fwp,
                flat_alive0=falive, flat_W0=fW0,
                flat_sizes=(Wpad, Ppad))


def _pack_fd_slots_csr(per: list, n_parts: int, Emax: int,
                       bucket: bool = False) -> dict:
    """Stacked pairs-major slot layout of the in-loop FD kernels.

    Row r of partition i's block holds the wedges of local pair r
    (``core.csr.pad_segments`` per partition), all blocks padded to one
    (R, K) shape.  Slot edge ids are partition-local with sentinel Emax
    (the extra never-peeled edge slot), so the FD body's peeled-flag
    gathers and loss scatters need no masking."""
    # the kernel carries counts as f32 — same exactness boundary as
    # core.csr.pack_update_slots (W only decreases; checking W0 suffices)
    wmax = max((int(p["W0"].max()) if p["W0"].size else 0 for p in per),
               default=0)
    if wmax >= 2 ** 24:
        raise OverflowError(
            "pair wedge counts exceed f32 integer range (2^24); "
            "use the segment_sum FD body (use_pallas=False)")
    packs = [csr.pad_segments(p["wp"].astype(np.int64),
                              max(p["W0"].size, 1)) for p in per]
    R = max((pk.n_rows_pad for pk in packs), default=1) or 1
    K = max((pk.width for pk in packs), default=1) or 1
    if bucket:
        R = _bucket_pad(R, floor=8)
        K = _bucket_pad(K, floor=128)
    slot_e1 = np.full((n_parts, R, K), Emax, dtype=np.int32)
    slot_e2 = np.full((n_parts, R, K), Emax, dtype=np.int32)
    slot_valid = np.zeros((n_parts, R, K), dtype=bool)
    for i, (p, pk) in enumerate(zip(per, packs)):
        if p["wp"].size == 0:
            continue
        idx = np.maximum(pk.idx, 0)
        # local edge ids; -1 (edge of a later partition) → sentinel Emax
        e1 = np.where(p["we1"] < 0, Emax, p["we1"]).astype(np.int32)
        e2 = np.where(p["we2"] < 0, Emax, p["we2"]).astype(np.int32)
        r, c = pk.idx.shape
        slot_e1[i, :r, :c] = np.where(pk.valid, e1[idx], Emax)
        slot_e2[i, :r, :c] = np.where(pk.valid, e2[idx], Emax)
        slot_valid[i, :r, :c] = pk.valid
    return dict(slot_e1=slot_e1, slot_e2=slot_e2, slot_valid=slot_valid,
                slot_sizes=(R, K))


def pack_fd_partitions_tip_csr(
    wed: csr.Wedges, pair_bf0: np.ndarray, part: np.ndarray,
    sup_init: np.ndarray, n_parts: int, bucket: bool = False,
    stacked: bool = False,
) -> dict:
    """Tip counterpart of :func:`pack_fd_partitions_csr`.

    Tip FD needs only the pairs with BOTH endpoints inside the partition
    (vertices of later partitions never peel during FD_i and deltas onto
    them are discarded), so the stacked pair lists are disjoint across
    partitions — no duplication.  Pair butterfly counts are static (the
    V side is never peeled), so there is no per-partition wedge state:
    pad pairs carry bf=0 and are algebra-neutral.

    The kept pair lists are disjoint across partitions (each pair lives
    where both endpoints do), so they concatenate ragged with
    pre-globalized vertex ids — zero stacking padding.  Returns
    ``pa``/``pb`` (W,) globalized segment ids b·Emax+u, ``bf`` (W,)
    static pair butterflies (0 on the bucketed pad tail — algebra
    neutral), plus [n_parts, Emax] ``mine``/``sup0``/``gids``.

    ``stacked=True`` additionally emits the [n_parts, Lmax] blocks
    ``st_pa``/``st_pb``/``st_bf`` (partition-LOCAL vertex ids, bf=0 on
    padding) the fused ``fd_round_tip`` kernel consumes."""
    n = part.size
    pa_p = part[wed.pair_a] if wed.n_pairs else np.zeros(0, np.int32)
    pb_p = part[wed.pair_b] if wed.n_pairs else np.zeros(0, np.int32)
    per = []
    for i in range(n_parts):
        mine_idx = np.where(part == i)[0]
        loc = np.full(n, -1, dtype=np.int64)
        loc[mine_idx] = np.arange(mine_idx.size)
        keep = (pa_p == i) & (pb_p == i)
        per.append(dict(
            nodes=mine_idx,
            pa=loc[wed.pair_a[keep]], pb=loc[wed.pair_b[keep]],
            bf=pair_bf0[keep].astype(np.int32),
            sup0=sup_init[mine_idx],
        ))
    Emax = max((p["nodes"].size for p in per), default=1) or 1
    Wtot = int(sum(p["pa"].size for p in per))
    Wpad = max(Wtot, 1)
    if bucket:
        Emax = _bucket_pad(Emax, floor=8)
        Wpad = _bucket_pad(Wpad)
    pa = np.zeros(Wpad, dtype=np.int32)
    pb = np.zeros(Wpad, dtype=np.int32)
    bf = np.zeros(Wpad, dtype=np.int32)
    mine = np.zeros((n_parts, Emax), dtype=bool)
    sup0 = np.zeros((n_parts, Emax), dtype=np.int32)
    gids = np.zeros((n_parts, Emax), dtype=np.int32)
    pos = 0
    for i, p in enumerate(per):
        k = p["pa"].size
        pa[pos: pos + k] = p["pa"] + i * Emax
        pb[pos: pos + k] = p["pb"] + i * Emax
        bf[pos: pos + k] = p["bf"]
        pos += k
        mine[i, : p["nodes"].size] = True
        sup0[i, : p["nodes"].size] = p["sup0"]
        gids[i, : p["nodes"].size] = p["nodes"]
    packed = dict(pa=pa, pb=pb, bf=bf, mine=mine, sup0=sup0, gids=gids,
                  sizes=(Wpad, Emax))
    if stacked:
        Lmax = max((p["pa"].size for p in per), default=1) or 1
        if bucket:
                Lmax = _bucket_pad(Lmax, floor=8)
        st_pa = np.zeros((n_parts, Lmax), dtype=np.int32)
        st_pb = np.zeros((n_parts, Lmax), dtype=np.int32)
        st_bf = np.zeros((n_parts, Lmax), dtype=np.int32)
        for i, p in enumerate(per):
            k = p["pa"].size
            st_pa[i, :k] = p["pa"]
            st_pb[i, :k] = p["pb"]
            st_bf[i, :k] = p["bf"]
        packed.update(st_pa=st_pa, st_pb=st_pb, st_bf=st_bf)
    return packed

"""PBNG two-phased peeling (§3) — tip and wing decomposition in PyTorch.

Phase 1 (CD) peels every entity whose support lies in the current range
with one fully parallel masked update per round; Phase 2 (FD) peels each
partition to exact entity numbers with no communication.  Both phases
run the entity-agnostic core in ``core.peelspec``; this module only
builds the :class:`PeelSpec` of each entity universe.

Three engines, as in the JAX package, all giving the same θ:

* ``engine="dense"`` — supports re-counted with masked matrix products
  (``core.counting``, the paper's §5.1 batch re-count), or for tip
  updated incrementally from the static pair-butterfly matrix.  O(n²)
  memory, guarded by ``REPRO_DENSE_MAX_ELEMS``.  The default for tip.
* ``engine="beindex"`` — paper-faithful BE-Index twin/bloom bookkeeping
  (alg.4/alg.6), int32 ``index_add_`` in place of the paper's atomics.
  The default for wing.
* ``engine="csr"`` — the sparse wedge list (``core.csr``) with purely
  incremental int32 updates, bit-identical to the JAX package's csr
  engine for every FD driver (``device`` in LPT order, ``vmapped`` all
  partitions at once, ``host`` round by round).  Three switches select
  its kernels: ``fused`` runs each FD round of the device/vmapped
  drivers as one ``fd_round_wing``/``fd_round_tip`` call; ``use_pallas``
  (the JAX package's name, kept for parity) runs CD updates through
  ``support_update``/``wedge_count`` and, for the unfused vmapped wing
  FD, ``support_update`` inside the loop.

The dense and beindex engines peel their FD partitions from the host
(one device update and one support copy per round), as the JAX
package's do.  With the obs layer on, every FD driver also feeds the
run's timeline: the device-side loops through their ``*_rings`` twins
(drained by :func:`_drain_rings`), the host loops round by round.
Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``, where every kernel is replaced by its plain
version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import counting, csr
from .beindex import BEIndex, build_beindex
from .distributed import pack_fd_partitions_csr, pack_fd_partitions_tip_csr
from .graph import BipartiteGraph
from .peelspec import (
    PeelResult,
    PeelSpec,
    PeelStats,
    _bucket_pad,
    _fd_cascade,
    _fd_while_device,
    _fd_while_device_rings,
    _fd_while_fused,
    _fd_while_fused_rings,
    _fd_while_vmapped,
    _fd_while_vmapped_rings,
    _pad_zeros,
    decompose,
)
from .. import obs
from ..kernels import ops as kops
from ..kernels.ref import matmul_f32

__all__ = [
    "PeelStats",
    "PeelResult",
    "PeelSpec",
    "build_peel_spec",
    "bup_levels",
    "resolve_device",
    "tip_decomposition",
    "wing_decomposition",
    "wing_decomposition_bepc",
]

_I32 = torch.int32


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; refuses CUDA where there is no
    card instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


def _device_loop(mine, sup0, update, aux, ring_cap: int):
    """:func:`_fd_while_device`, or its ring twin where ``ring_cap`` > 0.
    Returns (theta, rounds, updates, rings or None)."""
    if ring_cap:
        return _fd_while_device_rings(mine, sup0, update, aux, ring_cap)
    return (*_fd_while_device(mine, sup0, update, aux), None)


def _vmapped_loop(mine, sup0, update, aux, ring_cap: int):
    """:func:`_fd_while_vmapped`, or its ring twin where ``ring_cap`` >
    0.  Returns (theta, rounds, updates, rings or None)."""
    if ring_cap:
        return _fd_while_vmapped_rings(mine, sup0, update, aux, ring_cap)
    return (*_fd_while_vmapped(mine, sup0, update, aux), None)


def _fused_loop(state0, round_fn, ring_cap: int):
    """:func:`_fd_while_fused`, or its ring twin where ``ring_cap`` > 0.
    Returns (state, rings or None)."""
    if ring_cap:
        return _fd_while_fused_rings(state0, round_fn, ring_cap)
    return _fd_while_fused(state0, round_fn), None


def _drain_rings(mode, parts, rounds, rings, cap, cumulative=False):
    """Hand one FD launch's counter rings to the active timeline
    collector (no-op when the obs layer is off)."""
    col = obs.active_collector()
    if col is not None:
        col.record_fd_rings(mode, parts, rounds, rings, cap,
                            cumulative_updates=cumulative)


def _host_recorder(part_i: int, nupd_now=None):
    """``(on_round, finish)`` for a host-driven cascade of partition
    ``part_i`` while a timeline collector is live, else ``(None, None)``:
    ``on_round(k, died, frontier)`` after every round, ``finish()`` once
    at the end hands the rows to the collector.  With ``nupd_now`` (the
    cascade's running update count) each round's update delta is
    recorded too."""
    col = obs.active_collector()
    if col is None:
        return None, None
    rows: list = []
    upds: list = [] if nupd_now is not None else None
    last = [0]

    def on_round(k, died, frontier):
        rows.append(dict(k=k, died=died, frontier=frontier))
        if upds is not None:
            n = nupd_now()
            upds.append(n - last[0])
            last[0] = n

    return on_round, lambda: col.record_fd_host(part_i, rows, updates=upds)


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.int64)


def _host_rint(x: torch.Tensor) -> np.ndarray:
    """Host int64 copy of a float tensor of exact integer counts."""
    return np.rint(x.cpu().numpy()).astype(np.int64)


def build_peel_spec(
    g: BipartiteGraph,
    kind: str,
    stats: PeelStats,
    side: str = "u",
    engine: str = "csr",
    batch_recount="adaptive",
    be: Optional[BEIndex] = None,
    fd_driver: str = "device",
    use_pallas: bool = False,
    fused: bool = False,
    sup0: Optional[np.ndarray] = None,
    wed: Optional[csr.Wedges] = None,
    device="cuda",
) -> PeelSpec:
    """Build the :class:`PeelSpec` of a ``(kind, engine)`` universe.

    Validates the engine/driver matrix as the JAX package does.  ``sup0``
    injects a precomputed ⋈init vector (int64, one entry per entity of
    ``kind``) — honored by both csr specs and the wing dense spec; the
    tip dense spec recounts regardless and the beindex spec counts from
    its index.  ``wed`` injects prebuilt wedge structures for the csr
    specs, ``be`` a prebuilt BE-Index for the beindex spec.  Injection
    never changes results."""
    if kind not in ("tip", "wing"):
        raise ValueError(kind)
    if kind == "tip":
        if engine not in ("dense", "csr"):
            raise ValueError(engine)
    elif engine not in ("beindex", "dense", "csr"):
        raise ValueError(engine)
    if fd_driver not in ("device", "host", "vmapped"):
        raise ValueError(fd_driver)
    if kind == "tip" and use_pallas and engine != "csr":
        raise ValueError("use_pallas applies to engine='csr' only")
    if fused and engine != "csr":
        raise ValueError("fused applies to engine='csr' only")
    if fused and fd_driver == "host":
        raise ValueError("fused requires fd_driver='device' or 'vmapped'")
    device = resolve_device(device)
    if kind == "tip":
        gg = g if side == "u" else g.transpose()
        if engine == "csr":
            return _tip_spec_csr(gg, stats, use_pallas, fused, sup0, wed,
                                 device)
        return _tip_spec_dense(gg, batch_recount, stats, device)
    if engine == "beindex":
        return _wing_spec_beindex(g, be, stats, device)
    if engine == "csr":
        return _wing_spec_csr(g, stats, use_pallas, fused, sup0, wed, device)
    return _wing_spec_dense(g, stats, sup0, device)


# =====================================================================
# Tip decomposition (vertex peeling)
# =====================================================================
def tip_decomposition(
    g: BipartiteGraph,
    side: str = "u",
    P: int = 16,
    batch_recount="adaptive",
    engine: str = "dense",
    fd_driver: str = "device",
    use_pallas: bool = False,
    fused: bool = False,
    sup0: Optional[np.ndarray] = None,
    device="cuda",
) -> PeelResult:
    """PBNG tip decomposition (§3.2) — θ per U (or V) vertex.

    ``engine="dense"`` (default) re-counts with masked matrix products;
    ``engine="csr"`` peels on the sparse wedge list with purely
    incremental pair updates — O(Σ deg²) memory, the only option once
    the n×n wedge matrix stops fitting.

    ``fd_driver`` (csr only): ``"device"`` peels partitions one at a time
    in LPT order, ``"vmapped"`` all at once in one batched loop,
    ``"host"`` round by round from a Python loop.  ``fused`` (csr,
    device/vmapped) runs each FD round as one ``fd_round_tip`` call;
    ``use_pallas`` (csr) runs the CD deltas through the ``wedge_count``
    kernel.

    ``batch_recount`` (dense only), the §5.1 batch knob: ``"adaptive"``
    (default) re-counts all survivors in a CD round iff the frontier's
    wedge workload exceeds the counting bound Σ_e min(d_u, d_v), and
    otherwise applies incremental pairwise updates; ``True`` always
    re-counts, ``False`` never does.  Every combination gives the same
    θ."""
    stats = PeelStats(engine=engine,
                      fd_driver=fd_driver if engine == "csr" else "host",
                      side=side)
    spec = build_peel_spec(
        g, "tip", stats, side=side, engine=engine,
        batch_recount=batch_recount, fd_driver=fd_driver,
        use_pallas=use_pallas, fused=fused, sup0=sup0, device=device)
    return decompose(spec, P, stats, fd_driver=fd_driver)


def _dense_guard(n_u: int, n_v: int) -> None:
    """Refuse dense-engine allocations that cannot fit.

    The dense engine materializes an n_u×n_v adjacency and an n_u×n_u
    wedge matrix; past ``REPRO_DENSE_MAX_ELEMS`` elements (default 2²⁸,
    1 GiB of f32) it fails fast with a pointer at the csr engine."""
    limit = counting._dense_limit()
    need = max(n_u * n_v, n_u * n_u)
    if need > limit:
        raise MemoryError(
            f"dense engine needs a {n_u}x{max(n_v, n_u)} matrix "
            f"({need} > REPRO_DENSE_MAX_ELEMS={limit}); "
            "use engine='csr' for graphs this large"
        )


def _tip_recount(A: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    return counting.vertex_butterflies(A * alive[:, None].to(A.dtype))


def _tip_fd_delta(pair_bf: torch.Tensor, peel: torch.Tensor) -> torch.Tensor:
    """Δ⋈_u' = Σ_{u peeled} (butterflies shared by pair (u', u))."""
    return matmul_f32(pair_bf, peel.to(pair_bf.dtype))


def _pair_butterflies(A: torch.Tensor) -> torch.Tensor:
    """The static pair-butterfly matrix C(W, 2) with a zero diagonal,
    formed on the host as the JAX package forms it (W copied out,
    ``fill_diagonal``, C(W, 2) in f32) and sent back to A's device."""
    W = counting.wedge_counts(A).cpu().numpy()
    np.fill_diagonal(W, 0)
    return _t(W * (W - 1) / 2, A.device)


def _tip_spec_dense(gg: BipartiteGraph, batch_recount, stats: PeelStats,
                    device) -> PeelSpec:
    """Dense-engine tip spec: masked-product batch re-counts (or §5.1
    adaptive incremental pairwise updates) as the CD step, the static
    pairwise-butterfly cascade as the FD rule."""
    n = gg.n_u
    _dense_guard(gg.n_u, gg.n_v)
    A = _t(gg.adjacency(), device)
    # the paper's proxy, kept f32 as the JAX package keeps it: range
    # selection sums these weights in f32
    wedge_w = counting.vertex_wedge_workload(A).cpu().numpy()

    support = counting.vertex_butterflies(A)
    counting.assert_exact(support)
    sup0 = _host_rint(support)

    # counting-work bound ∧cnt (alg.1 complexity) for the adaptive rule
    du, dv = gg.degrees()
    cnt_bound = float(
        np.minimum(du[gg.edges[:, 0]], dv[gg.edges[:, 1]]).sum())

    # static pairwise butterfly matrix for the incremental path
    pair_bf_full = _pair_butterflies(A) if batch_recount is not True else None

    state = dict(alive=torch.ones((n,), dtype=torch.bool, device=device),
                 support=support)

    def cd_step(active: np.ndarray) -> np.ndarray:
        state["alive"] = state["alive"] & _t(~active, device)
        if batch_recount is True:
            use_recount = True
        elif batch_recount is False:
            use_recount = False
        else:  # adaptive §5.1: peel-work vs recount-work
            use_recount = float(wedge_w[active].sum()) > cnt_bound
        if use_recount:
            state["support"] = _tip_recount(A, state["alive"])
            stats.recounts += 1
        else:
            state["support"] = state["support"] - _tip_fd_delta(
                pair_bf_full, _t(active, device))
            stats.updates += int(active.sum()) * int(state["alive"].sum())
        return _host_rint(state["support"])

    def fd_partition(i, part, sup_init, theta, fd_driver):
        rows = np.where(part == i)[0]
        if rows.size == 0:
            return 0, 0, 0
        return _tip_fd_peel(A, rows, sup_init[rows], theta, int(i)), 0, 0

    return PeelSpec(
        kind="tip", n=n, sup0=sup0,
        workload=lambda s: wedge_w,
        est=lambda s: wedge_w,
        cd_step=cd_step,
        fd_partition=fd_partition,
    )


def _tip_fd_peel(A: torch.Tensor, rows: np.ndarray, sup0: np.ndarray,
                 theta: np.ndarray, part_i: int = 0) -> int:
    """Sequential (level-synchronous) bottom-up peel of one partition.

    Exact because a butterfly has exactly two U-endpoints and V is never
    peeled: pairwise counts within the partition are static."""
    dev = A.device
    pair_bf = _pair_butterflies(A[_t(rows, dev)])
    alive = np.ones(rows.size, dtype=bool)
    support = sup0.astype(np.float64).copy()
    on_round, finish = _host_recorder(part_i)
    k = 0
    rounds = 0
    while alive.any():
        k = max(k, int(support[alive].min()))
        while True:
            S = alive & (support <= k)
            if not S.any():
                break
            theta[rows[S]] = k
            alive &= ~S
            support -= _tip_fd_delta(pair_bf, _t(S, dev)).cpu().numpy()
            rounds += 1
            if on_round is not None:
                on_round(k=k, died=int(S.sum()), frontier=int(alive.sum()))
    if finish is not None:
        finish()
    return rounds


def _tip_spec_csr(gg, stats, use_pallas, fused, sup0, wed, device) -> PeelSpec:
    """csr tip spec: static pair-butterfly deltas for CD and FD."""
    n = gg.n_u
    if wed is None:
        wed = csr.build_wedges(gg)
    pa = _t(wed.pair_a, device)
    pb = _t(wed.pair_b, device)
    pair_bf0 = wed.pair_butterflies0()
    pbf = _t(pair_bf0.astype(np.int32), device)
    wu, _ = csr.wedge_workload(gg)
    wedge_w = wu.astype(np.float64)

    sup_np = (csr.vertex_butterflies_csr(wed) if sup0 is None
              else np.asarray(sup0, dtype=np.int64))
    if sup_np.size and int(sup_np.max()) > 2 ** 31 - 1:
        raise OverflowError("tip supports exceed int32; shard the graph")
    state = dict(support=_t(sup_np.astype(np.int32), device))

    if use_pallas:
        slots = csr.pack_tip_slots(wed, pair_bf0, sup=sup_np)
        slot_partner = _t(slots["partner"], device)
        slot_bf = _t(slots["bf"], device)

    def cd_step(active: np.ndarray) -> np.ndarray:
        act = _t(active, device)
        if use_pallas:
            delta = csr.tip_delta_slots(act, slot_partner, slot_bf, n)
        else:
            delta = csr.tip_delta_csr(act, pa, pb, pbf, n)
        state["support"] = state["support"] - delta
        if wed.n_pairs:
            stats.updates += int((act[pa] | act[pb]).sum())
        return _host(state["support"])

    # the fused device driver packs the partition stack once (part and
    # sup_init are fixed for the whole FD phase) and peels each
    # partition as a B = 1 slice of it
    fused_pack: dict = {}

    def fd_partition(i, part, sup_init, theta, fd_driver):
        if fused and fd_driver == "device":
            if "p" not in fused_pack:
                fused_pack["p"] = pack_fd_partitions_tip_csr(
                    wed, pair_bf0, part, sup_init,
                    int(part.max()) + 1 if part.size else 0,
                    bucket=True, stacked=True)
            p = fused_pack["p"]
            cap = obs.fd_ring_cap()
            theta_st, rounds, rings = _fd_tip_fused(
                *(_t(p[key][i:i + 1], device)
                  for key in ("st_pa", "st_pb", "st_bf", "mine", "sup0")),
                ring_cap=cap)
            if rings is not None:
                _drain_rings("fused", [i], [int(rounds[0])], rings, cap,
                             cumulative=True)
            mm = p["mine"][i]
            theta[p["gids"][i][mm]] = _host(theta_st[0])[mm]
            return int(rounds[0]), 0, 0
        rounds = _tip_fd_csr(wed, pair_bf0, part, i, sup_init, theta,
                             fd_driver, device)
        return rounds, 0, 0

    def fd_vmapped(part, sup_init, theta, n_parts):
        return _tip_fd_vmapped_csr(wed, pair_bf0, part, sup_init, theta,
                                   n_parts, fused, device), 0

    return PeelSpec(
        kind="tip", n=n, sup0=sup_np,
        workload=lambda s: wedge_w,
        est=lambda s: wedge_w,
        cd_step=cd_step,
        fd_partition=fd_partition,
        fd_vmapped=fd_vmapped,
    )


def _fused_state(mine: torch.Tensor, sup0: torch.Tensor, n_scalars: int):
    """The fused rounds' (B, E) state sup/alive/theta plus ``n_scalars``
    (B, 1) counters, all fresh tensors (the rounds update them in
    place)."""
    B, E = sup0.shape
    dev = sup0.device
    return (sup0.to(_I32, copy=True), mine.to(_I32, copy=True),
            torch.zeros((B, E), dtype=_I32, device=dev),
            *(torch.zeros((B, 1), dtype=_I32, device=dev)
              for _ in range(n_scalars)))


def _fd_tip_fused(st_pa, st_pb, st_bf, mine, sup0, ring_cap: int = 0):
    """Tip FD of B stacked partitions, one ``fd_round_tip`` per round
    over the (B, L) partition-local pair lists.  Returns (theta (B, E),
    rounds (B,), rings or None)."""
    def round_fn(sup, alive, theta, k, rounds):
        return kops.fd_round_tip(sup, alive, theta, k, rounds,
                                 st_pa, st_pb, st_bf)

    out, rings = _fused_loop(_fused_state(mine, sup0, 2), round_fn,
                             ring_cap)
    return out[2], out[4][:, 0], rings


def _fd_tip_device(mine, sup0, pa, pb, pbf, n: int, ring_cap: int = 0):
    """One tip partition's cascade (unfused), over (n,) global ids.
    Returns (theta, rounds, updates, rings or None)."""
    zero = torch.zeros((), dtype=_I32, device=sup0.device)

    def update(S, aux):
        return csr.tip_delta_csr(S, pa, pb, pbf, n), aux, zero

    return _device_loop(mine, sup0, update, None, ring_cap)


def _fd_tip_vmapped(pag, pbg, bff, mine, sup0, ring_cap: int = 0):
    """All tip partitions in one batched loop (unfused):
    :func:`csr.tip_delta_csr` over the ragged-concatenated pair lists
    with pre-globalized ids (partition b's vertex u → b·Emax+u).
    Returns (theta, rounds, updates, rings or None)."""
    B, Emax = mine.shape
    zero = torch.zeros((), dtype=_I32, device=sup0.device)

    def update(S, aux):
        Sf = S.reshape(-1)
        loss = (csr._seg(torch.where(Sf[pbg], bff, 0), pag, B * Emax)
                + csr._seg(torch.where(Sf[pag], bff, 0), pbg, B * Emax))
        return loss.reshape(B, Emax), aux, zero

    return _vmapped_loop(mine, sup0, update, None, ring_cap)


def _tip_fd_csr(wed, pair_bf0, part, i, sup_init, theta, fd_driver,
                device) -> int:
    """Bottom-up peel of tip partition i on its pair list (pairs with
    both endpoints inside the partition; deltas to later partitions are
    discarded anyway).  ``device``: one batched loop; ``host``: one
    update and one support copy per round."""
    mine = part == i
    if not mine.any():
        return 0
    n = part.size
    mask = (mine[wed.pair_a] & mine[wed.pair_b] if wed.n_pairs
            else np.zeros(0, bool))
    support0 = np.zeros(n, dtype=np.int64)
    support0[mine] = sup_init[mine]

    if fd_driver == "device":
        size = _bucket_pad(int(mask.sum()))
        cap = obs.fd_ring_cap()
        theta_d, rounds, _, rings = _fd_tip_device(
            _t(mine, device), _t(support0.astype(np.int32), device),
            _t(_pad_zeros(wed.pair_a[mask], size), device),
            _t(_pad_zeros(wed.pair_b[mask], size), device),
            _t(_pad_zeros(pair_bf0[mask].astype(np.int32), size), device),
            n, ring_cap=cap)
        if rings is not None:
            _drain_rings("device", [i], [int(rounds)], rings, cap)
        theta[mine] = _host(theta_d)[mine]
        return int(rounds)

    pa = _t(wed.pair_a[mask], device)
    pb = _t(wed.pair_b[mask], device)
    pbf = _t(pair_bf0[mask].astype(np.int32), device)

    def peel(S, sup):
        return sup - _host(csr.tip_delta_csr(_t(S, device), pa, pb, pbf, n))

    on_round, finish = _host_recorder(i)
    rounds = _fd_cascade(mine, support0, theta, peel, on_round=on_round)
    if finish is not None:
        finish()
    return rounds


def _tip_fd_vmapped_csr(wed, pair_bf0, part, sup_init, theta, n_parts,
                        fused, device) -> np.ndarray:
    """Tip Phase 2 of all partitions in one batched loop; writes θ in
    place and returns the (B,) per-partition round counts."""
    if n_parts == 0:
        return np.zeros(0, dtype=np.int64)
    packed = pack_fd_partitions_tip_csr(
        wed, pair_bf0, part, sup_init, n_parts, bucket=True, stacked=fused)
    cap = obs.fd_ring_cap()
    if fused:
        theta_st, rounds, rings = _fd_tip_fused(
            *(_t(packed[key], device)
              for key in ("st_pa", "st_pb", "st_bf", "mine", "sup0")),
            ring_cap=cap)
    else:
        theta_st, rounds, _, rings = _fd_tip_vmapped(
            *(_t(packed[key], device)
              for key in ("pa", "pb", "bf", "mine", "sup0")), ring_cap=cap)
    mm = packed["mine"]
    theta[packed["gids"][mm]] = _host(theta_st)[mm]
    rounds_np = _host(rounds)
    if rings is not None:
        _drain_rings("fused" if fused else "vmapped",
                     list(range(rounds_np.size)), rounds_np.tolist(), rings,
                     cap, cumulative=fused)
    return rounds_np


# =====================================================================
# Wing decomposition (edge peeling)
# =====================================================================
def wing_decomposition(
    g: BipartiteGraph,
    P: int = 16,
    engine: str = "beindex",
    be: Optional[BEIndex] = None,
    fd_driver: str = "device",
    use_pallas: bool = False,
    fused: bool = False,
    sup0: Optional[np.ndarray] = None,
    device="cuda",
) -> PeelResult:
    """PBNG wing decomposition (§3.3) — θ per edge.

    ``engine`` ∈ {"beindex" (default), "dense", "csr"}: BE-Index
    incremental updates (``be`` injects a prebuilt index), masked-product
    re-counts, or sparse wedge-list incremental updates (the scalable
    path).  ``fd_driver`` as for :func:`tip_decomposition` (csr only).
    ``fused`` (csr, device/vmapped) runs each FD round as one
    ``fd_round_wing`` call; ``use_pallas`` (csr) runs CD updates through
    the ``support_update`` kernel and, with the unfused vmapped driver,
    FD updates too.  Every combination gives the same θ."""
    stats = PeelStats(engine=engine,
                      fd_driver=fd_driver if engine == "csr" else "host")
    spec = build_peel_spec(
        g, "wing", stats, engine=engine, be=be, fd_driver=fd_driver,
        use_pallas=use_pallas, fused=fused, sup0=sup0, device=device)
    return decompose(spec, P, stats, fd_driver=fd_driver)


def _wing_recount(shape, edges: torch.Tensor,
                  alive_e: torch.Tensor) -> torch.Tensor:
    A = counting.masked_adjacency(shape, edges, alive_e)
    return counting.edge_butterflies(A, edges)


def _wing_links(be: BEIndex, device):
    return (_t(be.link_edge, device), _t(be.link_twin, device),
            _t(be.link_bloom, device))


def _wing_update(peeled_e, alive_link, k_alive, support, le, lt, lb,
                 nb: int, m: int):
    """Batched BE-Index support update (alg.6 exact semantics).

    Bloom bookkeeping: a twin *pair* dies when either member is peeled.
    Dying-pair survivors (widows) lose every butterfly they had in the
    bloom (k_alive − 1); edges of surviving pairs lose one butterfly per
    dying pair (c_B).  int32 ``index_add_`` replaces the paper's
    atomics.  Returns (alive_link, k_alive, support, update count)."""
    pe = peeled_e[le]
    pt = peeled_e[lt]
    pair_dies = alive_link & (pe | pt)
    canon = le < lt
    c = csr._seg((pair_dies & canon).to(_I32), lb, nb)
    widow = alive_link & ~pe & pt
    surv = alive_link & ~pair_dies
    c_l = c[lb]
    contrib = (torch.where(widow, k_alive[lb] - 1, 0)
               + torch.where(surv, c_l, 0))
    loss = csr._seg(contrib, le, m)
    n_updates = widow.sum() + (surv & (c_l > 0)).sum()
    return alive_link & ~pair_dies, k_alive - c, support - loss, n_updates


def _wing_spec_beindex(g: BipartiteGraph, be: Optional[BEIndex],
                       stats: PeelStats, device) -> PeelSpec:
    """BE-Index wing spec: alg.4/6 widow/survivor updates as the CD
    step, link-packed sub-indices (alg.5) as the FD rule."""
    m = g.m
    if be is None:
        be = build_beindex(g)
    le, lt, lb = _wing_links(be, device)
    nb = max(be.nb, 1)
    sup0 = be.edge_support(m)
    state = dict(
        alive_link=torch.ones((be.n_links,), dtype=torch.bool, device=device),
        k_alive=_t(be.bloom_k.astype(np.int32), device),
        support=_t(sup0.astype(np.int32), device),
    )

    def cd_step(active: np.ndarray) -> np.ndarray:
        state["alive_link"], state["k_alive"], state["support"], nupd = (
            _wing_update(_t(active, device), state["alive_link"],
                         state["k_alive"], state["support"], le, lt, lb,
                         nb, m))
        stats.updates += int(nupd)
        return _host(state["support"])

    def fd_partition(i, part, sup_init, theta, fd_driver):
        rounds, nupd = _wing_fd_beindex(g, be, part, i, sup_init, theta,
                                        device)
        return rounds, nupd, 0

    workload, est = _wing_workload_est()
    return PeelSpec(
        kind="wing", n=m, sup0=sup0, workload=workload, est=est,
        cd_step=cd_step, fd_partition=fd_partition,
    )


def _wing_fd_beindex(g: BipartiteGraph, be: BEIndex, part: np.ndarray,
                     i: int, sup_init: np.ndarray, theta: np.ndarray,
                     device) -> Tuple[int, int]:
    """FD for partition i, BE-Index engine (alg.5 semantics).

    Sub-index = links whose pair touches partition i with both members in
    partitions ≥ i; bloom numbers initialised to the count of pairs with
    both members ≥ i (alg.5 lines 21-24)."""
    ple = part[be.link_edge]
    plt_ = part[be.link_twin]
    pair_ge = (ple >= i) & (plt_ >= i)
    keep = pair_ge & (np.minimum(ple, plt_) == i)  # pairs that can die in FD_i
    if not keep.any():
        return 0, 0
    canon_full = be.link_edge < be.link_twin
    # bloom number in I_i: pairs with both members ≥ i
    k_init = np.bincount(be.link_bloom[pair_ge & canon_full],
                         minlength=be.nb)
    le = _t(be.link_edge[keep], device)
    lt = _t(be.link_twin[keep], device)
    lb = _t(be.link_bloom[keep], device)
    nb = max(be.nb, 1)
    m = g.m
    mine = part == i
    support_full = np.zeros(m, dtype=np.int64)
    support_full[mine] = sup_init[mine]
    st = dict(alive_link=torch.ones((int(keep.sum()),), dtype=torch.bool,
                                    device=device),
              k_alive=_t(k_init.astype(np.int32), device),
              support=_t(support_full.astype(np.int32), device), nupd=0)

    def peel(S, sup):
        st["alive_link"], st["k_alive"], st["support"], nu = _wing_update(
            _t(S, device), st["alive_link"], st["k_alive"], st["support"],
            le, lt, lb, nb, m)
        st["nupd"] += int(nu)
        return _host(st["support"])

    on_round, finish = _host_recorder(i, lambda: st["nupd"])
    rounds = _fd_cascade(mine, support_full.copy(), theta, peel,
                         on_round=on_round)
    if finish is not None:
        finish()
    return rounds, st["nupd"]


def _wing_spec_dense(g: BipartiteGraph, stats: PeelStats,
                     sup0: Optional[np.ndarray], device) -> PeelSpec:
    """Dense wing spec: masked-product batch re-counts for both phases."""
    m = g.m
    _dense_guard(g.n_u, g.n_v)
    edges = _t(g.edges.astype(np.int64), device)
    shape = (g.n_u, g.n_v)
    if sup0 is None:
        support = _wing_recount(shape, edges,
                                torch.ones((m,), dtype=torch.bool,
                                           device=device))
        counting.assert_exact(support)
        sup0 = _host_rint(support)
    else:
        sup0 = np.asarray(sup0, dtype=np.int64)
    state = dict(alive=np.ones(m, dtype=bool))

    def cd_step(active: np.ndarray) -> np.ndarray:
        state["alive"] &= ~active
        sup = _wing_recount(shape, edges, _t(state["alive"], device))
        stats.recounts += 1
        return _host_rint(sup)

    def fd_partition(i, part, sup_init, theta, fd_driver):
        rounds, nrec = _wing_fd_dense(g, part, i, sup_init, theta, device)
        return rounds, 0, nrec

    workload, est = _wing_workload_est()
    return PeelSpec(
        kind="wing", n=m, sup0=sup0, workload=workload, est=est,
        cd_step=cd_step, fd_partition=fd_partition,
    )


def _wing_fd_dense(g: BipartiteGraph, part: np.ndarray, i: int,
                   sup_init: np.ndarray, theta: np.ndarray,
                   device) -> Tuple[int, int]:
    """FD for partition i, dense engine: peel E_i inside the ≥i subgraph,
    re-counting supports on the masked adjacency each round."""
    sel = np.where(part >= i)[0]
    mine = part[sel] == i
    if not mine.any():
        return 0, 0
    sub_edges = _t(g.edges[sel].astype(np.int64), device)
    shape = (g.n_u, g.n_v)
    alive = np.ones(sel.size, dtype=bool)
    support = sup_init[sel].astype(np.int64).copy()
    on_round, finish = _host_recorder(int(i))
    k = 0
    rounds = 0
    while (alive & mine).any():
        k = max(k, int(support[alive & mine].min()))
        while True:
            S = alive & mine & (support <= k)
            if not S.any():
                break
            theta[sel[S]] = k
            alive &= ~S
            support = _host_rint(
                _wing_recount(shape, sub_edges, _t(alive, device)))
            rounds += 1
            if on_round is not None:
                on_round(k=k, died=int(S.sum()),
                         frontier=int((alive & mine).sum()))
    if finish is not None:
        finish()
    return rounds, rounds


def _wing_workload_est():
    """Wing's range/estimate weights: workload proxy for edges = current
    support (§3.3.2); partition estimates read the same supports."""
    return (lambda s: np.maximum(s, 1), lambda s: s)


def _w_rows(p: dict, n_parts: int) -> np.ndarray:
    """Per slot row alive wedge counts (B, R) of a slotted wing pack."""
    R, _ = p["slot_sizes"]
    W_rows = np.zeros((n_parts, R), dtype=np.int32)
    w = min(R, p["W0"].shape[1])
    W_rows[:, :w] = p["W0"][:, :w]
    return W_rows


def _wing_spec_csr(g, stats, use_pallas, fused, sup0, wed, device) -> PeelSpec:
    """csr wing spec: incremental wedge-list widow/survivor updates as
    the CD step (optionally through ``support_update`` on the pairs-major
    slot layout), touching-wedge lists as the FD rule."""
    m = g.m
    if wed is None:
        wed = csr.build_wedges(g)
    we1 = _t(wed.wedge_e1, device)
    we2 = _t(wed.wedge_e2, device)
    wpj = _t(wed.wedge_pair, device)
    n_pairs = wed.n_pairs
    sup0 = (csr.edge_butterflies0(wed) if sup0 is None
            else np.asarray(sup0, dtype=np.int64))
    if sup0.size and int(sup0.max()) > 2 ** 31 - 1:
        raise OverflowError("wing supports exceed int32; shard the graph")
    state = dict(
        alive_w=torch.ones((wed.n_wedges,), dtype=torch.bool, device=device),
        Wp=csr.pair_wedge_counts(wed, device=device),
        support=_t(sup0.astype(np.int32), device),
    )
    if use_pallas:
        slots = csr.pack_update_slots(wed)
        state["alive_slots"] = _t(slots["valid"], device)
        slot_e1 = _t(slots["e1"], device)
        slot_e2 = _t(slots["e2"], device)

    def cd_step(active: np.ndarray) -> np.ndarray:
        act = _t(active, device)
        if use_pallas:
            state["alive_slots"], state["Wp"], state["support"], nupd = (
                csr.wing_update_slots(
                    act, state["alive_slots"], state["Wp"], state["support"],
                    slot_e1, slot_e2, n_pairs, m))
        else:
            state["alive_w"], state["Wp"], state["support"], nupd = (
                csr.wing_update_csr(
                    act, state["alive_w"], state["Wp"], state["support"],
                    we1, we2, wpj, n_pairs, m))
        stats.updates += int(nupd)
        return _host(state["support"])

    fused_pack: dict = {}

    def fd_partition(i, part, sup_init, theta, fd_driver):
        if fused and fd_driver == "device":
            if "p" not in fused_pack:
                n_parts = int(part.max()) + 1 if part.size else 0
                p = pack_fd_partitions_csr(
                    wed, part, sup_init, n_parts, bucket=True, slots=True)
                p["W_rows"] = _w_rows(p, n_parts)
                fused_pack["p"] = p
            p = fused_pack["p"]
            cap = obs.fd_ring_cap()
            theta_st, rounds, nupd, rings = _fd_wing_fused(
                *(_t(p[key][i:i + 1], device)
                  for key in ("slot_e1", "slot_e2", "slot_valid", "W_rows",
                              "mine", "sup0")), ring_cap=cap)
            if rings is not None:
                _drain_rings("fused", [i], [int(rounds[0])], rings, cap,
                             cumulative=True)
            mm = p["mine"][i]
            theta[p["gids"][i][mm]] = _host(theta_st[0])[mm]
            return int(rounds[0]), int(nupd), 0
        rounds, nupd = _wing_fd_csr(wed, part, i, sup_init, theta,
                                    fd_driver, device)
        return rounds, nupd, 0

    def fd_vmapped(part, sup_init, theta, n_parts):
        return _wing_fd_vmapped_csr(wed, part, sup_init, theta, n_parts,
                                    use_pallas, fused, device)

    workload, est = _wing_workload_est()
    return PeelSpec(
        kind="wing", n=m, sup0=sup0, workload=workload, est=est,
        cd_step=cd_step, fd_partition=fd_partition, fd_vmapped=fd_vmapped,
    )


def _fd_wing_fused(slot_e1, slot_e2, valid0, W0, mine, sup0,
                   ring_cap: int = 0):
    """Wing FD of B stacked partitions, one ``fd_round_wing`` per round
    over the (B, R, K) pairs-major slots.  Returns (theta (B, E), rounds
    (B,), update count, rings or None)."""
    state0 = (*_fused_state(mine, sup0, 3), valid0.to(_I32, copy=True),
              W0.to(torch.float32, copy=True))

    def round_fn(sup, alive, theta, k, rounds, nupd, aslot, W):
        return kops.fd_round_wing(sup, alive, theta, k, rounds, nupd, aslot,
                                  W, slot_e1, slot_e2)

    out, rings = _fused_loop(state0, round_fn, ring_cap)
    return out[2], out[4][:, 0], out[5].sum(), rings


def _fd_wing_device(mine, sup0, alive_w0, W0, we1, we2, wp, n_pairs: int,
                    m: int, ring_cap: int = 0):
    """One wing partition's cascade (unfused), over (m,) global ids.
    Returns (theta, rounds, updates, rings or None)."""
    def update(S, aux):
        alive_w, W = aux
        alive_w, W, loss, nu = csr.wing_loss_csr(
            S, alive_w, W, we1, we2, wp, n_pairs, m)
        return loss, (alive_w, W), nu

    return _device_loop(mine, sup0, update, (alive_w0, W0), ring_cap)


def _fd_wing_vmapped(e1g, e2g, wpg, alive0, W0, mine, sup0, n_pairs: int,
                     ring_cap: int = 0):
    """All wing partitions in one batched loop (unfused):
    :func:`csr.wing_loss_csr` over the ragged-concatenated wedge lists
    with pre-globalized ids (partition b's edge e → b·(Emax+1)+e, whose
    column Emax is b's never-peeled sentinel).  Returns (theta, rounds,
    updates, rings or None)."""
    B, Emax = mine.shape
    nseg = B * (Emax + 1)

    def update(S, aux):
        alive_w, W = aux
        S_pad = torch.cat([S, S.new_zeros((B, 1))], dim=1).reshape(-1)
        alive_w, W, loss, nu = csr.wing_loss_csr(
            S_pad, alive_w, W, e1g, e2g, wpg, n_pairs, nseg)
        return loss.reshape(B, Emax + 1)[:, :Emax], (alive_w, W), nu

    return _vmapped_loop(mine, sup0, update, (alive0, W0), ring_cap)


def _fd_wing_vmapped_pallas(slot_e1, slot_e2, valid0, W0, mine, sup0,
                            ring_cap: int = 0):
    """All wing partitions in one batched loop with the ``support_update``
    kernel inside: the stacked slot blocks flatten to one (B·R, K)
    matrix, so each round is one kernel launch covering every partition;
    only the loss scatter stays an ``index_add_``.  Returns (theta,
    rounds, updates, rings or None)."""
    B, Emax = mine.shape
    _, R, K = slot_e1.shape
    nseg = B * (Emax + 1)
    off = (torch.arange(B, dtype=_I32, device=sup0.device)
           * (Emax + 1))[:, None, None]
    e1g = (slot_e1 + off).reshape(B * R, K)
    e2g = (slot_e2 + off).reshape(B * R, K)

    def update(S, aux):
        alive_slots, W = aux
        S_pad = torch.cat([S, S.new_zeros((B, 1))], dim=1).reshape(-1)
        alive_slots, c_row, loss, nu = csr.wing_loss_slots(
            S_pad, alive_slots, W, e1g, e2g, nseg)
        return (loss.reshape(B, Emax + 1)[:, :Emax], (alive_slots, W - c_row),
                nu)

    return _vmapped_loop(mine, sup0, update,
                         (valid0.reshape(B * R, K), W0.reshape(B * R)),
                         ring_cap)


def _wing_fd_csr(wed, part, i, sup_init, theta, fd_driver,
                 device) -> Tuple[int, int]:
    """FD for wing partition i.  W_p counts all wedges of the ≥i induced
    subgraph, but the wedge list carries only the wedges touching
    partition i (the others never die during FD_i, and their survivor
    charges land on later-partition edges whose deltas are discarded)."""
    mine = part == i
    if not mine.any():
        return 0, 0
    m = part.size
    n_pairs = wed.n_pairs
    if wed.n_wedges:
        p1 = part[wed.wedge_e1]
        p2 = part[wed.wedge_e2]
        keep_ge = (p1 >= i) & (p2 >= i)
        keep = keep_ge & (np.minimum(p1, p2) == i)
    else:
        keep_ge = keep = np.zeros(0, bool)
    Wp = _t(np.bincount(wed.wedge_pair[keep_ge],
                        minlength=max(n_pairs, 1)).astype(np.int32), device)
    support_full = np.zeros(m, dtype=np.int64)
    support_full[mine] = sup_init[mine]

    if fd_driver == "device":
        n_kept = int(keep.sum())
        size = _bucket_pad(n_kept)
        alive_w = np.zeros(size, dtype=bool)
        alive_w[:n_kept] = True
        cap = obs.fd_ring_cap()
        theta_d, rounds, nupd, rings = _fd_wing_device(
            _t(mine, device), _t(support_full.astype(np.int32), device),
            _t(alive_w, device), Wp,
            _t(_pad_zeros(wed.wedge_e1[keep], size), device),
            _t(_pad_zeros(wed.wedge_e2[keep], size), device),
            _t(_pad_zeros(wed.wedge_pair[keep], size), device),
            n_pairs, m, ring_cap=cap)
        if rings is not None:
            _drain_rings("device", [i], [int(rounds)], rings, cap)
        theta[mine] = _host(theta_d)[mine]
        return int(rounds), int(nupd)

    kwe1 = _t(wed.wedge_e1[keep], device)
    kwe2 = _t(wed.wedge_e2[keep], device)
    kwp = _t(wed.wedge_pair[keep], device)
    alive_w = torch.ones((int(keep.sum()),), dtype=torch.bool, device=device)
    support = _t(support_full.astype(np.int32), device)
    nupd = 0

    def peel(S, sup):
        nonlocal alive_w, Wp, support, nupd
        alive_w, Wp, support, nu = csr.wing_update_csr(
            _t(S, device), alive_w, Wp, support, kwe1, kwe2, kwp, n_pairs, m)
        nupd += int(nu)
        return _host(support)

    on_round, finish = _host_recorder(i, lambda: nupd)
    rounds = _fd_cascade(mine, support_full, theta, peel, on_round=on_round)
    if finish is not None:
        finish()
    return rounds, nupd


def _wing_fd_vmapped_csr(wed, part, sup_init, theta, n_parts, use_pallas,
                         fused, device) -> Tuple[np.ndarray, int]:
    """Wing Phase 2 of all partitions in one batched loop: flat wedge
    lists (unfused), the stacked slot layout with ``support_update``
    (``use_pallas``) or with ``fd_round_wing`` (``fused``).  Writes θ in
    place; returns (rounds (B,), update count)."""
    if n_parts == 0:
        return np.zeros(0, dtype=np.int64), 0
    slotted = use_pallas or fused
    packed = pack_fd_partitions_csr(
        wed, part, sup_init, n_parts, bucket=True,
        flat=not slotted, slots=slotted)
    cap = obs.fd_ring_cap()
    if slotted:
        body = _fd_wing_fused if fused else _fd_wing_vmapped_pallas
        theta_st, rounds, nupd, rings = body(
            _t(packed["slot_e1"], device), _t(packed["slot_e2"], device),
            _t(packed["slot_valid"], device),
            _t(_w_rows(packed, n_parts), device),
            _t(packed["mine"], device), _t(packed["sup0"], device),
            ring_cap=cap)
    else:
        theta_st, rounds, nupd, rings = _fd_wing_vmapped(
            *(_t(packed[key], device)
              for key in ("flat_we1", "flat_we2", "flat_wp", "flat_alive0",
                          "flat_W0", "mine", "sup0")),
            n_pairs=int(packed["flat_W0"].shape[0]), ring_cap=cap)
    mm = packed["mine"]
    theta[packed["gids"][mm]] = _host(theta_st)[mm]
    rounds_np = _host(rounds)
    if rings is not None:
        _drain_rings("fused" if fused else "vmapped",
                     list(range(rounds_np.size)), rounds_np.tolist(), rings,
                     cap, cumulative=fused)
    return rounds_np, int(nupd)


# =====================================================================
# Baseline: level-synchronous bottom-up peeling round count
# =====================================================================
def bup_levels(theta: np.ndarray) -> int:
    """Number of peeling iterations a level-by-level parallel BUP
    (ParButterfly) needs — its synchronization count ρ (paper footnote 6
    approximates this by FD round counts; exact value = Σ over levels of
    cascade rounds, lower-bounded by #distinct levels)."""
    return int(np.unique(theta).size)


# =====================================================================
# Baseline: BE_PC — progressive-compression peeling (Wang et al. [67])
# =====================================================================
def wing_decomposition_bepc(
    g: BipartiteGraph, tau: float = 0.25, device="cuda",
) -> Tuple[np.ndarray, PeelStats]:
    """Top-down progressive compression (the paper's strongest baseline,
    table 3's BE_PC row).

    Descending support thresholds t: extract the maximal subgraph whose
    edges keep ≥ t butterflies (a t-wing superset — everything with
    θ ≥ t), resolve it by bottom-up peeling *within the subgraph*, then
    move down.  High-θ edges never receive updates from low-θ peels.
    Dense-recount formulation."""
    device = resolve_device(device)
    m = g.m
    edges = _t(g.edges.astype(np.int64), device)
    shape = (g.n_u, g.n_v)
    stats = PeelStats()

    def recount(mask: np.ndarray) -> np.ndarray:
        stats.recounts += 1
        return _host_rint(_wing_recount(shape, edges, _t(mask, device)))

    theta = np.zeros(m, dtype=np.int64)
    resolved = np.zeros(m, dtype=bool)
    sup0 = recount(np.ones(m, bool))
    t = max(int(sup0.max()), 1)
    thresholds = []
    while t > 1:
        thresholds.append(t)
        t = max(1, int(t * tau))
    thresholds.append(1)

    for t in thresholds:
        # candidate core: unresolved edges keeping >= t butterflies
        core = ~resolved
        while True:
            sup = recount(core | resolved)
            bad = core & (sup < t)
            if not bad.any():
                break
            core &= ~bad
        if not core.any():
            continue
        # resolve θ for the core by bottom-up peeling inside
        # (core ∪ resolved); resolved edges are never peeled
        alive = core | resolved
        peelable = core.copy()
        sup = recount(alive)
        k = t
        while peelable.any():
            k = max(k, int(sup[peelable].min()))
            while True:
                S = peelable & (sup <= k)
                if not S.any():
                    break
                theta[S] = k
                alive &= ~S
                peelable &= ~S
                sup = recount(alive)
                stats.rho_fd_total += 1
        resolved |= core

    theta[~resolved] = 0  # butterfly-free edges
    return theta, stats

"""PBNG two-phased peeling (§3) — tip and wing decomposition on the csr
engine, in PyTorch.

Phase 1 (CD) peels every entity whose support lies in the current range
with one fully parallel masked update per round; Phase 2 (FD) peels each
partition to exact entity numbers with no communication, in LPT order
(``device``), all partitions at once (``vmapped``) or round by round
from the host (``host``).  Both phases run the entity-agnostic core in
``core.peelspec``; this module only builds the :class:`PeelSpec` of each
entity universe.

The csr engine peels on the sparse wedge list (``core.csr``) with purely
incremental int32 updates, so θ, round counts and update counts are
bit-identical to the JAX package's csr engine for every driver.  Three
switches select the kernels: ``fused`` runs each FD round of the
device/vmapped drivers as one ``fd_round_wing``/``fd_round_tip`` call;
``use_pallas`` (the JAX package's name, kept for parity) runs CD updates
through ``support_update``/``wedge_count`` and, for the unfused vmapped
wing FD, ``support_update`` inside the loop.  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``, where
every kernel is replaced by its plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import csr
from .distributed import pack_fd_partitions_csr, pack_fd_partitions_tip_csr
from .graph import BipartiteGraph
from .peelspec import (
    PeelResult,
    PeelSpec,
    PeelStats,
    _bucket_pad,
    _fd_cascade,
    _fd_while_device,
    _fd_while_fused,
    _fd_while_vmapped,
    _pad_zeros,
    decompose,
)
from ..kernels import ops as kops

__all__ = [
    "PeelStats",
    "PeelResult",
    "PeelSpec",
    "build_peel_spec",
    "resolve_device",
    "tip_decomposition",
    "wing_decomposition",
]

# engines of the JAX package that this package does not have yet
_NOT_PORTED = {
    "beindex": "ROADMAP queue 1, item 8",
    "dense": "ROADMAP queue 1, item 9",
}

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


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.int64)


def build_peel_spec(
    g: BipartiteGraph,
    kind: str,
    stats: PeelStats,
    side: str = "u",
    engine: str = "csr",
    fd_driver: str = "device",
    use_pallas: bool = False,
    fused: bool = False,
    sup0: Optional[np.ndarray] = None,
    wed: Optional[csr.Wedges] = None,
    device="cuda",
) -> PeelSpec:
    """Build the :class:`PeelSpec` of a ``(kind, engine)`` universe.

    Validates the engine/driver matrix as the JAX package does; the
    engines other than csr raise ``NotImplementedError`` naming their
    ROADMAP item.  ``sup0`` injects a precomputed ⋈init vector and
    ``wed`` prebuilt wedge structures; injection never changes results."""
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
    if engine != "csr":
        raise NotImplementedError(
            f"engine={engine!r} is not ported to repro_torch yet "
            f"({_NOT_PORTED[engine]}); use engine='csr'")
    device = resolve_device(device)
    if kind == "tip":
        gg = g if side == "u" else g.transpose()
        return _tip_spec_csr(gg, stats, use_pallas, fused, sup0, wed, device)
    return _wing_spec_csr(g, stats, use_pallas, fused, sup0, wed, device)


# =====================================================================
# Tip decomposition (vertex peeling)
# =====================================================================
def tip_decomposition(
    g: BipartiteGraph,
    side: str = "u",
    P: int = 16,
    engine: str = "csr",
    fd_driver: str = "device",
    use_pallas: bool = False,
    fused: bool = False,
    sup0: Optional[np.ndarray] = None,
    device="cuda",
) -> PeelResult:
    """PBNG tip decomposition (§3.2) — θ per U (or V) vertex.

    ``fd_driver``: ``"device"`` peels partitions one at a time in LPT
    order, ``"vmapped"`` all at once in one batched loop, ``"host"``
    round by round from a Python loop.  ``fused`` (device/vmapped) runs
    each FD round as one ``fd_round_tip`` call; ``use_pallas`` runs the
    CD deltas through the ``wedge_count`` kernel.  Every combination
    gives the same θ and counts."""
    stats = PeelStats(engine=engine, fd_driver=fd_driver, side=side)
    spec = build_peel_spec(
        g, "tip", stats, side=side, engine=engine, fd_driver=fd_driver,
        use_pallas=use_pallas, fused=fused, sup0=sup0, device=device)
    return decompose(spec, P, stats, fd_driver=fd_driver)


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
            theta_st, rounds = _fd_tip_fused(
                *(_t(p[key][i:i + 1], device)
                  for key in ("st_pa", "st_pb", "st_bf", "mine", "sup0")))
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


def _fd_tip_fused(st_pa, st_pb, st_bf, mine, sup0):
    """Tip FD of B stacked partitions, one ``fd_round_tip`` per round
    over the (B, L) partition-local pair lists.  Returns (theta (B, E),
    rounds (B,))."""
    def round_fn(sup, alive, theta, k, rounds):
        return kops.fd_round_tip(sup, alive, theta, k, rounds,
                                 st_pa, st_pb, st_bf)

    out = _fd_while_fused(_fused_state(mine, sup0, 2), round_fn)
    return out[2], out[4][:, 0]


def _fd_tip_device(mine, sup0, pa, pb, pbf, n: int):
    """One tip partition's cascade (unfused), over (n,) global ids."""
    zero = torch.zeros((), dtype=_I32, device=sup0.device)

    def update(S, aux):
        return csr.tip_delta_csr(S, pa, pb, pbf, n), aux, zero

    return _fd_while_device(mine, sup0, update, None)


def _fd_tip_vmapped(pag, pbg, bff, mine, sup0):
    """All tip partitions in one batched loop (unfused):
    :func:`csr.tip_delta_csr` over the ragged-concatenated pair lists
    with pre-globalized ids (partition b's vertex u → b·Emax+u)."""
    B, Emax = mine.shape
    zero = torch.zeros((), dtype=_I32, device=sup0.device)

    def update(S, aux):
        Sf = S.reshape(-1)
        loss = (csr._seg(torch.where(Sf[pbg], bff, 0), pag, B * Emax)
                + csr._seg(torch.where(Sf[pag], bff, 0), pbg, B * Emax))
        return loss.reshape(B, Emax), aux, zero

    return _fd_while_vmapped(mine, sup0, update, None)


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
        theta_d, rounds, _ = _fd_tip_device(
            _t(mine, device), _t(support0.astype(np.int32), device),
            _t(_pad_zeros(wed.pair_a[mask], size), device),
            _t(_pad_zeros(wed.pair_b[mask], size), device),
            _t(_pad_zeros(pair_bf0[mask].astype(np.int32), size), device),
            n)
        theta[mine] = _host(theta_d)[mine]
        return int(rounds)

    pa = _t(wed.pair_a[mask], device)
    pb = _t(wed.pair_b[mask], device)
    pbf = _t(pair_bf0[mask].astype(np.int32), device)

    def peel(S, sup):
        return sup - _host(csr.tip_delta_csr(_t(S, device), pa, pb, pbf, n))

    return _fd_cascade(mine, support0, theta, peel)


def _tip_fd_vmapped_csr(wed, pair_bf0, part, sup_init, theta, n_parts,
                        fused, device) -> np.ndarray:
    """Tip Phase 2 of all partitions in one batched loop; writes θ in
    place and returns the (B,) per-partition round counts."""
    if n_parts == 0:
        return np.zeros(0, dtype=np.int64)
    packed = pack_fd_partitions_tip_csr(
        wed, pair_bf0, part, sup_init, n_parts, bucket=True, stacked=fused)
    if fused:
        theta_st, rounds = _fd_tip_fused(
            *(_t(packed[key], device)
              for key in ("st_pa", "st_pb", "st_bf", "mine", "sup0")))
    else:
        theta_st, rounds, _ = _fd_tip_vmapped(
            *(_t(packed[key], device)
              for key in ("pa", "pb", "bf", "mine", "sup0")))
    mm = packed["mine"]
    theta[packed["gids"][mm]] = _host(theta_st)[mm]
    return _host(rounds)


# =====================================================================
# Wing decomposition (edge peeling)
# =====================================================================
def wing_decomposition(
    g: BipartiteGraph,
    P: int = 16,
    engine: str = "csr",
    fd_driver: str = "device",
    use_pallas: bool = False,
    fused: bool = False,
    sup0: Optional[np.ndarray] = None,
    device="cuda",
) -> PeelResult:
    """PBNG wing decomposition (§3.3) — θ per edge.

    ``fd_driver`` as for :func:`tip_decomposition`.  ``fused``
    (device/vmapped) runs each FD round as one ``fd_round_wing`` call;
    ``use_pallas`` runs CD updates through the ``support_update`` kernel
    and, with the unfused vmapped driver, FD updates too.  Every
    combination gives the same θ and counts."""
    stats = PeelStats(engine=engine, fd_driver=fd_driver)
    spec = build_peel_spec(
        g, "wing", stats, engine=engine, fd_driver=fd_driver,
        use_pallas=use_pallas, fused=fused, sup0=sup0, device=device)
    return decompose(spec, P, stats, fd_driver=fd_driver)


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
            theta_st, rounds, nupd = _fd_wing_fused(
                *(_t(p[key][i:i + 1], device)
                  for key in ("slot_e1", "slot_e2", "slot_valid", "W_rows",
                              "mine", "sup0")))
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


def _fd_wing_fused(slot_e1, slot_e2, valid0, W0, mine, sup0):
    """Wing FD of B stacked partitions, one ``fd_round_wing`` per round
    over the (B, R, K) pairs-major slots.  Returns (theta (B, E), rounds
    (B,), update count)."""
    state0 = (*_fused_state(mine, sup0, 3), valid0.to(_I32, copy=True),
              W0.to(torch.float32, copy=True))

    def round_fn(sup, alive, theta, k, rounds, nupd, aslot, W):
        return kops.fd_round_wing(sup, alive, theta, k, rounds, nupd, aslot,
                                  W, slot_e1, slot_e2)

    out = _fd_while_fused(state0, round_fn)
    return out[2], out[4][:, 0], out[5].sum()


def _fd_wing_device(mine, sup0, alive_w0, W0, we1, we2, wp, n_pairs: int,
                    m: int):
    """One wing partition's cascade (unfused), over (m,) global ids."""
    def update(S, aux):
        alive_w, W = aux
        alive_w, W, loss, nu = csr.wing_loss_csr(
            S, alive_w, W, we1, we2, wp, n_pairs, m)
        return loss, (alive_w, W), nu

    return _fd_while_device(mine, sup0, update, (alive_w0, W0))


def _fd_wing_vmapped(e1g, e2g, wpg, alive0, W0, mine, sup0, n_pairs: int):
    """All wing partitions in one batched loop (unfused):
    :func:`csr.wing_loss_csr` over the ragged-concatenated wedge lists
    with pre-globalized ids (partition b's edge e → b·(Emax+1)+e, whose
    column Emax is b's never-peeled sentinel)."""
    B, Emax = mine.shape
    nseg = B * (Emax + 1)

    def update(S, aux):
        alive_w, W = aux
        S_pad = torch.cat([S, S.new_zeros((B, 1))], dim=1).reshape(-1)
        alive_w, W, loss, nu = csr.wing_loss_csr(
            S_pad, alive_w, W, e1g, e2g, wpg, n_pairs, nseg)
        return loss.reshape(B, Emax + 1)[:, :Emax], (alive_w, W), nu

    return _fd_while_vmapped(mine, sup0, update, (alive0, W0))


def _fd_wing_vmapped_pallas(slot_e1, slot_e2, valid0, W0, mine, sup0):
    """All wing partitions in one batched loop with the ``support_update``
    kernel inside: the stacked slot blocks flatten to one (B·R, K)
    matrix, so each round is one kernel launch covering every partition;
    only the loss scatter stays an ``index_add_``."""
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

    return _fd_while_vmapped(mine, sup0, update,
                             (valid0.reshape(B * R, K), W0.reshape(B * R)))


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
        theta_d, rounds, nupd = _fd_wing_device(
            _t(mine, device), _t(support_full.astype(np.int32), device),
            _t(alive_w, device), Wp,
            _t(_pad_zeros(wed.wedge_e1[keep], size), device),
            _t(_pad_zeros(wed.wedge_e2[keep], size), device),
            _t(_pad_zeros(wed.wedge_pair[keep], size), device),
            n_pairs, m)
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

    rounds = _fd_cascade(mine, support_full, theta, peel)
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
    if slotted:
        body = _fd_wing_fused if fused else _fd_wing_vmapped_pallas
        theta_st, rounds, nupd = body(
            _t(packed["slot_e1"], device), _t(packed["slot_e2"], device),
            _t(packed["slot_valid"], device),
            _t(_w_rows(packed, n_parts), device),
            _t(packed["mine"], device), _t(packed["sup0"], device))
    else:
        theta_st, rounds, nupd = _fd_wing_vmapped(
            *(_t(packed[key], device)
              for key in ("flat_we1", "flat_we2", "flat_wp", "flat_alive0",
                          "flat_W0", "mine", "sup0")),
            n_pairs=int(packed["flat_W0"].shape[0]))
    mm = packed["mine"]
    theta[packed["gids"][mm]] = _host(theta_st)[mm]
    return _host(rounds), int(nupd)

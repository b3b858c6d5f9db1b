"""Entity-agnostic PBNG peeling core (the port of the JAX package's
``core/peelspec.py``).

The paper (§4–§6) defines one two-phase peeling algorithm for two entity
universes: vertices (tip) and edges (wing).  :class:`PeelSpec` holds
everything entity-specific; :func:`cd_loop` (Phase 1, coarse-grained
decomposition) and :func:`run_fd` (Phase 2, fine-grained decomposition)
drive any spec.  Three FD drivers exist once each:

* :func:`_fd_cascade` — the host loop, one device update and one
  device→host support copy per peel round;
* :func:`_fd_while_vmapped` (and :func:`_fd_while_device`, its B = 1
  case) — the batched cascade of plain tensor operations;
* :func:`_fd_while_fused` — one fused kernel round per iteration.

With the obs layer on (``repro_torch.obs``), :func:`decompose` installs
a timeline collector and wraps the run in ``peel`` / ``cd`` / ``fd``
spans, :func:`cd_loop` records one ``cd.round`` span per round and
:func:`run_fd` one ``fd.launch`` span per dispatch; the device-side
drivers then run as their ``*_rings`` twins, which also write per-round
counters into int32 rings on the device, read once after the loop.
With it off none of that runs.

The JAX package runs the last two as ``lax.while_loop`` on the device.
Here they are host loops that never read the device inside a round:
rounds are queued in chunks of :data:`FD_CHUNK`, and one flag,
``any(alive)``, is read per chunk.  The rounds queued past a
partition's fixed point change nothing that is returned: with nothing
alive the peel set is empty, so θ, the round count (it adds
``any(alive)``) and the update count stay; only k runs up to the
sentinel, and k is not returned.  That is what the JAX package's
batched loop already does for partitions that drain before the last.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs

__all__ = [
    "PeelStats",
    "PeelResult",
    "PeelSpec",
    "AdaptiveTarget",
    "FixedTarget",
    "cd_loop",
    "run_fd",
    "decompose",
    "FD_CHUNK",
]

# rounds queued between two reads of the device's any(alive) flag
FD_CHUNK = 32


# =====================================================================
# Results / stats
# =====================================================================
@dataclasses.dataclass
class PeelStats:
    """Reproduces the paper's evaluation metrics (tables 3/4)."""

    rho_cd: int = 0          # CD global-sync rounds
    rho_fd_total: int = 0    # Σ sequential FD rounds  (≈ ParButterfly's ρ)
    rho_fd_max: int = 0      # FD critical path (what PBNG actually pays)
    updates: int = 0         # support updates applied
    recounts: int = 0        # batch re-counts (dense engine; 0 for csr)
    p_effective: int = 0     # partitions actually created
    engine: str = ""         # engine that produced THESE round counts
    fd_driver: str = ""      # "device" | "vmapped" | "host"
    side: str = ""           # tip: peeled vertex set "u"|"v"; wing: ""

    @property
    def rho(self) -> int:
        """PBNG synchronization rounds = CD rounds only: FD partitions
        peel with no global synchronization (the paper's ρ)."""
        return self.rho_cd

    @property
    def sync_reduction(self) -> float:
        """ρ(level-by-level parallel BUP) / ρ(PBNG), both from this run
        (ρ(ParB) ≈ rho_fd_total, the paper's footnote 6)."""
        return self.rho_fd_total / max(self.rho_cd, 1)

    def as_dict(self) -> dict:
        """Flat JSON-ready view (per-engine rho + derived ratios)."""
        d = dataclasses.asdict(self)
        d["rho"] = self.rho
        d["sync_reduction"] = round(self.sync_reduction, 3)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PeelStats":
        """Inverse of :meth:`as_dict` (ignores the derived keys)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class PeelResult:
    """Everything a decomposition produced: θ, the CD partition of each
    entity, the range boundaries θ(1..P+1), the ⋈init snapshot and the
    engine-tagged :class:`PeelStats`; ``seconds`` holds the host-clock
    seconds of the two phases (``cd``, ``fd``) and the spec's own
    (``PeelSpec.seconds``: its build steps and its FD drivers' packs),
    and is no part of the provenance; ``timeline`` holds the per-round
    curves when the obs layer was on during the run."""

    theta: np.ndarray         # entity numbers
    part: np.ndarray          # CD partition id per entity
    ranges: np.ndarray        # (P+1,) range boundaries
    support_init: np.ndarray  # ⋈init vector
    stats: PeelStats
    seconds: dict = dataclasses.field(default_factory=dict)
    timeline: Optional["obs.PeelTimeline"] = None

    def provenance(self) -> dict:
        """Everything besides θ a downstream consumer needs to rebuild
        the peeling order: stats, partition, ranges and ⋈init, and the
        timeline's digest where one was collected."""
        prov = dict(
            stats=self.stats.as_dict(),
            part=np.asarray(self.part),
            ranges=np.asarray(self.ranges),
            support_init=np.asarray(self.support_init),
        )
        if self.timeline is not None:
            prov["timeline"] = self.timeline.summary()
        return prov


# =====================================================================
# The spec — one entity universe + its peeling rules
# =====================================================================
@dataclasses.dataclass
class PeelSpec:
    """One PBNG peeling instance.

    ``cd_step(active) -> sup_np`` applies one masked peel round to the
    engine's device state and returns the refreshed int64 supports
    (charging ``stats.updates`` itself).  ``fd_partition(i, part,
    sup_init, theta, fd_driver) -> (rounds, n_updates, n_recounts)``
    peels partition i bottom-up, writing θ in place.  ``fd_vmapped(part,
    sup_init, theta, n_parts) -> (rounds[B], n_updates)`` peels all
    partitions in one batched loop.  ``seconds`` collects the host
    seconds of the spec's build steps and of its FD drivers' packs, by
    span name (``obs.span``'s ``seconds`` sink)."""

    kind: str                 # "tip" | "wing" — provenance tag
    n: int                    # entity universe size
    sup0: np.ndarray          # (n,) int64 — ⋈init supports
    workload: Callable        # sup_np -> (n,) range-selection weights
    est: Callable             # sup_np -> (n,) partition workload weights
    cd_step: Callable         # active mask -> refreshed int64 supports
    fd_partition: Optional[Callable] = None
    fd_vmapped: Optional[Callable] = None
    seconds: dict = dataclasses.field(default_factory=dict)


# =====================================================================
# Range selection (§3.1.3) — host-side histogram + prefix scan
# =====================================================================
def _find_range(
    support: np.ndarray,
    workload: np.ndarray,
    alive: np.ndarray,
    tgt: float,
) -> int:
    """Smallest hi such that Σ workload[alive & support < hi] ≥ tgt."""
    s = support[alive]
    w = workload[alive]
    if s.size == 0:
        return 0
    order = np.argsort(s, kind="stable")
    s, w = s[order], w[order]
    cum = np.cumsum(w)
    pos = int(np.searchsorted(cum, max(tgt, 1e-9)))
    pos = min(pos, s.size - 1)
    return int(s[pos]) + 1


class AdaptiveTarget:
    """Two-way adaptive range targets (§3.1.3)."""

    def __init__(self, total_workload: float, P: int):
        self.P = P
        self.remaining = float(total_workload)
        self.scale = 1.0

    def target(self, i: int) -> float:
        """Workload target for partition i: remaining / remaining parts,
        damped by the last overshoot ratio."""
        rem_parts = max(self.P - i, 1)
        return self.scale * self.remaining / rem_parts

    def consumed(self, initial_estimate: float, final_estimate: float) -> None:
        """Record partition i's actual workload and update the damping."""
        self.remaining = max(self.remaining - final_estimate, 0.0)
        if final_estimate > 0 and initial_estimate > 0:
            self.scale = min(1.0, initial_estimate / final_estimate)


class FixedTarget:
    """Constant total/P range targets."""

    def __init__(self, total_workload: float, P: int):
        self.tgt = float(total_workload) / max(P, 1)

    def target(self, i: int) -> float:
        """Constant workload target: total / P for every partition."""
        return self.tgt

    def consumed(self, initial_estimate: float, final_estimate: float) -> None:
        """No adaptation — the fixed policy ignores overshoot."""


def _lpt_order(work: np.ndarray) -> np.ndarray:
    """Longest-processing-time order of partitions (fig.4)."""
    return np.argsort(-work, kind="stable")


# =====================================================================
# Phase 1 — the CD round loop
# =====================================================================
def cd_loop(spec: PeelSpec, P: int, stats: PeelStats, target=None):
    """Coarse-grained decomposition: adaptive range selection + masked
    peel rounds until every entity is assigned a partition.  Host-driven:
    one ``cd_step`` (device update + support copy to the host) per round.
    With a timeline collector live, each round is also a ``cd.round``
    span and a timeline row.

    Returns ``(part, sup_init, ranges, p_effective)``."""
    col = obs.active_collector()
    sup_np = np.asarray(spec.sup0, dtype=np.int64).copy()
    n = sup_np.size
    if target is None:
        target = AdaptiveTarget(float(spec.est(sup_np).sum()), P)
    alive = np.ones(n, dtype=bool)
    part = np.full(n, -1, dtype=np.int32)
    sup_init = np.zeros(n, dtype=np.int64)
    ranges = [0]
    p_eff = 0
    for i in range(P):
        if not alive.any():
            break
        sup_init[alive] = sup_np[alive]
        if i == P - 1:
            hi = int(sup_np[alive].max()) + 1
        else:
            tgt = target.target(i)
            hi = _find_range(sup_np, spec.workload(sup_np), alive, tgt)
            hi = max(hi, int(sup_np[alive].min()) + 1)  # guarantee progress
        initial_est = float(spec.est(sup_np)[alive & (sup_np < hi)].sum())
        ranges.append(hi)
        while True:
            active = alive & (sup_np < hi)
            if not active.any():
                break
            part[active] = i
            alive &= ~active
            if col is None:
                sup_np = spec.cd_step(active)
            else:
                died = int(active.sum())
                u0, r0 = stats.updates, stats.recounts
                with obs.span("cd.round", cat="cd.round",
                              part=int(i)) as sp:
                    sup_np = spec.cd_step(active)
                    frontier = int(alive.sum())
                    du = stats.updates - u0
                    dr = stats.recounts - r0
                    sp.update(died=died, frontier=frontier, hi=int(hi),
                              updates=du, recounts=dr)
                col.record_cd_round(i, died, frontier, int(hi), du, dr)
            stats.rho_cd += 1
        final_est = float(spec.est(sup_init)[part == i].sum())
        target.consumed(initial_est, final_est)
        p_eff = i + 1
    stats.p_effective = p_eff
    return part, sup_init, np.asarray(ranges, dtype=np.int64), p_eff


# =====================================================================
# Phase 2 — the FD dispatcher
# =====================================================================
def run_fd(
    spec: PeelSpec,
    part: np.ndarray,
    sup_init: np.ndarray,
    theta: np.ndarray,
    n_parts: int,
    stats: PeelStats,
    fd_driver: str = "device",
    only: Optional[np.ndarray] = None,
    per_partition: Optional[dict] = None,
) -> None:
    """Fine-grained decomposition over the CD partitions.

    ``fd_driver="vmapped"`` routes through ``spec.fd_vmapped`` (all
    partitions in one batched loop); otherwise partitions run in LPT
    order through ``spec.fd_partition``.  ``only`` restricts the
    per-partition path to a subset of partition ids; ``per_partition``,
    when a dict, receives ``{i: (rounds, updates, recounts)}``.  Writes θ
    in place and charges the FD counters.  Each dispatch is an
    ``fd.launch`` span (``fd.vmapped``, ``fd.partition[i]``)."""
    if n_parts <= 0:
        return
    if fd_driver == "vmapped":
        if only is not None:
            raise ValueError(
                "only= requires a per-partition fd_driver "
                "('device' | 'host'); the vmapped driver runs every "
                "partition in one batched loop")
        with obs.span("fd.vmapped", cat="fd.launch",
                      n_parts=int(n_parts)) as sp:
            rounds_v, nupd = spec.fd_vmapped(part, sup_init, theta, n_parts)
            rounds_v = np.asarray(rounds_v)
            if sp is not None:
                sp.update(rounds=int(rounds_v.sum()), updates=int(nupd))
        stats.rho_fd_total = int(rounds_v.sum())
        stats.rho_fd_max = int(rounds_v.max()) if rounds_v.size else 0
        stats.updates += int(nupd)
        return
    if only is None:
        ids = np.arange(n_parts)
    else:
        ids = np.unique(np.asarray(only, dtype=np.int64))
        if ids.size and (ids[0] < 0 or ids[-1] >= n_parts):
            raise ValueError(
                f"only= ids outside [0, {n_parts}): {ids.tolist()}")
    est_w = spec.est(sup_init)
    part_work = np.array(
        [est_w[part == i].sum() for i in ids], dtype=np.float64
    )
    for j in _lpt_order(part_work):
        i = int(ids[j])
        with obs.span(f"fd.partition[{i}]", cat="fd.launch",
                      part=i) as sp:
            rounds, nupd, nrec = spec.fd_partition(
                i, part, sup_init, theta, fd_driver)
            if sp is not None:
                sp.update(rounds=int(rounds), updates=int(nupd),
                          recounts=int(nrec))
        if per_partition is not None:
            per_partition[i] = (int(rounds), int(nupd), int(nrec))
        stats.rho_fd_total += rounds
        stats.rho_fd_max = max(stats.rho_fd_max, rounds)
        stats.updates += nupd
        stats.recounts += nrec


def decompose(
    spec: PeelSpec,
    P: int,
    stats: PeelStats,
    fd_driver: str = "device",
    target=None,
) -> PeelResult:
    """Run both phases of one :class:`PeelSpec` and assemble the
    :class:`PeelResult` — the driver behind ``tip_decomposition`` and
    ``wing_decomposition``.

    The ``cd`` and ``fd`` spans time the two phases into the result's
    ``seconds``, beside the spec's own.  With the obs layer on this is
    the telemetry root: it installs the timeline collector, wraps the
    run in a ``peel`` span, attaches the built timeline to the result and
    adds the per-round ``fd.round`` events to the trace."""
    obs.count("peel.decompositions")
    seconds: dict = {}
    with obs.maybe_collect() as col:
        with obs.span("peel.decompose", cat="peel", kind=spec.kind,
                      engine=stats.engine, fd_driver=fd_driver, P=int(P)):
            with obs.span("cd", cat="cd", seconds=seconds):
                part, sup_init, ranges, p_eff = cd_loop(
                    spec, P, stats, target=target)
            with obs.span("fd", cat="fd", driver=fd_driver,
                          seconds=seconds):
                theta = np.zeros(spec.n, dtype=np.int64)
                run_fd(spec, part, sup_init, theta, p_eff, stats,
                       fd_driver=fd_driver)
    timeline = None
    if col is not None:
        timeline = col.build()
        tracer = obs.get_tracer()
        if tracer is not None:
            timeline.emit_trace_events(tracer)
    return PeelResult(theta=theta, part=part, ranges=ranges,
                      support_init=sup_init, stats=stats,
                      seconds={**spec.seconds, **seconds},
                      timeline=timeline)


# =====================================================================
# FD cascade drivers — each body exists exactly once
# =====================================================================
def _fd_cascade(mine: np.ndarray, support0: np.ndarray, theta: np.ndarray,
                apply_peel, on_round=None) -> int:
    """Level-synchronous bottom-up cascade driven from the host: advance
    k to the minimum alive support, peel the ≤k set, apply the engine's
    update, repeat until the partition is empty.

    ``apply_peel(S, sup)`` consumes the peel mask and the current int64
    support vector and returns the refreshed one.  Returns the number
    of peel rounds.  ``on_round(k, died, frontier)``, when given, is
    called after every round (the obs layer's host-side stand-in for the
    counter rings)."""
    alive = mine.copy()
    sup = support0
    k = 0
    rounds = 0
    while alive.any():
        k = max(k, int(sup[alive].min()))
        while True:
            S = alive & (sup <= k)
            if not S.any():
                break
            theta[S] = k
            alive &= ~S
            sup = apply_peel(S, sup)
            rounds += 1
            if on_round is not None:
                on_round(k=k, died=int(S.sum()), frontier=int(alive.sum()))
    return rounds


# sentinel for masked-out supports in the k-advance; must be >= any real
# support (engines guard supports <= int32 max)
_FD_BIG = torch.iinfo(torch.int32).max


def _bucket_pad(n: int, floor: int = 128) -> int:
    """Round n up to a quarter-power-of-two bucket (≥ floor), with ≤25%
    padding (zero padding is algebra-neutral).  Kept from the JAX
    package, where it bounds recompiles, so the packed shapes match."""
    if n <= floor:
        return floor
    step = 1 << max(int(n - 1).bit_length() - 2, 0)
    return -(-n // step) * step


def _t(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host(x: torch.Tensor) -> np.ndarray:
    """A device tensor of integers as a host int64 array."""
    return x.cpu().numpy().astype(np.int64)


def _fd_host(x: torch.Tensor) -> np.ndarray:
    """:func:`_host` in an FD driver: one ``fd.host_syncs``."""
    obs.count("fd.host_syncs")
    return _host(x)


def _fd_int(x: torch.Tensor) -> int:
    """A device scalar as an ``int`` in an FD driver: one
    ``fd.host_syncs``."""
    obs.count("fd.host_syncs")
    return int(x)


def _pad_zeros(x: np.ndarray, size: int) -> np.ndarray:
    if x.size >= size:
        return x
    return np.concatenate([x, np.zeros(size - x.size, dtype=x.dtype)])


def _until_drained(state, step, alive_at: int):
    """Queue rounds ``state = step(*state)`` in chunks of
    :data:`FD_CHUNK` until ``state[alive_at]`` holds nothing alive,
    reading the device once per chunk and once more at the end (each
    read one ``fd.host_syncs``)."""
    while _fd_int(state[alive_at].any()):
        for _ in range(FD_CHUNK):
            state = step(*state)
    return state


def _peel_round(alive, sup, aux, theta, k, update):
    """One peel round of every live partition of a [B, E] batch: its own
    k-advance to the minimum alive support, the ≤k peel set S, θ and the
    engine's ``update(S, aux) -> (loss, aux', n_upd)``.  Returns (S,
    live, alive, sup, aux, theta, k, n_upd), ``live`` the partitions that
    held anything alive before the round."""
    live = alive.any(dim=1)
    k = torch.maximum(k, sup.masked_fill(~alive, _FD_BIG).amin(dim=1))
    S = alive & (sup <= k[:, None])
    theta = torch.where(S, k[:, None], theta)
    alive = alive & ~S
    loss, aux, nu = update(S, aux)
    return S, live, alive, sup - loss, aux, theta, k, nu


def _batch_of_one(update):
    """An (n,)-mask ``update`` lifted to the [1, n] batch of the
    vmapped drivers."""
    def update_b(S, aux):
        loss, aux, nu = update(S[0], aux)
        return loss[None], aux, nu

    return update_b


def _fd_while_vmapped(mine: torch.Tensor, sup0: torch.Tensor, update, aux):
    """The whole Phase 2 of B stacked partitions as one batched loop of
    plain tensor operations.

    ``mine``/``sup0`` are [B, E]; every iteration advances every live
    partition by one peel round (its own k-advance + ≤k peel), so the
    per-partition round counts equal the per-partition drivers'.
    ``update(S, aux) -> (loss, aux', n_upd)`` consumes the batched peel
    mask S [B, E].  Returns (theta [B, E], rounds [B], updates)."""
    def step(alive, sup, aux, theta, k, rounds, nupd):
        _, live, alive, sup, aux, theta, k, nu = _peel_round(
            alive, sup, aux, theta, k, update)
        return (alive, sup, aux, theta, k, rounds + live.to(torch.int32),
                nupd + nu)

    state = _until_drained(_vmapped_state(mine, sup0, aux), step,
                           alive_at=0)
    return state[3], state[5], state[6]


def _vmapped_state(mine: torch.Tensor, sup0: torch.Tensor, aux):
    """The batched loop's initial state: alive, sup, aux, θ, k, rounds,
    update count."""
    zero = torch.zeros_like(sup0)
    zero_p = zero[:, 0]
    return (mine, sup0, aux, zero, zero_p, zero_p,
            torch.zeros((), dtype=torch.int32, device=sup0.device))


def _fd_while_device(mine: torch.Tensor, sup0: torch.Tensor, update, aux):
    """One partition's cascade over (n,) arrays: the B = 1 case of
    :func:`_fd_while_vmapped`.  ``update(S, aux) -> (loss, aux', n_upd)``
    takes the (n,) peel mask.  Returns (theta (n,), rounds, updates)."""
    theta, rounds, nupd = _fd_while_vmapped(mine[None], sup0[None],
                                            _batch_of_one(update), aux)
    return theta[0], rounds[0], nupd


def _fd_while_fused(state0, round_fn):
    """The cascade with one fused kernel round per iteration.
    ``state0`` holds the alive mask (nonzero = alive) at index 1;
    ``round_fn(*state) -> state`` is the fused round."""
    return _until_drained(state0, round_fn, alive_at=1)


# =====================================================================
# Telemetry-on twins of the FD drivers (obs counter rings)
# =====================================================================
# Each ``*_rings`` function runs its twin's rounds (the same
# ``_peel_round`` / fused round) and also writes per-round int32
# counters into preallocated rings on the device — dying count,
# frontier size, k-advance, update count — at row ``min(it, cap-1)``,
# ``it`` the rounds run so far: the first cap-1 rounds and the last one
# survive an overflow, which the drain flags ``truncated``.  A round
# queued past the fixed point (``_until_drained`` queues up to
# FD_CHUNK-1 of them) peels nothing, and its write is masked off, so
# the rings hold exactly the JAX package's rows.  No host read happens
# inside the loop; the rings come back to the host once, after it.
# The twins are separate functions so that with the obs layer off no
# ring is allocated and no ring code runs.
def _new_rings(cap: int, B: int, dev, n_batched: int = 3):
    """Four int32 rings: ``n_batched`` shaped (cap, B), the rest
    (cap,)."""
    return tuple(
        torch.zeros((cap, B) if j < n_batched else (cap,),
                    dtype=torch.int32, device=dev)
        for j in range(4))


def _ring_write(rings, it: torch.Tensor, on: torch.Tensor, rows) -> None:
    """Write one round's counters ``rows`` at row ``min(it, cap-1)`` of
    each ring where ``on`` (a 0-d bool: the round had anything alive);
    elsewhere keep the row.  ``it`` is a (1,) int64 device tensor."""
    slot = it.clamp(max=rings[0].shape[0] - 1)
    for ring, row in zip(rings, rows):
        cur = ring.index_select(0, slot)
        ring.index_copy_(0, slot, torch.where(
            on, row.to(ring.dtype).reshape(cur.shape), cur))


def _host_rings(rings):
    obs.count("fd.host_syncs", len(rings))
    return tuple(r.cpu().numpy() for r in rings)


def _fd_while_vmapped_rings(mine: torch.Tensor, sup0: torch.Tensor, update,
                            aux, ring_cap: int):
    """:func:`_fd_while_vmapped` + counter rings; returns ``(theta,
    rounds, nupd, (died, frontier, k, upd))``, the rings host arrays: the
    first three (ring_cap, B), the update ring (ring_cap,) (the engine's
    per-round update count is a phase-global scalar)."""
    rings = _new_rings(int(ring_cap), sup0.shape[0], sup0.device)
    i32 = torch.int32

    def step(alive, sup, aux, theta, k, rounds, nupd, it):
        on = alive.any()
        S, live, alive, sup, aux, theta, k, nu = _peel_round(
            alive, sup, aux, theta, k, update)
        _ring_write(rings, it, on, (S.sum(dim=1, dtype=i32),
                                    alive.sum(dim=1, dtype=i32), k, nu))
        return (alive, sup, aux, theta, k, rounds + live.to(i32), nupd + nu,
                it + on)

    it0 = torch.zeros((1,), dtype=torch.int64, device=sup0.device)
    state = _until_drained((*_vmapped_state(mine, sup0, aux), it0), step,
                           alive_at=0)
    return state[3], state[5], state[6], _host_rings(rings)


def _fd_while_device_rings(mine: torch.Tensor, sup0: torch.Tensor, update,
                           aux, ring_cap: int):
    """:func:`_fd_while_device` + counter rings; returns ``(theta,
    rounds, nupd, (died, frontier, k, upd))`` with each ring a
    (ring_cap,) host array."""
    theta, rounds, nupd, rings = _fd_while_vmapped_rings(
        mine[None], sup0[None], _batch_of_one(update), aux, ring_cap)
    died, frontier, k, upd = rings
    return (theta[0], rounds[0], nupd,
            (died[:, 0], frontier[:, 0], k[:, 0], upd))


def _fd_while_fused_rings(state0, round_fn, ring_cap: int):
    """:func:`_fd_while_fused` + counter rings taken around the fused
    round (the kernel itself is untouched): died / frontier from the
    alive mask (state index 1) before and after the round, k from state
    index 3, and — where the state carries a per-partition update count
    at index 5 (the wing 8-tuple) — its *cumulative* value per round
    (drain with ``cumulative_updates=True``).  Returns ``(state, (died,
    frontier, k, upd_cum))``, the rings (ring_cap, B) host arrays."""
    alive0 = state0[1]
    B = alive0.shape[0]
    rings = _new_rings(int(ring_cap), B, alive0.device, n_batched=4)
    i32 = torch.int32
    no_upd = torch.zeros((B,), dtype=i32, device=alive0.device)

    def step(*carry):
        *state, it = carry
        alive = state[1] != 0
        on = alive.any()
        before = alive.sum(dim=1, dtype=i32)
        new = round_fn(*state)
        after = (new[1] != 0).sum(dim=1, dtype=i32)
        nu_cum = new[5].sum(dim=1, dtype=i32) if len(new) > 5 else no_upd
        _ring_write(rings, it, on,
                    (before - after, after, new[3][:, 0], nu_cum))
        return (*new, it + on)

    it0 = torch.zeros((1,), dtype=torch.int64, device=alive0.device)
    out = _until_drained((*state0, it0), step, alive_at=1)
    return tuple(out[:-1]), _host_rings(rings)

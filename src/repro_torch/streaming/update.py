"""Incremental θ maintenance: the micro-epoch streaming updater (the
port of the JAX package's ``streaming/update.py``).

One :class:`StreamState` owns the live decomposition of an evolving
bipartite graph.  Per micro-epoch:

1. **coalesce** the event batch to net inserts/deletes (`events.py`);
2. **delta**: exact wedge-local ⋈init update + touched set
   (`delta.py`) — no global butterfly recount;
3. **CD re-runs in full** (it is the cheap, host-driven phase and its
   partition ranges are what bound the repair's blast radius);
4. **dirty partitions** are detected by comparing the fresh Phase-1
   output against the previous epoch by entity key;
5. **localized FD**: only dirty partitions re-peel, dispatched through
   the existing ``core.peelspec.run_fd`` (``only=`` — the same FD
   drivers as a full run), clean partitions carry their θ and
   per-partition stats forward;
6. **hierarchy repair**: only dirty levels recompute their component
   labels (on the device); the forest re-assembles bit-identical to a
   from-scratch build (`hierarchy/repair.py`).

Every epoch's (θ, stats, forest) is **bit-identical** to peeling the
materialized graph from scratch — the differential harness in
``tests/test_torch_streaming.py`` asserts it after every epoch (and
``chip_smoke.py`` on the card), and the invariant is exactly why serving
can keep answering from the previous forest during repair: the swap is
atomic and the stale window is the dirty subtrees
(:func:`repro_torch.hierarchy.repair.dirty_subtrees`).

The device work (CD updates, FD cascades, label propagation) runs on
the ``device`` a :class:`StreamState` was created for: the card unless
the caller asks for the CPU, and no fallback where there is no card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.graph import BipartiteGraph
from ..core.peel import PeelStats, build_peel_spec
from ..core.peelspec import PeelResult, cd_loop, run_fd
from ..device import resolve_device
from ..hierarchy.build import Hierarchy
from ..hierarchy import repair as hrepair
from . import delta as sdelta
from . import events as sevents

__all__ = ["StreamConfig", "StreamState", "EpochReport"]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """How the stream peels.  Per-partition ``fd_driver`` values
    ("device" | "host") localize Phase 2 to dirty partitions;
    ``"vmapped"`` (csr engine) instead re-runs the WHOLE Phase 2 as its
    one batched loop every epoch, trading localization for dispatch
    count.  θ stays bit-identical either way (the differential harness
    covers all three).  ``use_pallas`` (csr; the JAX package's name)
    runs the CD updates through the ``wedge_count`` (tip) and
    ``support_update`` (wing) kernels."""

    kind: str = "wing"          # "wing" | "tip"
    side: str = "u"             # tip only: which vertex set carries θ
    engine: str = "csr"         # "csr" | "dense"
    P: int = 16
    fd_driver: str = "device"   # "device" | "host" | "vmapped"
    batch_recount: object = "adaptive"  # dense tip only (the §5.1 knob)
    use_pallas: bool = False
    level_block: int = 32

    def __post_init__(self):
        if self.kind not in ("wing", "tip"):
            raise ValueError(self.kind)
        if self.engine not in ("csr", "dense"):
            raise ValueError(
                f"streaming supports engines 'csr' | 'dense', "
                f"got {self.engine!r}")
        if self.fd_driver not in ("device", "host", "vmapped"):
            raise ValueError(
                "streaming fd_driver must be 'device' | 'host' "
                "(per-partition, localized to dirty partitions) or "
                "'vmapped' (csr, single-device: one batched Phase-2 "
                "launch per epoch); the fused driver has no streaming "
                "entry")
        if self.fd_driver == "vmapped" and self.engine != "csr":
            raise ValueError(
                "fd_driver='vmapped' is the csr single-dispatch "
                "Phase 2; streaming supports it with engine='csr' "
                "only")
        if self.side not in ("u", "v"):
            raise ValueError(self.side)
        if self.kind == "wing" and self.side != "u":
            raise ValueError("wing has no side; use side='u'")


@dataclasses.dataclass
class EpochReport:
    """What one micro-epoch did (the CLI/benchmark row source)."""

    epoch: int
    n_events: int
    n_inserts: int           # net, after coalescing
    n_deletes: int
    noop: bool
    p_eff: int
    partitions_dirty: int
    levels_dirty: int
    levels_total: int
    stale_nodes: int         # old-forest nodes invalidated during repair
    stale_entities: int      # Σ dirty-subtree slice lengths (bound)
    repair_ms: float         # FD re-run + hierarchy repair
    epoch_ms: float          # whole epoch, coalesce → swap
    theta_max: int

    def as_dict(self) -> dict:
        """Flat JSON-ready view."""
        return dataclasses.asdict(self)


class StreamState:
    """The live decomposition of an evolving graph (one tenant), its
    device work on ``device`` (default the card)."""

    def __init__(self, g: BipartiteGraph, config: StreamConfig,
                 metrics: Optional["obs.MetricsRegistry"] = None,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None \
            else obs.MetricsRegistry()
        self.epoch = 0
        self.g = g
        self.result: Optional[PeelResult] = None
        self.hierarchy: Optional[Hierarchy] = None
        self._sup0: Optional[np.ndarray] = None       # gg-space ⋈init
        self._pp: Dict[int, Tuple[int, int, int]] = {}  # j → (ρ, upd, rec)
        self._label_cache: Optional[hrepair.LabelCache] = None

    # ------------------------------------------------------------ internals
    def _gg(self, g: BipartiteGraph) -> BipartiteGraph:
        cfg = self.config
        return g if (cfg.kind == "wing" or cfg.side == "u") else g.transpose()

    def _fresh_stats(self) -> PeelStats:
        cfg = self.config
        return PeelStats(
            engine=cfg.engine,
            fd_driver=cfg.fd_driver if cfg.engine == "csr" else "host",
            side=cfg.side if cfg.kind == "tip" else "",
        )

    @staticmethod
    def initial(g: BipartiteGraph, config: StreamConfig,
                metrics=None, device="cuda") -> "StreamState":
        """Peel the starting graph through the SAME epoch machinery
        (everything dirty) so epoch 0 exercises the streaming path."""
        st = StreamState(g, config, metrics, device)
        st.apply_epoch([])
        return st

    # ---------------------------------------------------------------- epoch
    def apply_epoch(self, events: Sequence["sevents.EdgeEvent"]
                    ) -> EpochReport:
        """Ingest one micro-epoch; returns what changed.  The previous
        ``result``/``hierarchy`` stay readable (stale-but-bounded)
        until the final in-place swap."""
        with obs.span("stream.epoch", cat="stream", epoch=self.epoch,
                      events=len(events)) as sp:
            rep = self._apply(list(events), sp)
        self.metrics.inc("stream.epochs")
        self.metrics.observe("stream.epoch_ms", rep.epoch_ms)
        self.epoch += 1
        return rep

    def _apply(self, events: List["sevents.EdgeEvent"], sp) -> EpochReport:
        cfg = self.config
        t0 = time.perf_counter()
        ins, dels = sevents.coalesce(events, self.g)
        first = self.result is None
        if not first and ins.size == 0 and dels.size == 0:
            # structural no-op: same graph ⇒ a re-peel would reproduce
            # the current state bit-for-bit; serve it unchanged
            self.metrics.inc("stream.noop_epochs")
            rep = self._report(events, ins, dels, noop=True,
                               dirty=np.zeros(0, dtype=np.int64),
                               lv_dirty=0, repair_ms=0.0, t0=t0,
                               stale=(0, 0))
            if sp is not None:
                sp.update(noop=True)
            return rep

        gg_old = self._gg(self.g)
        g_new = sevents.apply_events(self.g, ins, dels)
        gg_new = self._gg(g_new)
        # internal orientation: tip side="v" peels the transpose's U side
        swap = cfg.kind == "tip" and cfg.side == "v"
        ins_i, dels_i = (ins[:, ::-1], dels[:, ::-1]) if swap else (ins, dels)

        # ---- wedge-local ⋈init delta + touched set (host, exact)
        if first:
            touched: set = set()
            sup0_new = None
        else:
            dlt, touched = sdelta.support_delta(
                gg_old, ins_i, dels_i, cfg.kind)
            if cfg.kind == "wing":
                sup0_new = sdelta.wing_sup0_new(
                    gg_old, self._sup0, gg_new, dlt)
            else:
                sup0_new = self._sup0.copy()
                for u, d in dlt.items():
                    sup0_new[u] += d

        # ---- Phase 1 re-runs in full (its ranges bound the blast radius)
        stats = self._fresh_stats()
        inject = sup0_new is not None and not (
            cfg.kind == "tip" and cfg.engine == "dense")
        spec = build_peel_spec(
            g_new, cfg.kind, stats, side=cfg.side, engine=cfg.engine,
            batch_recount=cfg.batch_recount, fd_driver=cfg.fd_driver,
            use_pallas=cfg.use_pallas,
            sup0=sup0_new if inject else None, device=self.device)
        with obs.span("stream.cd", cat="stream"):
            part, sup_init, ranges, p_eff = cd_loop(spec, cfg.P, stats)
        upd_cd, rec_cd = stats.updates, stats.recounts

        # ---- dirty partitions: fresh Phase-1 vs previous epoch, by key
        theta = np.zeros(spec.n, dtype=np.int64)
        if first:
            dirty = np.arange(p_eff, dtype=np.int64)
            oc = nc = np.zeros(0, dtype=np.int64)
        else:
            oc, nc = sdelta.common_entities(gg_old, gg_new, cfg.kind)
            t_old = self._touched_mask(gg_old, touched)
            t_new = self._touched_mask(gg_new, touched)
            dirty = sdelta.dirty_partitions(
                self.result.part, part, oc, nc,
                self.result.support_init, sup_init, t_old, t_new,
                int(self.result.stats.p_effective), p_eff)
            theta[nc] = self.result.theta[oc]

        # ---- localized FD + dirty-subtree forest repair
        t_rep = time.perf_counter()
        with obs.span("stream.repair", cat="stream",
                      partitions_dirty=int(dirty.size)) as rsp:
            pp_new: Dict[int, Tuple[int, int, int]] = {}
            if cfg.fd_driver == "vmapped":
                # the vmapped driver is ONE batched loop over every
                # partition — nothing to localize, so each epoch
                # re-runs the whole Phase 2 and the driver itself
                # writes the full-run stats row (rho totals set,
                # updates accumulated on top of the CD counts)
                with obs.span("stream.fd", cat="stream"):
                    run_fd(spec, part, sup_init, theta, p_eff, stats,
                           fd_driver="vmapped")
                pp_full = {}
            else:
                with obs.span("stream.fd", cat="stream"):
                    run_fd(spec, part, sup_init, theta, p_eff, stats,
                           fd_driver=cfg.fd_driver, only=dirty,
                           per_partition=pp_new)
                # reassemble the full-run stats row from carried
                # partitions
                pp_full = {
                    j: pp_new[j] if j in pp_new else self._pp[j]
                    for j in range(p_eff)
                }
                rows = list(pp_full.values())
                stats.rho_fd_total = sum(r for r, _, _ in rows)
                stats.rho_fd_max = max((r for r, _, _ in rows), default=0)
                stats.updates = upd_cd + sum(u for _, u, _ in rows)
                stats.recounts = rec_cd + sum(c for _, _, c in rows)
            result = PeelResult(
                theta=theta, part=part, ranges=ranges,
                support_init=sup_init, stats=stats)

            if first:
                h, cache, lv_dirty, lv_total = hrepair.repair_hierarchy(
                    g_new, result, cfg.kind, cfg.side, cache=None,
                    level_block=cfg.level_block, device=self.device)
                stale = (0, 0)
            else:
                stale = self._stale_bound(gg_old, oc, touched)
                h, cache, lv_dirty, lv_total = hrepair.repair_hierarchy(
                    g_new, result, cfg.kind, cfg.side,
                    cache=self._label_cache, old_common=oc, new_common=nc,
                    touched_old=self._touched_mask(gg_old, touched),
                    touched_new=self._touched_mask(gg_new, touched),
                    level_block=cfg.level_block, device=self.device)
            if rsp is not None:
                rsp.update(levels_dirty=lv_dirty)
        repair_ms = (time.perf_counter() - t_rep) * 1e3

        # ---- atomic swap: readers see the old state until here
        self.g = g_new
        self.result = result
        self.hierarchy = h
        self._label_cache = cache
        # next epoch's carried ⋈init: the injected incremental vector,
        # or the spec's own fresh count when the engine recounted anyway
        self._sup0 = sup0_new if inject \
            else np.asarray(spec.sup0, dtype=np.int64).copy()
        self._pp = pp_full

        self.metrics.observe("stream.repair_ms", repair_ms)
        self.metrics.inc("repair.partitions_dirty", int(dirty.size))
        obs.counter("repair.partitions_dirty",
                    dict(dirty=int(dirty.size), total=int(p_eff)))
        rep = self._report(events, ins, dels, noop=False, dirty=dirty,
                           lv_dirty=lv_dirty, repair_ms=repair_ms, t0=t0,
                           stale=stale)
        if sp is not None:
            sp.update(partitions_dirty=int(dirty.size),
                      repair_ms=repair_ms)
        return rep

    # --------------------------------------------------------------- helpers
    def _touched_mask(self, gg: BipartiteGraph, touched) -> np.ndarray:
        cfg = self.config
        if cfg.kind == "tip":
            mask = np.zeros(gg.n_u, dtype=bool)
            for u in touched:
                if 0 <= u < gg.n_u:
                    mask[u] = True
            return mask
        mask = np.zeros(gg.m, dtype=bool)
        if touched:
            codes = sdelta.edge_codes(gg)
            keys = np.asarray(
                [u * gg.n_v + v for (u, v) in touched], dtype=np.int64)
            pos = np.searchsorted(codes, keys)
            pos_c = np.minimum(pos, max(codes.size - 1, 0))
            has = (codes.size > 0) & (codes[pos_c] == keys)
            mask[pos_c[has]] = True
        return mask

    def _stale_bound(self, gg_old, oc, touched) -> Tuple[int, int]:
        """Old-forest blast radius: nodes + entity-slice bound of the
        region whose answers may go stale while this epoch repairs."""
        if self.hierarchy is None:
            return 0, 0
        t_old = self._touched_mask(gg_old, touched)
        affected = np.ones(t_old.size, dtype=bool)
        affected[oc] = False        # deleted entities
        affected |= t_old
        ids = np.where(affected)[0]
        nodes, slices = hrepair.dirty_subtrees(self.hierarchy, ids)
        return int(nodes.size), int(sum(hi - lo for lo, hi in slices))

    def _report(self, events, ins, dels, noop, dirty, lv_dirty,
                repair_ms, t0, stale) -> EpochReport:
        res = self.result
        lv_total = int(self.hierarchy.levels.size) if self.hierarchy \
            is not None else 0
        return EpochReport(
            epoch=self.epoch,
            n_events=len(events),
            n_inserts=int(ins.shape[0]),
            n_deletes=int(dels.shape[0]),
            noop=noop,
            p_eff=int(res.stats.p_effective) if res is not None else 0,
            partitions_dirty=int(dirty.size),
            levels_dirty=int(lv_dirty),
            levels_total=lv_total,
            stale_nodes=int(stale[0]),
            stale_entities=int(stale[1]),
            repair_ms=float(repair_ms),
            epoch_ms=(time.perf_counter() - t0) * 1e3,
            theta_max=int(res.theta.max()) if res is not None
            and res.theta.size else 0,
        )

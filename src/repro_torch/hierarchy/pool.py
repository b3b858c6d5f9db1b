"""Shape-bucketed multi-tenant forest pool with an LRU artifact cache.

One :class:`~repro_torch.hierarchy.serve.HierarchyService` serves ONE
forest; production traffic is many tenant graphs (per-category,
per-region, per-time-window) behind one endpoint.  :class:`ForestPool`
holds many packed forests at once, stacked so that one batched dispatch
can answer a mixed-tenant batch:

* **Shape buckets** — tenants land in quarter-power-of-two buckets over
  ``(n_nodes, n_entities)`` (the same
  :func:`~repro_torch.core.peelspec._bucket_pad` that pads the FD
  partition stacks).  Every tenant of a bucket pads to the bucket shape
  and stacks on a leading *slot* axis, so the dispatch is a function of
  the bucket, not the tenant: admitting a tenant into a free slot
  changes tensor *values*, never shapes or storage — the dispatch
  signature count of :mod:`~repro_torch.hierarchy.multiserve` does not
  move, and the bucket's tensors keep their ``data_ptr()``.
* **Static lifting depth** — the binary-lifting ``J`` is derived from
  the bucket's padded node count (depth < n_nodes always), not from any
  tenant's actual depth, so it cannot vary within a bucket.  Extra
  levels are identity lifts past the root — answer-equivalent.
* **LRU artifact cache** — cold tenants load from the versioned npz
  artifacts (:mod:`~repro_torch.hierarchy.serialize`) into a free slot;
  when the pool is full the least-recently-used tenant is evicted.
  Eviction is pinned-aware and never drops a tenant with queued slots
  (in-flight queries), so a cold load can never invalidate a batch it
  is part of.  v2 artifacts carry the pack cache (depth + lifting
  table), making a cold load pure array reads + one device upload.
* **Per-slot admission upload** — admitting into a bucket that is
  already on the device copies just that tenant's slot row into the
  bucket's tensors in place (O(row) transfer) instead of dirtying the
  whole bucket; ``slot_upload=False`` restores the whole-bucket
  re-upload (the JAX package's A/B knob).  Timed into the
  ``pool.admission_upload_ms`` / ``pool.bucket_upload_ms`` metrics,
  after a device synchronise.

Capacity model: ``slots`` bounds the number of *resident tenants*
across all buckets.  Bucket tensors grow in power-of-two slot-capacity
steps (``min(4, slots)``, then doubling: a new dispatch signature per
(bucket, capacity), as the JAX package compiles one) and are reused for
the life of the pool; eviction frees a slot in place.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.peelspec import _bucket_pad
from ..device import resolve_device
from .build import Hierarchy
from .query import PackedForest, depth_and_up, extend_up, pack_forest
from .serialize import load_hierarchy

__all__ = ["BucketKey", "ForestPool", "PoolFull", "TenantMeta"]

# tensors stacked per bucket, in dispatch-argument order: name →
# shape kind; "e" = entity-padded, "n" = node-padded, "nJ" =
# (node-padded, J) lifting table
_STACK_FIELDS = (
    ("theta", "e"),
    ("entity_node", "e"),
    ("node_level", "n"),
    ("depth", "n"),
    ("node_size", "n"),
    ("up", "nJ"),
)

BucketKey = Tuple[int, int]


class PoolFull(RuntimeError):
    """Every resident tenant is pinned or has queued slots — nothing is
    evictable, so a new tenant cannot be admitted."""


@dataclasses.dataclass
class TenantMeta:
    """Dims + bookkeeping for one tenant; survives eviction so bounds
    validation and re-admission never need the artifact header."""

    n_nodes: int
    n_entities: int
    bucket: BucketKey
    resident: bool = False
    slot: int = -1
    last_used: int = 0      # LRU clock tick of the last touch
    pinned: bool = False
    queued: int = 0         # in-flight query slots referencing this tenant


@dataclasses.dataclass
class _Bucket:
    key: BucketKey
    J: int
    cap: int
    host: Dict[str, np.ndarray]
    tenants: List[Optional[str]]
    device: Optional[Dict[str, torch.Tensor]] = None  # lazy, None = dirty


def _bucket_key(n_nodes: int, n_entities: int) -> BucketKey:
    """Quarter-pow2 bucket over (n_nodes, n_entities) — the dispatch
    shape.  Floors keep degenerate forests in one tiny bucket."""
    return (_bucket_pad(max(n_nodes, 1), floor=8),
            _bucket_pad(max(n_entities, 1), floor=8))


def _bucket_J(n_pad: int) -> int:
    """Static lifting depth of a bucket: tree depth < n_nodes ≤ n_pad,
    so ceil(log2(n_pad)) levels always suffice."""
    return max(1, (int(n_pad) - 1).bit_length())


def _pack_tenant(h: Hierarchy, n_pad: int, e_pad: int, J: int
                 ) -> Dict[str, np.ndarray]:
    """One tenant's slot row: the :func:`pack_forest` arrays padded to
    the bucket shape (zero padding — padded ids are rejected host-side
    before any dispatch, so the values never reach an answer)."""
    n = h.n_nodes
    depth = np.asarray(h.meta.get("pack_depth", ()), dtype=np.int32)
    up = np.asarray(h.meta.get("pack_up", ()), dtype=np.int32)
    if depth.shape != (n,) or up.ndim != 2 or up.shape[0] != n:
        depth, up = depth_and_up(np.asarray(h.parent), J=J)
    up = extend_up(up, J)
    row = dict(
        theta=h.theta.astype(np.int32) if h.n_entities
        else np.zeros(0, np.int32),
        entity_node=h.entity_node.astype(np.int32) if h.n_entities
        else np.zeros(0, np.int32),
        node_level=h.node_level.astype(np.int32),
        depth=depth,
        node_size=(h.eend - h.estart).astype(np.int32),
        up=up,
    )
    out = {}
    for name, kind in _STACK_FIELDS:
        a = row[name]
        if kind == "nJ":
            pad = np.zeros((n_pad, J), np.int32)
            pad[:a.shape[0], :] = a
        else:
            size = e_pad if kind == "e" else n_pad
            pad = np.zeros(size, np.int32)
            pad[:a.shape[0]] = a
        out[name] = pad
    return out


class ForestPool:
    """LRU pool of packed forests, stacked per shape bucket.

    Args: ``slots`` — resident-tenant budget across all buckets;
    ``artifact_dir`` — directory of ``<tenant>.npz`` hierarchy
    artifacts for cold loads (optional: tenants can also be admitted
    in-memory via :meth:`add`); ``metrics`` — a shared registry;
    ``slot_upload`` — per-slot admission upload (default) or the
    whole-bucket re-upload; ``device`` — where every bucket's tensors
    live (default the card; no fallback to the CPU where there is none).

    Example::

        pool = ForestPool(slots=64, artifact_dir="/data/hierarchies")
        pool.ensure("electronics")        # cold: loads + admits
        pool.ensure("electronics")        # hot: LRU touch only
        pool.pin("electronics")           # never evicted
    """

    def __init__(self, slots: int = 64,
                 artifact_dir: Optional[str] = None,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 slot_upload: bool = True, device="cuda"):
        if slots < 1:
            raise ValueError("pool needs at least one slot")
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.artifact_dir = artifact_dir
        self.buckets: Dict[BucketKey, _Bucket] = {}
        self.meta: Dict[str, TenantMeta] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.load_seconds = 0.0
        # pool.* serving metrics (shared with MultiTenantService when it
        # wraps this pool); counters mirror the plain-int fields above
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.slot_upload = bool(slot_upload)

    # ------------------------------------------------------------ admin
    @property
    def resident_count(self) -> int:
        """Number of tenants currently holding a slot."""
        return sum(m.resident for m in self.meta.values())

    def resident(self, tenant: str) -> bool:
        """Whether ``tenant`` currently holds a pool slot."""
        m = self.meta.get(tenant)
        return bool(m and m.resident)

    def tenants(self) -> List[str]:
        """Resident tenant ids (no particular order)."""
        return [t for t, m in self.meta.items() if m.resident]

    def pin(self, tenant: str) -> None:
        """Exempt ``tenant`` from eviction (loads it if cold)."""
        self.ensure(tenant)
        self.meta[tenant].pinned = True

    def unpin(self, tenant: str) -> None:
        """Re-admit ``tenant`` to the eviction candidate set."""
        if tenant in self.meta:
            self.meta[tenant].pinned = False

    def touch(self, tenant: str) -> None:
        """Mark ``tenant`` most-recently-used (dispatch does this for
        every distinct tenant of a batch)."""
        self._clock += 1
        self.meta[tenant].last_used = self._clock

    def note_queued(self, tenant: str, delta: int) -> None:
        """Track in-flight query slots: a tenant with ``queued > 0`` is
        never an eviction candidate."""
        m = self.meta[tenant]
        m.queued += delta
        if m.queued < 0:
            raise RuntimeError(f"tenant {tenant!r}: queued count below 0")

    def stats(self) -> Dict:
        """Cache counters: hits/misses/evictions, resident count, and
        cumulative artifact-load seconds."""
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions,
                    resident=self.resident_count,
                    load_seconds=self.load_seconds)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------- admission
    def add(self, tenant: str, h: Hierarchy) -> Tuple[BucketKey, int]:
        """Admit an in-memory hierarchy as ``tenant`` (the cold-load
        path calls this after reading the artifact).  Returns the
        ``(bucket, slot)`` the tenant landed in."""
        m = self.meta.get(tenant)
        if m and m.resident:
            raise ValueError(f"tenant {tenant!r} already resident")
        key = _bucket_key(h.n_nodes, h.n_entities)
        slot = self._claim_slot(key)
        bucket = self.buckets[key]
        row = _pack_tenant(h, key[0], key[1], bucket.J)
        for name, _ in _STACK_FIELDS:
            bucket.host[name][slot] = row[name]
        if self.slot_upload and bucket.device is not None:
            # copy ONE slot row into the bucket's tensors in place —
            # O(row) transfer, same storage, instead of dirtying the
            # bucket and re-uploading all cap × row bytes
            t0 = time.perf_counter()
            for name, _ in _STACK_FIELDS:
                bucket.device[name][slot].copy_(torch.from_numpy(row[name]))
            self._sync()
            self.metrics.observe("pool.admission_upload_ms",
                                 (time.perf_counter() - t0) * 1e3)
        else:
            bucket.device = None                  # dirty: re-upload
        bucket.tenants[slot] = tenant
        self.meta[tenant] = TenantMeta(
            n_nodes=h.n_nodes, n_entities=h.n_entities, bucket=key,
            resident=True, slot=slot,
            pinned=m.pinned if m else False,
            queued=m.queued if m else 0,
        )
        self.touch(tenant)
        return key, slot

    def ensure(self, tenant: str) -> Tuple[BucketKey, int]:
        """Hot path: LRU-touch a resident tenant.  Cold path: load its
        artifact from ``artifact_dir`` into a free slot (evicting the
        LRU evictable tenant if the pool is full).  Returns
        ``(bucket, slot)``."""
        m = self.meta.get(tenant)
        if m and m.resident:
            self.hits += 1
            self.metrics.inc("pool.hits")
            self.touch(tenant)
            return m.bucket, m.slot
        self.misses += 1
        self.metrics.inc("pool.misses")
        if self.artifact_dir is None:
            raise KeyError(
                f"tenant {tenant!r} not resident and the pool has no "
                "artifact_dir to load it from")
        path = os.path.join(self.artifact_dir, f"{tenant}.npz")
        if not os.path.exists(path):
            raise KeyError(f"no artifact for tenant {tenant!r}: {path}")
        t0 = time.perf_counter()
        with obs.span("pool.cold_load", cat="serve", tenant=tenant):
            out = self.add(tenant, load_hierarchy(path))
        dt = time.perf_counter() - t0
        self.load_seconds += dt
        self.metrics.observe("pool.load_ms", dt * 1e3)
        self.metrics.set_gauge("pool.resident", self.resident_count)
        return out

    def evict(self, tenant: str) -> None:
        """Drop ``tenant`` from its slot (explicit eviction; refuses
        pinned tenants and tenants with queued slots)."""
        m = self.meta.get(tenant)
        if not (m and m.resident):
            return
        if m.pinned:
            raise ValueError(f"tenant {tenant!r} is pinned")
        if m.queued:
            raise ValueError(f"tenant {tenant!r} has queued slots")
        self.buckets[m.bucket].tenants[m.slot] = None
        m.resident = False
        m.slot = -1
        self.evictions += 1
        self.metrics.inc("pool.evictions")
        self.metrics.set_gauge("pool.resident", self.resident_count)

    def _claim_slot(self, key: BucketKey) -> int:
        """Find a free slot for a tenant of bucket ``key``: free slot →
        use it; budget left → grow the bucket (one-time new shape);
        else evict the LRU evictable tenant and retry."""
        while True:
            bucket = self.buckets.get(key)
            if bucket is not None:
                for i, t in enumerate(bucket.tenants):
                    if t is None and self.resident_count < self.slots:
                        return i
            if self.resident_count < self.slots:
                return self._grow(key)
            self._evict_lru()

    def _grow(self, key: BucketKey) -> int:
        bucket = self.buckets.get(key)
        if bucket is None:
            cap = min(4, self.slots)
            J = _bucket_J(key[0])
            host = {}
            for name, kind in _STACK_FIELDS:
                shape = ((cap, key[0], J) if kind == "nJ" else
                         (cap, key[1] if kind == "e" else key[0]))
                host[name] = np.zeros(shape, np.int32)
            self.buckets[key] = _Bucket(
                key=key, J=J, cap=cap, host=host, tenants=[None] * cap)
            return 0
        slot = bucket.cap
        new_cap = bucket.cap * 2
        for name in bucket.host:
            old = bucket.host[name]
            grown = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            grown[:bucket.cap] = old
            bucket.host[name] = grown
        bucket.tenants.extend([None] * (new_cap - bucket.cap))
        bucket.cap = new_cap
        bucket.device = None
        return slot

    def _evict_lru(self) -> None:
        candidates = [
            (m.last_used, t) for t, m in self.meta.items()
            if m.resident and not m.pinned and m.queued == 0
        ]
        if not candidates:
            raise PoolFull(
                f"all {self.resident_count} resident tenants are pinned "
                "or have queued slots; raise --pool-slots")
        _, victim = min(candidates)
        self.evict(victim)

    # ------------------------------------------------------- dispatch IO
    def bucket_arrays(self, key: BucketKey) -> Dict[str, torch.Tensor]:
        """Device view of a bucket's stacked tensors (uploaded lazily,
        re-uploaded only after an admission dirtied the bucket).  The
        upload copies, so the device tensors never alias the host
        mirror, on the CPU either."""
        bucket = self.buckets[key]
        if bucket.device is None:
            t0 = time.perf_counter()
            bucket.device = {
                name: torch.from_numpy(arr).to(self.device, copy=True)
                for name, arr in bucket.host.items()
            }
            self._sync()
            self.metrics.observe("pool.bucket_upload_ms",
                                 (time.perf_counter() - t0) * 1e3)
        return bucket.device

    def forest_of(self, tenant: str) -> PackedForest:
        """Single-tenant :class:`PackedForest` rebuilt from the
        tenant's artifact on the pool's device — the per-tenant oracle
        the parity tests compare the pooled dispatch against."""
        self.ensure(tenant)
        path = os.path.join(self.artifact_dir or "", f"{tenant}.npz")
        return pack_forest(load_hierarchy(path), device=self.device)

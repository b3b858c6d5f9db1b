"""Cross-tenant slot-batched hierarchy serving over a ForestPool.

:class:`MultiTenantService` is
:class:`~repro_torch.hierarchy.serve.HierarchyService` lifted to many
tenants: every queue entry carries ``(tenant, op, a, b)``, the engine
groups queued slots by the tenant's *shape bucket*, and ONE batched
dispatch per bucket chunk answers every tenant in it.  The dispatch is
``serve._answer_batch`` with a leading tenant index — each slot first
selects its tenant's row of the bucket's stacked tensors, then runs the
same branchless answer-family select, so answers are bit-identical to a
per-tenant ``HierarchyService``.

**One compile per bucket, counted.**  The JAX package compiles one XLA
program per dispatch signature and states its zero-retrace invariant on
the jit cache's size.  Torch has no compile cache: the dispatch is the
same fixed sequence of gathers and selects for every call of one
signature (bucket shape, slot capacity, ``J``, batch), so
:func:`compiled_dispatch_count` counts the distinct signatures seen —
exactly what JAX's cache keys on — and :func:`reset_dispatch_count`
clears it.  A cold load into a free slot of a device-resident bucket
moves neither the count nor the bucket tensors' storage.

Cold tenants are loaded through the pool's LRU artifact cache at
submit time; loading cannot evict any tenant that still has queued
slots, so a batch can never be invalidated by its own admissions.
Ids are validated on the host against each tenant's true dims before
any dispatch (vectorised over the batch), and each answer family
gathers with its ids clamped into its own table: on the card an
out-of-range gather is a device-side assert, where JAX clamps.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import obs
from .pool import BucketKey, ForestPool
from .serve import _OP_NAMES, OPS

__all__ = ["MTQuery", "MultiTenantService", "compiled_dispatch_count",
           "reset_dispatch_count"]

# distinct dispatch signatures seen in this process: the counterpart of
# the JAX package's jit cache of ``_answer_batch_multi``
_SIGNATURES: Set[Tuple] = set()


@dataclasses.dataclass
class MTQuery:
    """One query against one tenant; ``result`` is filled by the engine."""

    uid: int
    tenant: str
    op: str
    a: int
    b: int = 0
    result: Optional[int] = None
    done: bool = False


def _lca_multi(up, depth, t, x, y, J: int):
    """Binary-lifting LCA with a leading tenant index: the algebra of
    ``query._lca``, every gather routed through tenant row ``t``."""
    dx = depth[t, x]
    dy = depth[t, y]
    swap = dy > dx
    a = torch.where(swap, y, x)
    b = torch.where(swap, x, y)
    diff = depth[t, a] - depth[t, b]
    for j in range(J):                     # lift a to b's depth
        a = torch.where((diff >> j) & 1 > 0, up[t, a, j].to(torch.int64), a)
    eq = a == b
    for j in range(J - 1, -1, -1):         # descend to just below LCA
        ua = up[t, a, j].to(torch.int64)
        ub = up[t, b, j].to(torch.int64)
        ne = (ua != ub) & ~eq
        a = torch.where(ne, ua, a)
        b = torch.where(ne, ub, b)
    return torch.where(eq, a, up[t, a, 0].to(torch.int64))


def _answer_batch_multi(theta, entity_node, node_level, depth, node_size,
                        up, tenant, ops, a, b, J: int):
    """``serve._answer_batch`` with a leading tenant index: tensors are
    (slots, …) stacks, ``tenant`` routes each query slot to its row.
    Every family gathers with its ids clamped into its own table (a
    slot reads only the family of its op, whose ids were checked
    against the tenant's true dims); the first matching op wins, -1 if
    none, as ``jnp.select``.  Records the call's signature."""
    _SIGNATURES.add((tuple(theta.shape), tuple(node_size.shape),
                     tuple(up.shape), int(ops.shape[0]), int(J),
                     theta.device.type))
    t = tenant.to(torch.int64)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    ae = a.clamp(0, theta.shape[1] - 1)
    be = b.clamp(0, theta.shape[1] - 1)
    an = a.clamp(0, node_size.shape[1] - 1)
    ea = entity_node[t, ae].to(torch.int64)
    lca = _lca_multi(up, depth, t, ea, entity_node[t, be].to(torch.int64), J)
    answers = {
        "max_k": theta[t, ae],
        "node_of": ea,
        "lca_node": lca,
        "lca_level": node_level[t, lca],
        "subtree_size": node_size[t, an],
    }
    assert answers.keys() == OPS.keys()
    out = torch.full_like(ops, -1, dtype=torch.int32)
    for name in reversed(list(answers)):
        out = torch.where(ops == OPS[name], answers[name].to(torch.int32), out)
    return out


def compiled_dispatch_count() -> int:
    """Number of distinct multi-tenant dispatch signatures — one per
    (bucket shape, slot capacity, ``J``, batch) the process has served,
    the JAX package's compiled-program count.  The zero-retrace
    invariant is stated on this counter: cold-loading a tenant into an
    existing bucket must not change it."""
    return len(_SIGNATURES)


def reset_dispatch_count() -> None:
    """Forget every signature seen (``_clear_cache`` of the JAX jit)."""
    _SIGNATURES.clear()


def _tenant_counts(tenants: Sequence[str]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for t in tenants:
        counts[t] = counts.get(t, 0) + 1
    return counts


class MultiTenantService:
    """Slot-batched mixed-op serving across every tenant of a pool.

    ``batch`` is the slot count of each dispatch; queued queries are
    grouped per shape bucket and padded with no-op slots, so one
    dispatch signature per bucket serves any query/tenant mix.  The
    tensors live on the pool's device.

    Example::

        pool = ForestPool(slots=8, artifact_dir="/data/hierarchies")
        svc = MultiTenantService(pool, batch=256)
        svc.submit(MTQuery(uid=0, tenant="books", op="max_k", a=3))
        svc.submit(MTQuery(uid=1, tenant="games", op="lca_level", a=1, b=7))
        print([q.result for q in svc.run()])
    """

    def __init__(self, pool: ForestPool, batch: int = 1024):
        self.pool = pool
        self.batch = int(batch)
        self.queue: Deque[MTQuery] = deque()
        self.served = 0
        self.dispatches = 0
        # shares the pool's registry: one snapshot covers cache + serve
        self.metrics = pool.metrics

    # ------------------------------------------------------------ admin
    def _check_ids(self, tenants, ops, a, b) -> None:
        """Bounds-check every slot against its TENANT's true dims (not
        the padded bucket shape — an id past the tenant's real range
        would read another tenant's padding and answer confidently
        wrong), vectorised over the batch; raises for the first failing
        slot, with the JAX package's exception and text."""
        dims = {t: (self.pool.meta[t].n_nodes, self.pool.meta[t].n_entities)
                for t in dict.fromkeys(tenants)}
        n_nodes = np.fromiter((dims[t][0] for t in tenants), np.int64,
                              len(tenants))
        n_ent = np.fromiter((dims[t][1] for t in tenants), np.int64,
                            len(tenants))
        bad_op = (ops < 0) | (ops >= len(OPS))
        a_lim = np.where(ops == OPS["subtree_size"], n_nodes, n_ent)
        pair = (ops == OPS["lca_node"]) | (ops == OPS["lca_level"])
        bad = bad_op | (a < 0) | (a >= a_lim)
        bad |= pair & ((b < 0) | (b >= n_ent))
        if not bad.any():
            return
        i = int(np.argmax(bad))
        if bad_op[i]:
            raise KeyError(int(ops[i]))
        raise ValueError(
            f"query id out of range: tenant={tenants[i]} "
            f"op={_OP_NAMES[int(ops[i])]} a={int(a[i])} b={int(b[i])} "
            f"(n_entities={n_ent[i]}, n_nodes={n_nodes[i]})")

    def submit(self, q: MTQuery) -> None:
        """Queue one query; the tenant is ensured resident (cold load
        through the LRU cache) and protected from eviction until its
        batch retires."""
        self.pool.ensure(q.tenant)
        if q.op not in OPS:
            raise ValueError(f"unknown op {q.op!r} (choose from {set(OPS)})")
        self._check_ids([q.tenant], np.asarray([OPS[q.op]]),
                        np.asarray([q.a]), np.asarray([q.b]))
        self.pool.note_queued(q.tenant, +1)
        self.queue.append(q)
        self.metrics.set_gauge("serve.queue_depth", len(self.queue))

    def pending(self) -> int:
        """Number of queued queries not yet served by :meth:`run`."""
        return len(self.queue)

    # ------------------------------------------------------------ serve
    def query_batch(
        self, tenants: Sequence[str], ops: np.ndarray, a: np.ndarray,
        b: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Raw batched entry: parallel arrays of tenant ids, op codes
        and args → int32 answers.  Slots are grouped by shape bucket
        and each group dispatches in fixed ``batch``-slot chunks.
        :meth:`run` wraps it."""
        ops = np.asarray(ops, dtype=np.int32)
        a = np.asarray(a, dtype=np.int32)
        b = np.zeros_like(a) if b is None else np.asarray(b, dtype=np.int32)
        tenants = list(tenants)
        if not (len(tenants) == ops.size == a.size == b.size):
            raise ValueError("tenants/ops/a/b must be parallel arrays")
        distinct = list(dict.fromkeys(tenants))
        # pin every already-known tenant against eviction BEFORE any
        # cold load: an admission mid-batch must not drop another
        # tenant whose slots ride in this same batch
        pinned = [t for t in distinct if t in self.pool.meta]
        for t in pinned:
            self.pool.note_queued(t, +1)
        try:
            for t in distinct:
                self.pool.ensure(t)
                if t not in pinned:
                    self.pool.note_queued(t, +1)
                    pinned.append(t)
            self._check_ids(tenants, ops, a, b)
            return self._dispatch_grouped(tenants, ops, a, b)
        finally:
            for t in pinned:
                self.pool.note_queued(t, -1)

    def _launch(self, arrs, J: int, cols: np.ndarray) -> torch.Tensor:
        """One bucket chunk on the device: ``arrs`` are the bucket's
        tensors, ``cols`` the (4, batch) int32 host array of tenant
        slots, op codes, a and b.  Queues an asynchronous copy (pinned
        host memory on the card) and the gathers; nothing here waits for
        the device — the caller's result copy is the one synchronisation
        of a dispatch."""
        dev = self.pool.device
        host = torch.from_numpy(cols)
        if dev.type == "cuda":
            host = host.pin_memory().to(dev, non_blocking=True)
        t_sl, op_c, a_c, b_c = host
        return _answer_batch_multi(
            arrs["theta"], arrs["entity_node"], arrs["node_level"],
            arrs["depth"], arrs["node_size"], arrs["up"],
            t_sl, op_c, a_c, b_c, J)

    def _dispatch_grouped(self, tenants, ops, a, b) -> np.ndarray:
        """Group validated slots by bucket, dispatch each group in
        fixed-size padded chunks, scatter answers back to slot order."""
        out = np.zeros(len(tenants), np.int32)
        meta = {t: self.pool.meta[t] for t in dict.fromkeys(tenants)}
        # buckets in order of first appearance, slots in order within
        keys = list(dict.fromkeys(m.bucket for m in meta.values()))
        key_id = {k: i for i, k in enumerate(keys)}
        slot = np.fromiter((meta[t].slot for t in tenants), np.int32,
                           len(tenants))
        group = np.fromiter((key_id[meta[t].bucket] for t in tenants),
                            np.int32, len(tenants))
        for g, key in enumerate(keys):
            idx = np.flatnonzero(group == g)
            # a new, grown or dirty bucket uploads here, outside the
            # timed dispatch, as in the JAX package
            arrs = self.pool.bucket_arrays(key)
            J = self.buckets_J(key)
            for lo in range(0, idx.size, self.batch):
                chunk = idx[lo:lo + self.batch]
                n = chunk.size
                # pad with subtree_size(node 0) on tenant-slot 0 — the
                # root always exists for a resident tenant, and a free
                # slot 0 is all zeros (answer 0, masked out anyway)
                cols = np.zeros((4, self.batch), np.int32)
                cols[1] = OPS["subtree_size"]
                cols[0, :n] = slot[chunk]
                cols[1, :n] = ops[chunk]
                cols[2, :n] = a[chunk]
                cols[3, :n] = b[chunk]
                t0 = time.perf_counter()
                with obs.span("serve.dispatch", cat="serve",
                              bucket=list(key), n=n):
                    res = self._launch(arrs, J, cols)
                    out[chunk] = res[:n].cpu().numpy()
                self.metrics.observe("serve.dispatch_ms",
                                     (time.perf_counter() - t0) * 1e3)
                self.metrics.inc("serve.dispatches")
                self.metrics.inc("serve.slots_padded", self.batch - n)
                self.dispatches += 1
                self.served += n
        self.metrics.inc("serve.served", len(tenants))
        for t, cnt in _tenant_counts(tenants).items():
            self.metrics.inc(f"serve.tenant.{t}", cnt)
        return out

    def buckets_J(self, key: BucketKey) -> int:
        """The bucket's static binary-lifting depth (part of the
        dispatch signature)."""
        return self.pool.buckets[key].J

    def run(self) -> List[MTQuery]:
        """Drain the queue; returns completed queries in uid order (the
        ContinuousBatcher contract, like ``HierarchyService.run``)."""
        todo = list(self.queue)
        self.queue.clear()
        self.metrics.set_gauge("serve.queue_depth", 0)
        if todo:
            res = self._dispatch_grouped(
                [q.tenant for q in todo],
                np.asarray([OPS[q.op] for q in todo], np.int32),
                np.asarray([q.a for q in todo], np.int32),
                np.asarray([q.b for q in todo], np.int32),
            )
            for q, r in zip(todo, res):
                q.result = int(r)
                q.done = True
                self.pool.note_queued(q.tenant, -1)
        return sorted(todo, key=lambda q: q.uid)

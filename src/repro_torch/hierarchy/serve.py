"""Batched hierarchy query engine — decomposition-as-a-service.

:class:`HierarchyService` takes requests into a queue and drains them in
fixed-size *slot batches*; one batched call answers a whole batch from
the forest's device tensors.  Slot occupancy is data (a padded tail of
no-op queries), not shape.

Mixed ops ride in one batch: every answer family is computed for every
slot (gathers + one binary-lifting LCA) and each slot picks its own by
op code — branchless, so mixed batches cost the same as homogeneous
ones.  Ids are checked on the host before dispatch: an out-of-range
gather faults on the card (JAX would clamp it into a wrong answer).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Union

import numpy as np
import torch

from .build import Hierarchy
from .query import PackedForest, _lca, pack_forest, subgraph_at

__all__ = ["OPS", "HQuery", "HierarchyService"]

# op code → semantics ("a"/"b" are entity ids unless noted)
OPS = dict(
    max_k=0,          # largest k whose k-subgraph contains entity a
    node_of=1,        # deepest hierarchy node containing entity a
    lca_node=2,       # smallest common dense subgraph of entities a, b
    lca_level=3,      # ... and its level k
    subtree_size=4,   # entity count of node a's subgraph (a = node id)
)
_OP_NAMES = {v: k for k, v in OPS.items()}


@dataclasses.dataclass
class HQuery:
    """One query; ``result`` is filled by the engine."""

    uid: int
    op: str
    a: int
    b: int = 0
    result: Optional[int] = None
    done: bool = False


def _answer_batch(theta, entity_node, node_level, depth, node_size, up,
                  ops, a, b, J: int):
    """All answer families for every slot, then a per-slot select by op
    code (the first matching op wins, as ``jnp.select``; -1 if none).
    Each family gathers with its ids clamped into its own table: a slot
    reads only the family of its op, whose ids were checked, so the
    clamp changes no selected answer and keeps every gather in range."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    ae = a.clamp(0, theta.shape[0] - 1)
    be = b.clamp(0, theta.shape[0] - 1)
    an = a.clamp(0, node_size.shape[0] - 1)
    lca = _lca(up, depth, entity_node[ae], entity_node[be], J)
    answers = {
        "max_k": theta[ae],
        "node_of": entity_node[ae],
        "lca_node": lca,
        "lca_level": node_level[lca.to(torch.int64)],
        "subtree_size": node_size[an],
    }
    assert answers.keys() == OPS.keys()
    out = torch.full_like(ops, -1, dtype=torch.int32)
    for name in reversed(list(answers)):
        out = torch.where(ops == OPS[name], answers[name].to(torch.int32), out)
    return out


class HierarchyService:
    """Slot-batched query serving over a :class:`PackedForest`.

    ``batch`` is the slot count of one dispatch; partially full batches
    pad with no-op slots (masked out on return).  The forest's tensors
    live on the device once; steady-state service is one batched call
    and one small device→host copy per batch.

    Args: ``h`` — a built :class:`Hierarchy` (packed on ``device``) or
    an already-packed forest; ``batch`` — slots per dispatch;
    ``device`` — where a :class:`Hierarchy` is packed (default the
    card).

    Example::

        from repro_torch import random_bipartite, wing_decomposition
        from repro_torch.hierarchy import (build_hierarchy,
                                           HierarchyService, HQuery)
        g = random_bipartite(200, 150, 900, seed=0)
        res = wing_decomposition(g, engine="csr", device="cpu")
        h = build_hierarchy(g, res, kind="wing", device="cpu")
        svc = HierarchyService(h, batch=256, device="cpu")
        svc.submit(HQuery(uid=0, op="max_k", a=3))
        print(svc.run()[0].result)
    """

    def __init__(self, h: Union[Hierarchy, PackedForest], batch: int = 1024,
                 device="cuda"):
        self.forest = (pack_forest(h, device=device)
                       if isinstance(h, Hierarchy) else h)
        self.batch = int(batch)
        self.queue: Deque[HQuery] = deque()
        self.served = 0
        self.dispatches = 0

    # ------------------------------------------------------------ admin
    def _check_ids(self, op_codes, a, b) -> None:
        """Host-side bounds check: an out-of-range id must be an error,
        never a gather past the end of a device tensor."""
        node_arg = op_codes == OPS["subtree_size"]
        a_lim = np.where(node_arg, self.forest.n_nodes,
                         self.forest.n_entities)
        bad = (a < 0) | (a >= a_lim)
        pair = (op_codes == OPS["lca_node"]) | (op_codes == OPS["lca_level"])
        bad |= pair & ((b < 0) | (b >= self.forest.n_entities))
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"query id out of range: op={_OP_NAMES[int(op_codes[i])]} "
                f"a={int(a[i])} b={int(b[i])} "
                f"(n_entities={self.forest.n_entities}, "
                f"n_nodes={self.forest.n_nodes})"
            )

    def submit(self, q: HQuery) -> None:
        """Fail fast at the API boundary (scalar checks — run() then
        dispatches queued queries without re-validating them)."""
        if q.op not in OPS:
            raise ValueError(f"unknown op {q.op!r} (choose from {set(OPS)})")
        a_lim = (self.forest.n_nodes if q.op == "subtree_size"
                 else self.forest.n_entities)
        bad = not 0 <= q.a < a_lim
        if q.op in ("lca_node", "lca_level"):
            bad |= not 0 <= q.b < self.forest.n_entities
        if bad:
            raise ValueError(
                f"query id out of range: op={q.op} a={q.a} b={q.b} "
                f"(n_entities={self.forest.n_entities}, "
                f"n_nodes={self.forest.n_nodes})"
            )
        self.queue.append(q)

    def pending(self) -> int:
        """Number of queued queries not yet served by :meth:`run`."""
        return len(self.queue)

    # ------------------------------------------------------------ serve
    def query_batch(
        self, ops: np.ndarray, a: np.ndarray, b: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Raw batched entry: parallel arrays of op codes and args →
        int32 answers.  ``run`` wraps it."""
        ops = np.asarray(ops, dtype=np.int32)
        a = np.asarray(a, dtype=np.int32)
        b = np.zeros_like(a) if b is None else np.asarray(b, dtype=np.int32)
        self._check_ids(ops, a, b)
        return self._dispatch(ops, a, b)

    def _dispatch(self, ops, a, b) -> np.ndarray:
        """One batched dispatch — ids must already be validated."""
        f = self.forest

        def t(x):
            return torch.from_numpy(x).to(f.device)

        out = _answer_batch(
            f.theta, f.entity_node, f.node_level, f.depth, f.node_size,
            f.up, t(ops), t(a), t(b), f.J,
        )
        self.served += int(ops.size)
        self.dispatches += 1
        return out.cpu().numpy()

    def subgraph_masks(self, nodes) -> np.ndarray:
        """Batched ``subgraph_at`` — (len(nodes), n_entities) bool.
        Separate entry point because the answer is a mask, not a
        scalar per slot."""
        nodes = np.asarray(nodes)
        if nodes.size and (
            (nodes < 0) | (nodes >= self.forest.n_nodes)
        ).any():
            raise ValueError(
                f"node id out of range (n_nodes={self.forest.n_nodes})")
        self.dispatches += 1
        out = subgraph_at(self.forest, nodes).cpu().numpy()
        self.served += out.shape[0]
        return out

    def run(self) -> List[HQuery]:
        """Drain the queue in slot batches; returns completed queries
        in uid order."""
        completed: List[HQuery] = []
        while self.queue:
            todo = [
                self.queue.popleft()
                for _ in range(min(self.batch, len(self.queue)))
            ]
            n = len(todo)
            # pad with subtree_size(root): node 0 always exists, even on
            # an entity-less hierarchy where max_k(0) would be invalid
            ops = np.full(self.batch, OPS["subtree_size"], dtype=np.int32)
            a = np.zeros(self.batch, dtype=np.int32)
            b = np.zeros(self.batch, dtype=np.int32)
            for i, q in enumerate(todo):
                ops[i] = OPS[q.op]
                a[i] = q.a
                b[i] = q.b
            # queries were validated at submit; padding is always legal
            res = self._dispatch(ops, a, b)
            self.served -= self.batch - n  # padded slots served nothing
            for i, q in enumerate(todo):
                q.result = int(res[i])
                q.done = True
            completed.extend(todo)
        return sorted(completed, key=lambda q: q.uid)

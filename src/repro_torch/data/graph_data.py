"""PBNG → LM data bridge: dense-subgraph curriculum for link prediction.

A copy of the JAX package's ``data/graph_data.py`` (numpy) on the port's
``core/analysis.py``; the one change is ``device``, passed on to the
wing peel.  Held array-equal to the original by
``tests/test_torch_analysis.py``.

The paper's applications (recommendation, spam detection, co-clustering)
consume the decomposition hierarchy.  Here we turn a user×item bipartite
graph into token sequences for the training examples:

    [USER u] [ITEM v1] [ITEM v2] ... per wing-number level,

feeding densest levels first (curriculum).
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from ..core.analysis import interaction_curriculum
from ..core.graph import BipartiteGraph

__all__ = ["curriculum_sequences", "sequence_batches"]


def curriculum_sequences(
    g: BipartiteGraph, n_levels: int = 4, P: int = 8, max_len: int = 64,
    device="cuda",
) -> List[np.ndarray]:
    """Token sequences grouped by descending density level.

    Vocabulary: [0, n_u) users, [n_u, n_u+n_v) items.
    """
    level, _ = interaction_curriculum(g, n_levels=n_levels, P=P,
                                      device=device)
    out = []
    for lv in range(n_levels - 1, -1, -1):
        edges = g.edges[level == lv]
        by_user: Dict[int, List[int]] = {}
        for u, v in edges:
            by_user.setdefault(int(u), []).append(g.n_u + int(v))
        seqs = []
        for u, items in sorted(by_user.items()):
            # chunk long histories — every interaction lands in a sequence
            for i in range(0, len(items), max_len - 1):
                seq = [u] + items[i: i + max_len - 1]
                seqs.append(np.asarray(seq, dtype=np.int32))
        out.append(seqs)
    return [s for lvl in out for s in lvl]


def sequence_batches(
    seqs: List[np.ndarray], batch: int, seq_len: int, pad: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Pack curriculum sequences into fixed (batch, seq_len) batches."""
    buf = []
    for s in seqs:
        s = s[: seq_len + 1]
        if s.size < seq_len + 1:
            s = np.concatenate(
                [s, np.full(seq_len + 1 - s.size, pad, np.int32)])
        buf.append(s)
        if len(buf) == batch:
            arr = np.stack(buf)
            yield dict(tokens=arr[:, :-1], labels=arr[:, 1:])
            buf = []
    if buf:
        while len(buf) < batch:
            buf.append(np.full(seq_len + 1, pad, np.int32))
        arr = np.stack(buf)
        yield dict(tokens=arr[:, :-1], labels=arr[:, 1:])

"""Out-of-core bipartite edge-list ingestion (the real-dataset front door).

A copy of the JAX package's ``data/ingest.py`` (host numpy, no JAX in
it): the same passes on the same bytes, so an ingest directory written
by either package loads in the other.  It builds a **degree-ordered,
memory-mapped host CSR** from a KONECT/SNAP style edge list while
holding only O(chunk + vertices) in RAM:

1. **vocab pass** — stream the file in bounded chunks, collecting the
   sorted raw-id vocabulary per side and the source sha256 (the
   ingest-cache key).
2. **dedup pass** — re-stream, compact raw ids via ``searchsorted``,
   encode each edge as one int64 key, and spill *sorted runs* of
   ``(key, net)`` pairs to the workdir.  ``net`` is the signed line
   count: a KONECT weight < 0 is a deletion event, so duplicates
   accumulate and self-cancelling lines erase each other.  The k-way
   merge keeps an edge iff its net insert count is positive, so the
   result is **invariant to chunk size and input order**.
3. **degree relabel** — vertices are renumbered by decreasing surviving
   degree (ties by compact raw-id order); vertices whose edges all
   cancelled vanish.  Degree order keeps the wedge tiles of
   ``core.csr.iter_wedge_tiles`` balanced: hubs land in the low ranks,
   where the tile boundaries isolate them.
4. **CSR passes** — two more external sorts write the U-side edge list
   (lex (u, v), edge id = row, the ``BipartiteGraph`` contract) and the
   V-side CSR (neighbors + edge ids per center) as raw memmaps.

Everything lands in an ingest directory (``<edges>.ingest`` by
default): ``edges.bin`` / ``off_u.bin`` / ``off_v.bin`` / ``nbr_v.bin``
/ ``eid_v.bin`` + ``meta.json``.  Re-ingesting the same file is a cache
hit keyed on the source sha256.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import json
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = ["IngestedGraph", "ingest_edges", "load_ingested"]

_VERSION = 1
_RUN_BLOCK = 1 << 16      # elements per buffered read while merging runs
_ID_LIMIT = 2 ** 31 - 1   # compact ids / edge ids are int32 downstream


# =====================================================================
# Streaming parse
# =====================================================================
def _parse_chunks(
    path: str, chunk_edges: int, comment: Sequence[str]
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (u_raw, v_raw, sign) int64 chunks from an edge-list file.

    Lines are ``u v [w [t]]``; a weight < 0 is a deletion event (the
    KONECT temporal convention), anything else an insertion.  Blank
    lines and comment-prefixed lines are skipped.
    """
    us, vs, sg = [], [], []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in comment:
                continue
            parts = s.split()
            us.append(int(parts[0]))
            vs.append(int(parts[1]))
            sg.append(-1 if len(parts) > 2 and float(parts[2]) < 0 else 1)
            if len(us) >= chunk_edges:
                yield (np.asarray(us, np.int64), np.asarray(vs, np.int64),
                       np.asarray(sg, np.int64))
                us, vs, sg = [], [], []
    if us:
        yield (np.asarray(us, np.int64), np.asarray(vs, np.int64),
               np.asarray(sg, np.int64))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


# =====================================================================
# External sorted runs (key int64 [+ payload int64]) + k-way merge
# =====================================================================
class _RunWriter:
    """Spill sorted (key[, payload]) chunks as numbered .npy run files."""

    def __init__(self, workdir: str, tag: str):
        self.workdir = workdir
        self.tag = tag
        self.paths: list = []

    def write(self, keys: np.ndarray, payload: Optional[np.ndarray] = None):
        if keys.size == 0:
            return
        base = os.path.join(self.workdir, f"{self.tag}.{len(self.paths)}")
        np.save(base + ".k.npy", keys)
        if payload is not None:
            np.save(base + ".p.npy", payload)
        self.paths.append(base)

    def cleanup(self):
        for base in self.paths:
            for suf in (".k.npy", ".p.npy"):
                if os.path.exists(base + suf):
                    os.remove(base + suf)
        self.paths = []


def _run_stream(base: str, with_payload: bool):
    """Yield (key, payload) tuples from one run, reading bounded blocks."""
    keys = np.load(base + ".k.npy", mmap_mode="r")
    pay = np.load(base + ".p.npy", mmap_mode="r") if with_payload else None
    n = keys.shape[0]
    for lo in range(0, n, _RUN_BLOCK):
        kb = np.asarray(keys[lo:lo + _RUN_BLOCK])
        pb = np.asarray(pay[lo:lo + _RUN_BLOCK]) if with_payload else kb
        for i in range(kb.shape[0]):
            yield int(kb[i]), int(pb[i])


def _merge_runs(writer: _RunWriter, with_payload: bool):
    """K-way merge of a writer's runs into a sorted (key, payload) stream."""
    streams = [_run_stream(b, with_payload) for b in writer.paths]
    return heapq.merge(*streams, key=lambda kv: kv[0])


def _batched(stream, size: int):
    """Chunk a (key, payload) stream into int64 array pairs."""
    while True:
        block = list(itertools.islice(stream, size))
        if not block:
            return
        yield (np.asarray([k for k, _ in block], np.int64),
               np.asarray([p for _, p in block], np.int64))


# =====================================================================
# Result container
# =====================================================================
@dataclasses.dataclass(frozen=True)
class IngestedGraph:
    """Memory-mapped degree-ordered CSR of an ingested edge list.

    Quacks like :class:`repro_torch.core.graph.BipartiteGraph` where the
    counting layer needs it (``n_u``/``n_v``/``m``/``csr_u``/``csr_v``/
    ``degrees``) but every O(m) array is a read-only memmap.  The edge
    list is lex-sorted (u, v) with edge id = row — the exact
    ``BipartiteGraph`` contract, so ⋈init vectors computed here index
    straight into the peeling engines.
    """

    n_u: int
    n_v: int
    m: int
    edges: np.ndarray      # (m, 2) int32 memmap, lex (u, v)
    off_u: np.ndarray      # (n_u+1,) int64
    off_v: np.ndarray      # (n_v+1,) int64
    nbr_v: np.ndarray      # (m,) int32 memmap — u ids per center, ascending
    eid_v: np.ndarray      # (m,) int32 memmap — edge ids per center
    meta: dict

    def degrees(self) -> Tuple[np.ndarray, np.ndarray]:
        """(U degrees, V degrees) from the CSR offsets."""
        return np.diff(self.off_u), np.diff(self.off_v)

    def csr_u(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(offsets, neighbor v ids, edge ids) — edges are u-major, so
        edge ids are just the row range."""
        return (self.off_u, self.edges[:, 1],
                np.arange(self.m, dtype=np.int32))

    def csr_v(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(offsets, neighbor u ids, edge ids) per V center."""
        return self.off_v, self.nbr_v, self.eid_v

    def as_graph(self):
        """A :class:`~repro_torch.core.graph.BipartiteGraph` view over
        the edge memmap (no copy; engines that need host scratch will
        allocate their own)."""
        from ..core.graph import BipartiteGraph

        return BipartiteGraph(self.n_u, self.n_v, self.edges)


# =====================================================================
# The pipeline
# =====================================================================
def _vocab_pass(path, chunk_edges, comment):
    vu = np.zeros(0, np.int64)
    vv = np.zeros(0, np.int64)
    n_lines = 0
    for u, v, _ in _parse_chunks(path, chunk_edges, comment):
        n_lines += u.size
        if u.size and (u.min() < 0 or v.min() < 0):
            raise ValueError("negative vertex ids in edge list")
        vu = np.union1d(vu, u)
        vv = np.union1d(vv, v)
    return vu, vv, n_lines


def _dedup_pass(path, chunk_edges, comment, vu, vv, workdir):
    """Spill sorted (key, net) runs; key = compact_u * n_v0 + compact_v."""
    n_v0 = max(vv.size, 1)
    if vu.size * n_v0 > 2 ** 62:
        raise OverflowError("vertex-id product exceeds int64 edge keys")
    w = _RunWriter(workdir, "dedup")
    for u_raw, v_raw, sg in _parse_chunks(path, chunk_edges, comment):
        key = np.searchsorted(vu, u_raw) * n_v0 + np.searchsorted(vv, v_raw)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        uniq, starts = np.unique(ks, return_index=True)
        net = np.add.reduceat(sg[order], starts) if ks.size else sg
        keep = net != 0
        w.write(uniq[keep], net[keep])
    return w


def _reduce_dedup(writer, n_u0, n_v0, workdir):
    """Merge dedup runs, keep keys with positive net; return the
    surviving key memmap + per-side degree counts (compact-raw space)."""
    bound = sum(np.load(b + ".k.npy", mmap_mode="r").shape[0]
                for b in writer.paths)
    path0 = os.path.join(workdir, "keys0.bin")
    keys0 = np.memmap(path0, dtype=np.int64, mode="w+",
                      shape=(max(bound, 1),))
    deg_u = np.zeros(max(n_u0, 1), np.int64)
    deg_v = np.zeros(max(n_v0, 1), np.int64)
    m = 0
    stream = _merge_runs(writer, with_payload=True)
    grouped = itertools.groupby(stream, key=lambda kv: kv[0])
    surviving = (k for k, grp in grouped if sum(p for _, p in grp) > 0)
    for block in _batched(((k, 0) for k in surviving), _RUN_BLOCK):
        kb = block[0]
        keys0[m:m + kb.size] = kb
        deg_u += np.bincount(kb // max(n_v0, 1), minlength=deg_u.size)
        deg_v += np.bincount(kb % max(n_v0, 1), minlength=deg_v.size)
        m += kb.size
    keys0.flush()
    writer.cleanup()
    if m > _ID_LIMIT:
        raise OverflowError("edge count exceeds int32 edge ids")
    return path0, m, deg_u, deg_v


def _degree_rank(deg: np.ndarray) -> Tuple[np.ndarray, int]:
    """rank[i] = decreasing-degree rank of compact-raw id i; isolated
    (degree-0) ids get -1 and vanish.  Stable on compact-raw order, so
    the relabel is deterministic and input-order invariant."""
    order = np.lexsort((np.arange(deg.size), -deg))
    n_kept = int((deg > 0).sum())
    rank = np.full(deg.size, -1, np.int64)
    rank[order[:n_kept]] = np.arange(n_kept)
    return rank, n_kept


def _relabel_sort(path0, m, n_v0, rank_u, rank_v, n_v, workdir, chunk):
    """Rewrite surviving keys into degree-rank space and re-sort."""
    keys0 = np.memmap(path0, dtype=np.int64, mode="r")[:max(m, 1)]
    w = _RunWriter(workdir, "relabel")
    for lo in range(0, m, chunk):
        kb = np.asarray(keys0[lo:lo + chunk])
        nk = rank_u[kb // max(n_v0, 1)] * max(n_v, 1) + rank_v[kb % max(n_v0, 1)]
        w.write(np.sort(nk))
    return w


def _emit_u_side(writer, m, n_u, n_v, workdir):
    edges = np.memmap(os.path.join(workdir, "edges.bin"), dtype=np.int32,
                      mode="w+", shape=(max(m, 1), 2))
    deg_u = np.zeros(max(n_u, 1), np.int64)
    pos = 0
    stream = _merge_runs(writer, with_payload=False)
    for kb, _ in _batched(stream, _RUN_BLOCK):
        u = kb // max(n_v, 1)
        edges[pos:pos + kb.size, 0] = u
        edges[pos:pos + kb.size, 1] = kb % max(n_v, 1)
        deg_u += np.bincount(u, minlength=deg_u.size)
        pos += kb.size
    edges.flush()
    writer.cleanup()
    off_u = np.zeros(n_u + 1, np.int64)
    np.cumsum(deg_u[:n_u], out=off_u[1:])
    off_u.tofile(os.path.join(workdir, "off_u.bin"))
    return edges


def _emit_v_side(edges, m, n_u, n_v, workdir, chunk):
    """External sort by (v, u) carrying edge ids → V-side CSR memmaps."""
    w = _RunWriter(workdir, "vside")
    for lo in range(0, m, chunk):
        eb = np.asarray(edges[lo:lo + chunk])
        key = eb[:, 1].astype(np.int64) * max(n_u, 1) + eb[:, 0]
        order = np.argsort(key, kind="stable")
        w.write(key[order], (lo + order).astype(np.int64))
    nbr = np.memmap(os.path.join(workdir, "nbr_v.bin"), dtype=np.int32,
                    mode="w+", shape=(max(m, 1),))
    eid = np.memmap(os.path.join(workdir, "eid_v.bin"), dtype=np.int32,
                    mode="w+", shape=(max(m, 1),))
    deg_v = np.zeros(max(n_v, 1), np.int64)
    pos = 0
    for kb, pb in _batched(_merge_runs(w, with_payload=True), _RUN_BLOCK):
        nbr[pos:pos + kb.size] = kb % max(n_u, 1)
        eid[pos:pos + kb.size] = pb
        deg_v += np.bincount(kb // max(n_u, 1), minlength=deg_v.size)
        pos += kb.size
    nbr.flush()
    eid.flush()
    w.cleanup()
    off_v = np.zeros(n_v + 1, np.int64)
    np.cumsum(deg_v[:n_v], out=off_v[1:])
    off_v.tofile(os.path.join(workdir, "off_v.bin"))


def load_ingested(out_dir: str) -> IngestedGraph:
    """Reopen an ingest directory written by :func:`ingest_edges`."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    n_u, n_v, m = meta["n_u"], meta["n_v"], meta["m"]

    def mm(name, dtype, shape):
        return np.memmap(os.path.join(out_dir, name), dtype=dtype,
                         mode="r", shape=shape)

    return IngestedGraph(
        n_u=n_u, n_v=n_v, m=m,
        edges=mm("edges.bin", np.int32, (max(m, 1), 2))[:m],
        off_u=np.fromfile(os.path.join(out_dir, "off_u.bin"), np.int64),
        off_v=np.fromfile(os.path.join(out_dir, "off_v.bin"), np.int64),
        nbr_v=mm("nbr_v.bin", np.int32, (max(m, 1),))[:m],
        eid_v=mm("eid_v.bin", np.int32, (max(m, 1),))[:m],
        meta=meta,
    )


def ingest_edges(
    path: str,
    out_dir: Optional[str] = None,
    chunk_edges: int = 1 << 20,
    comment: Sequence[str] = ("%", "#"),
    refresh: bool = False,
) -> IngestedGraph:
    """Ingest a KONECT/SNAP edge list out of core (see module docstring).

    ``out_dir`` defaults to ``<path>.ingest``; an existing directory
    whose recorded source sha256 matches is reused (``refresh=True``
    forces a rebuild).  ``chunk_edges`` bounds resident edge memory —
    results are bit-identical for ANY chunk size (property-tested in
    ``tests/test_torch_ingest.py``).
    """
    if out_dir is None:
        out_dir = path + ".ingest"
    os.makedirs(out_dir, exist_ok=True)
    sha = _sha256(path)
    meta_path = os.path.join(out_dir, "meta.json")
    if not refresh and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("source_sha256") == sha \
                and meta.get("version") == _VERSION \
                and meta.get("chunk_edges") == chunk_edges:
            return load_ingested(out_dir)

    chunk_edges = max(int(chunk_edges), 1)
    vu, vv, n_lines = _vocab_pass(path, chunk_edges, comment)
    n_u0, n_v0 = vu.size, vv.size
    dedup = _dedup_pass(path, chunk_edges, comment, vu, vv, out_dir)
    keys0_path, m, deg_u0, deg_v0 = _reduce_dedup(dedup, n_u0, n_v0, out_dir)
    rank_u, n_u = _degree_rank(deg_u0[:max(n_u0, 1)])
    rank_v, n_v = _degree_rank(deg_v0[:max(n_v0, 1)])
    relab = _relabel_sort(keys0_path, m, n_v0, rank_u, rank_v, n_v,
                          out_dir, chunk_edges)
    edges = _emit_u_side(relab, m, n_u, n_v, out_dir)
    _emit_v_side(edges, m, n_u, n_v, out_dir, chunk_edges)
    os.remove(keys0_path)

    meta = dict(
        version=_VERSION, source=os.path.abspath(path), source_sha256=sha,
        chunk_edges=chunk_edges, n_lines=n_lines,
        n_u=n_u, n_v=n_v, m=m,
        n_u_raw=int(n_u0), n_v_raw=int(n_v0),
        n_dropped_u=int(n_u0 - n_u), n_dropped_v=int(n_v0 - n_v),
    )
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return load_ingested(out_dir)

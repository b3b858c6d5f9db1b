"""The port's kernel front door: padded wrappers, state transfer and
launch counts.

Callers (``core/csr.py``, ``core/peel.py``, ``chip_smoke.py``) import
only this module.  Each wrapper dispatches by the device of the tensors
it is given: a CUDA tensor launches the hand-written kernel or raises, a
CPU tensor runs the plain version in ``kernels/ref.py``.  There is no
other switch.  ``pair_wedge_counts``, ``tip_slot_loss`` and
``support_update`` pad their inputs to (128, 128) multiples,
``tile_row_counts`` to (``_row_bucket``, 128), the butterfly-counting
wrappers to 128 multiples and ``pack_blooms`` to ``bb`` bloom rows and a
128-multiple of links, as the JAX package's wrappers do, so both
packages hand their kernels the same shapes.  ``flash_attention`` pads
nothing: its kernel masks the ragged edge itself.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build
from .bloom_update import bloom_update as _bloom_update
from .butterfly_count import matmul, vertex_count, vertex_count_tile
from .fd_round import fd_round_tip, fd_round_wing
from .flash_attention import flash_attention as _flash_attention
from .support_update import support_update as _support_update
from .wedge_count import wedge_count, wedge_count_tile

__all__ = [
    "bloom_update",
    "edge_wedge_matrix",
    "fd_round_tip",
    "fd_round_wing",
    "flash_attention",
    "launch_counts",
    "pack_blooms",
    "pair_wedge_counts",
    "reset_launch_counts",
    "state_from_numpy",
    "support_update",
    "tile_row_counts",
    "tip_slot_loss",
    "vertex_butterflies",
    "vertex_butterflies_tiled",
]

KERNELS = ("fd_round_wing", "fd_round_tip", "support_update", "wedge_count",
           "wedge_count_tile", "bloom_update", "vertex_count",
           "vertex_count_tile", "matmul", "flash_attention")


def launch_counts() -> dict:
    """Kernel launches made by the wrappers in this process, by kernel."""
    return {name: int(_build.LAUNCHES[name]) for name in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _build.LAUNCHES.clear()


def _pad_to(x: torch.Tensor, mult: int, dim: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _pad2(x: torch.Tensor, bp: int, bk: int) -> torch.Tensor:
    return _pad_to(_pad_to(x.to(torch.float32), bp, 0), bk, 1).contiguous()


def pair_wedge_counts(slots: torch.Tensor, bp: int = 128,
                      bk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair wedge counts W and the f32 estimate C(W, 2) of a
    pairs-major alive slot matrix (``core.csr.pack_wedge_slots``)."""
    n = slots.shape[0]
    W, bf = wedge_count(_pad2(slots, bp, bk))
    return W[:n], bf[:n]


def tip_slot_loss(vals: torch.Tensor, bp: int = 128,
                  bk: int = 128) -> torch.Tensor:
    """Per-row f32 sums of the vertex-major slot matrix of masked pair
    butterflies (``core.csr.pack_tip_slots``) — the tip CD support
    delta.  Exact while the sums stay below 2²⁴ (guarded at pack
    time)."""
    n = vals.shape[0]
    W, _ = wedge_count(_pad2(vals, bp, bk))
    return W[:n]


def _row_bucket(n: int, mult: int) -> int:
    """Round n up to a quarter-pow2 bucket (a multiple of ``mult``):
    {1, 1.25, 1.5, 1.75}·2^k, the JAX package's buckets.  Tile row
    counts vary per tile; bucketing keeps the caching allocator on a
    handful of block sizes (O(log n)) while wasting < 25 % rows."""
    n = max(int(n), mult)
    p = 1 << (n - 1).bit_length()      # smallest pow2 >= n
    half = p // 2
    for q in (4, 5, 6, 7):
        cand = -(-(half * q // 4) // mult) * mult
        if cand >= n:
            return cand
    return -(-p // mult) * mult


def tile_row_counts(slots: torch.Tensor, n=None, bp: int = 8,
                    bk: int = 128) -> torch.Tensor:
    """Exact int32 row sums of the first ``n`` rows (default: all) of an
    int32 0/1 slot matrix — the per-tile count of the tiled ⋈init
    (``core.csr.tiled_butterfly_init``), whose rows are fixed-width
    segments of one pair's wedge flags.  The matrix is padded to
    ``_row_bucket(n, bp)`` rows and a multiple of ``bk`` columns unless
    it already has that shape (the tiled init allocates it so)."""
    n = slots.shape[0] if n is None else int(n)
    rows = _row_bucket(n, bp)
    if slots.shape[0] < rows or slots.shape[1] % bk:
        slots = _pad_to(_pad_to(slots[:n].to(torch.int32), rows, 0), bk, 1)
    return wedge_count_tile(slots.contiguous(), n)


def support_update(pe1, pe2, alive, W, bp: int = 128, bk: int = 128):
    """Widow/survivor round over (n, K) pairs-major slot flags and the
    per-row alive wedge counts W.  Returns f32 (contrib1, contrib2, c)
    trimmed back to the input shape."""
    n, kdim = pe1.shape
    c1, c2, c = _support_update(
        _pad2(pe1, bp, bk), _pad2(pe2, bp, bk), _pad2(alive, bp, bk),
        _pad_to(W.to(torch.float32), bp, 0).contiguous())
    return c1[:n, :kdim], c2[:n, :kdim], c[:n]


def vertex_butterflies(A: torch.Tensor, bm: int = 128,
                       bn: int = 128) -> torch.Tensor:
    """Per-row butterfly counts (f32) of a 0/1 adjacency through the
    fused ``vertex_count`` kernel; rows padded to ``bm``/``bn`` and
    columns to 128 multiples, as the JAX wrapper pads."""
    n = A.shape[0]
    Ap = _pad_to(_pad_to(A.to(torch.float32), bm, 0), 128, 1)
    # rows must also tile by bn for the column blocks of W
    Ap = _pad_to(Ap, bn, 0).contiguous()
    return vertex_count(Ap)[:n]


def vertex_butterflies_tiled(A: torch.Tensor, tile_rows: int = 1024,
                             bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Per-row butterfly counts with one row strip in flight at a time.

    A host loop over ``tile_rows``-row strips of the padded adjacency,
    each through the ``vertex_count_tile`` kernel, which skips the
    diagonal mask; the exact self-pair term C(d_r, 2) is subtracted here
    (in int64, after rounding the f32 strip sums).  Every strip is
    padded to the same shape.  Returns int64 counts on ``A``'s device."""
    n = A.shape[0]
    A = A.to(torch.float32)
    deg = A.sum(dim=1).to(torch.int64)
    tile_rows = max(-(-tile_rows // bm) * bm, bm)
    Ap = _pad_to(_pad_to(A, bn, 0), 128, 1).contiguous()
    out = torch.zeros((n,), dtype=torch.float64, device=A.device)
    for r0 in range(0, n, tile_rows):
        r1 = min(r0 + tile_rows, n)
        tile = _pad_to(Ap[r0:r1], tile_rows, 0).contiguous()
        out[r0:r1] = vertex_count_tile(tile, Ap)[: r1 - r0].to(torch.float64)
    self_pair = deg * (deg - 1) // 2
    return torch.round(out).to(torch.int64) - self_pair


def edge_wedge_matrix(A: torch.Tensor, bm: int = 128, bn: int = 128,
                      bk: int = 128) -> torch.Tensor:
    """M = (W − 1)·A with W = A·Aᵀ, both products through the ``matmul``
    kernel.  Uses the identity (W − 1)·A = W·A − d_v so the −1 never
    materializes.  Per-edge counts = M[u, v] − (d_u − 1), gathered by the
    caller."""
    n, nv = A.shape
    Af = A.to(torch.float32)
    Ap = _pad_to(_pad_to(Af, max(bm, bn, bk), 0), bk, 1).contiguous()
    W = matmul(Ap, Ap, trans_b=True)
    Ap2 = _pad_to(_pad_to(Af, bk, 0), bn, 1).contiguous()
    W = W[: Ap2.shape[0], : Ap2.shape[0]].contiguous()
    M = matmul(W, Ap2)
    dv = torch.sum(Af, dim=0)
    return M[:n, :nv] - dv[None, :]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, offset=None) -> torch.Tensor:
    """Softmax attention through the ``flash_attention`` kernel.

    The JAX package's signature: q [B, H, Sq, D], k/v [B, H, Sk, D],
    causal mask aligned bottom-right by the *logical* offset sk − sq
    (``offset=None``).  Beyond it, k/v may hold fewer heads (H a multiple
    of KVH: GQA/MQA without repeating them) and ``offset`` may be given,
    as ``models.layers.blockwise_attention`` does (its ``q_offset``: key
    j visible to query i iff j <= i + offset).  Scores are scaled by
    D^-1/2.  A row that sees no key gives 0."""
    sq, D = q.shape[2], q.shape[3]
    sk = k.shape[2]
    return _flash_attention(q, k, v, causal=causal, scale=D ** -0.5,
                            offset=sk - sq if offset is None else offset)


def pack_blooms(link_edge: np.ndarray, link_twin: np.ndarray,
                link_bloom: np.ndarray, nb: int, bb: int = 256) -> dict:
    """Bloom-major dense packing: row b holds bloom b's links, padded to
    the max pairs-per-bloom (rounded to a lane multiple of 128) and the
    rows to a multiple of ``bb``.  Padding slots carry edge ids −1 and
    ``valid`` False."""
    order = np.argsort(link_bloom, kind="stable")
    le, lt, lb = link_edge[order], link_twin[order], link_bloom[order]
    counts = np.bincount(lb, minlength=nb)
    K = max(int(counts.max() if counts.size else 1), 1)
    K = int(-(-K // 128) * 128)
    nb_pad = int(-(-max(nb, 1) // bb) * bb)
    off = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    col = np.arange(le.size) - off[lb]
    dense = dict(
        le=np.full((nb_pad, K), -1, np.int32),
        lt=np.full((nb_pad, K), -1, np.int32),
        valid=np.zeros((nb_pad, K), bool),
        canon=np.zeros((nb_pad, K), bool),
    )
    dense["le"][lb, col] = le
    dense["lt"][lb, col] = lt
    dense["valid"][lb, col] = True
    dense["canon"][lb, col] = le < lt
    dense["nb"] = nb
    dense["nb_pad"] = nb_pad
    dense["K"] = K
    return dense


def _u8(x: torch.Tensor) -> torch.Tensor:
    """0/1 flags as a contiguous uint8 tensor (a bool tensor is viewed,
    not copied)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x.to(torch.uint8)


def bloom_update(peeled: torch.Tensor, alive_pair: torch.Tensor,
                 k_alive: torch.Tensor, le: torch.Tensor, lt: torch.Tensor,
                 canon: torch.Tensor, bb: int = 256):
    """One batched BE-Index support-update round through the
    ``bloom_update`` kernel.

    ``peeled``: (m+1,) bool with a False sentinel last; ``alive_pair``
    and ``canon``: [nb_pad, K] bool; ``k_alive``: [nb_pad] f32; ``le``/
    ``lt``: [nb_pad, K] int32 link and twin edge ids, −1 on padding
    (remapped to the sentinel here, before any gather).  The per-slot
    losses are scattered onto edges with an int32 ``index_add_``.
    Returns (loss per edge (m,) f32, c per bloom f32, new alive_pair)."""
    if alive_pair.shape[0] % bb:
        raise ValueError(f"bloom_update: {alive_pair.shape[0]} bloom rows, "
                         f"not a multiple of bb={bb}; pad with pack_blooms")
    sent = peeled.shape[0] - 1
    lei = torch.where(le < 0, sent, le)
    lti = torch.where(lt < 0, sent, lt)
    pe = peeled[lei]
    pt = peeled[lti]
    contrib, c = _bloom_update(_u8(pe), _u8(pt), _u8(alive_pair), _u8(canon),
                               k_alive.to(torch.float32).contiguous())
    pair_dies = alive_pair & (pe | pt)
    loss = torch.zeros((sent + 1,), dtype=torch.int32, device=peeled.device)
    loss.index_add_(0, lei.reshape(-1),
                    torch.round(contrib).to(torch.int32).reshape(-1))
    return loss[:-1].to(torch.float32), c, alive_pair & ~pair_dies


def state_from_numpy(packed: dict, device) -> dict:
    """A packer's dict (either package's) with every numpy array turned
    into a tensor on ``device``; other values are kept as they are."""
    return {key: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  if isinstance(v, np.ndarray) else v)
            for key, v in packed.items()}

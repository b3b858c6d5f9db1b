"""The port's kernel front door: padded wrappers, state transfer and
launch counts.

Callers (``core/csr.py``, ``core/peel.py``, ``chip_smoke.py``) import
only this module.  Each wrapper dispatches by the device of the tensors
it is given: a CUDA tensor launches the hand-written kernel or raises, a
CPU tensor runs the plain version in ``kernels/ref.py``.  There is no
other switch.  ``pair_wedge_counts``, ``tip_slot_loss`` and
``support_update`` pad their inputs to (128, 128) multiples and
``tile_row_counts`` to (``_row_bucket``, 128) as the JAX package's
wrappers do, so both packages hand their kernels the same shapes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build
from .fd_round import fd_round_tip, fd_round_wing
from .support_update import support_update as _support_update
from .wedge_count import wedge_count, wedge_count_tile

__all__ = [
    "fd_round_tip",
    "fd_round_wing",
    "launch_counts",
    "pair_wedge_counts",
    "reset_launch_counts",
    "state_from_numpy",
    "support_update",
    "tile_row_counts",
    "tip_slot_loss",
]

KERNELS = ("fd_round_wing", "fd_round_tip", "support_update", "wedge_count",
           "wedge_count_tile")


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


def state_from_numpy(packed: dict, device) -> dict:
    """A packer's dict (either package's) with every numpy array turned
    into a tensor on ``device``; other values are kept as they are."""
    return {key: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  if isinstance(v, np.ndarray) else v)
            for key, v in packed.items()}

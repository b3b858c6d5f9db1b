"""Filtered wedge enumeration of the BE-Index build — ``csrc/beindex.cu``.

Every wedge slot (mid, i, j) of the combined-id CSR, in the host loop's
order, as an int64 bloom key (−1 where the priority filter drops it) and
the edge ids of its two edges.  The grouping into blooms stays with the
caller (``core.beindex.build_beindex``).  A CUDA tensor launches the
kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["beindex_wedges"]


@functools.cache
def _lib():
    lib = _build.lib("beindex")
    lib.beindex_wedges_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_void_p])
    lib.beindex_wedges_launch.restype = ctypes.c_int
    return lib


def beindex_wedges(nbr, eid, row_off, slot_off, label):
    """``nbr``/``eid``: (2m,) int32 combined neighbour ids and edge ids of
    the CSR whose rows are in edge-index order; ``row_off``/``slot_off``:
    (n + 1,) int64 row offsets and C(d, 2) prefix sums; ``label``: (n,)
    int32 priority labels.  Returns (key int64, e_lo int32, e_hi int32),
    one entry a wedge slot — see ``ref.beindex_wedges_ref``."""
    if nbr.device.type == "cpu":
        return ref.beindex_wedges_ref(nbr, eid, row_off, slot_off, label)
    n, m2 = label.shape[0], nbr.shape[0]
    i32, i64 = torch.int32, torch.int64
    _build.require(
        "beindex_wedges",
        ("nbr", nbr, i32, (m2,)), ("eid", eid, i32, (m2,)),
        ("row_off", row_off, i64, (n + 1,)),
        ("slot_off", slot_off, i64, (n + 1,)), ("label", label, i32, (n,)))
    n_slots = int(slot_off[-1])
    key = torch.empty((n_slots,), dtype=i64, device=nbr.device)
    e_lo = torch.empty((n_slots,), dtype=i32, device=nbr.device)
    e_hi = torch.empty((n_slots,), dtype=i32, device=nbr.device)
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    err = _lib().beindex_wedges_launch(
        *(t.data_ptr() for t in (nbr, eid, row_off, slot_off, label, key,
                                 e_lo, e_hi)),
        n, n_slots, stream)
    _build.check(err, "beindex_wedges")
    _build.LAUNCHES["beindex_wedges"] += 1
    return key, e_lo, e_hi

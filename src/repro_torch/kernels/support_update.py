"""Widow/survivor support-update wrapper — ``csrc/support_update.cu``.

Per slot of a pairs-major (n, K) slot matrix, the butterflies its two
edges lose this round, and per row the dying wedges c.  The scatter of
the losses onto edges stays with the caller (``ops.support_update``,
``core.csr.wing_update_slots``, the unfused vmapped wing FD).  A CUDA
tensor launches the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["support_update"]


@functools.cache
def _lib():
    lib = _build.lib("support_update")
    lib.support_update_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.support_update_launch.restype = ctypes.c_int
    return lib


def support_update(pe1, pe2, alive, W):
    """``pe1``/``pe2``/``alive``: (n, K) f32 0/1 flags; ``W``: (n,) f32
    alive wedges per row.  Returns f32 (contrib1 (n, K), contrib2 (n, K),
    c (n,)) — see ``ref.support_update_ref``."""
    if pe1.device.type == "cpu":
        return ref.support_update_ref(pe1, pe2, alive, W)
    n, K = pe1.shape
    f32 = torch.float32
    _build.require(
        "support_update",
        ("pe1", pe1, f32, (n, K)), ("pe2", pe2, f32, (n, K)),
        ("alive", alive, f32, (n, K)), ("W", W, f32, (n,)))
    c1 = torch.empty((n, K), dtype=f32, device=pe1.device)
    c2 = torch.empty((n, K), dtype=f32, device=pe1.device)
    c = torch.empty((n,), dtype=f32, device=pe1.device)
    stream = torch.cuda.current_stream(pe1.device).cuda_stream
    err = _lib().support_update_launch(
        *(t.data_ptr() for t in (pe1, pe2, alive, W, c1, c2, c)), n, K,
        stream)
    _build.check(err, "support_update")
    _build.LAUNCHES["support_update"] += 1
    return c1, c2, c

"""Batched BE-Index support-update wrapper — ``csrc/bloom_update.cu``.

Over bloom-major (nb, K) link matrices (``ops.pack_blooms``), per slot
the support its link edge loses this round and per bloom the dying
pairs c.  The scatter of the losses onto edges stays with the caller
(``ops.bloom_update``).  A CUDA tensor launches the kernel, a CPU tensor
runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["bloom_update"]


@functools.cache
def _lib():
    lib = _build.lib("bloom_update")
    lib.bloom_update_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.bloom_update_launch.restype = ctypes.c_int
    return lib


def bloom_update(pe, pt, alive, canon, k_alive):
    """``pe``/``pt``/``alive``/``canon``: (nb, K) uint8 0/1 flags (the
    link edge / its twin peeled, the pair alive, the canonical link; on
    the card K % 4 == 0 and 4-byte aligned, as ``ops.pack_blooms`` gives);
    ``k_alive``: (nb,) f32 alive pairs per bloom.  Returns f32 (contrib
    (nb, K), c (nb,)) — see ``ref.bloom_update_ref``."""
    if pe.device.type == "cpu":
        return ref.bloom_update_ref(pe, pt, alive, canon, k_alive)
    nb, K = pe.shape
    u8, f32 = torch.uint8, torch.float32
    _build.require(
        "bloom_update",
        ("pe", pe, u8, (nb, K)), ("pt", pt, u8, (nb, K)),
        ("alive", alive, u8, (nb, K)), ("canon", canon, u8, (nb, K)),
        ("k_alive", k_alive, f32, (nb,)))
    if K % 4 or any(t.data_ptr() % 4 for t in (pe, pt, alive, canon)):
        raise ValueError(
            f"bloom_update: the kernel reads four slots at a time and needs "
            f"K % 4 == 0 and 4-byte aligned flags, got K={K}")
    contrib = torch.empty((nb, K), dtype=f32, device=pe.device)
    c = torch.empty((nb,), dtype=f32, device=pe.device)
    stream = torch.cuda.current_stream(pe.device).cuda_stream
    err = _lib().bloom_update_launch(
        *(t.data_ptr() for t in (pe, pt, alive, canon, k_alive, contrib, c)),
        nb, K, stream)
    _build.check(err, "bloom_update")
    _build.LAUNCHES["bloom_update"] += 1
    return contrib, c

"""Fused FD round wrappers (wing and tip) — ``csrc/fd_round.cu``.

One call is one whole FD round over B stacked partitions: k-advance,
peel frontier, θ/alive compaction, the support update and its loss
scatter.  On a CUDA tensor it launches the kernel (three launches on the
current stream, no host sync; see the source's header); on a CPU tensor
it runs the plain version in ``kernels/ref.py``.  Either way the state
tensors are updated in place and returned, so a driver threads the same
tensors through every round.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["fd_round_wing", "fd_round_tip"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _copy_back(state, new):
    for t, n in zip(state, new):
        t.copy_(n)
    return state


@functools.cache
def _lib():
    lib = _build.lib("fd_round")
    lib.fd_round_wing_launch.argtypes = [_P] * 13 + [_I] * 4 + [_P]
    lib.fd_round_wing_launch.restype = _I
    lib.fd_round_tip_launch.argtypes = [_P] * 11 + [_I] * 3 + [_P]
    lib.fd_round_tip_launch.restype = _I
    return lib


def fd_round_wing(sup, alive, theta, k, rounds, nupd, aslot, W, e1, e2):
    """One fused wing FD round, in place.

    State: sup/alive/theta (B, E) int32, k/rounds/nupd (B, 1) int32,
    slot alive mask ``aslot`` (B, R, K) int32 0/1, W (B, R) f32 (alive
    wedges per pair row); statics e1/e2 (B, R, K) int32 partition-local
    edge ids with sentinel E (``core.distributed._pack_fd_slots_csr``).
    Returns the 8 state tensors."""
    state = (sup, alive, theta, k, rounds, nupd, aslot, W)
    if sup.device.type == "cpu":
        return _copy_back(state, ref.fd_round_wing_ref(*state, e1, e2))
    B, E = sup.shape
    _, R, K = e1.shape
    i32 = torch.int32
    _build.require(
        "fd_round_wing",
        ("sup", sup, i32, (B, E)), ("alive", alive, i32, (B, E)),
        ("theta", theta, i32, (B, E)), ("k", k, i32, (B, 1)),
        ("rounds", rounds, i32, (B, 1)), ("nupd", nupd, i32, (B, 1)),
        ("aslot", aslot, i32, (B, R, K)), ("W", W, torch.float32, (B, R)),
        ("e1", e1, i32, (B, R, K)), ("e2", e2, i32, (B, R, K)))
    loss = torch.empty((B, E + 1), dtype=i32, device=sup.device)
    S = torch.empty((B, E + 1), dtype=torch.uint8, device=sup.device)
    live = torch.empty((B,), dtype=i32, device=sup.device)
    stream = torch.cuda.current_stream(sup.device).cuda_stream
    err = _lib().fd_round_wing_launch(
        *(t.data_ptr() for t in (*state, e1, e2, loss, S, live)),
        B, E, R, K, stream)
    _build.check(err, "fd_round_wing")
    _build.LAUNCHES["fd_round_wing"] += 1
    return state


def fd_round_tip(sup, alive, theta, k, rounds, pa, pb, bf):
    """One fused tip FD round, in place.

    State: sup/alive/theta (B, E) int32, k/rounds (B, 1) int32; statics
    pa/pb/bf (B, L) int32 partition-local pair lists with bf = 0 on
    padding (``pack_fd_partitions_tip_csr(stacked=True)``).  Returns the
    5 state tensors."""
    state = (sup, alive, theta, k, rounds)
    if sup.device.type == "cpu":
        return _copy_back(state, ref.fd_round_tip_ref(*state, pa, pb, bf))
    B, E = sup.shape
    L = pa.shape[1]
    i32 = torch.int32
    _build.require(
        "fd_round_tip",
        ("sup", sup, i32, (B, E)), ("alive", alive, i32, (B, E)),
        ("theta", theta, i32, (B, E)), ("k", k, i32, (B, 1)),
        ("rounds", rounds, i32, (B, 1)), ("pa", pa, i32, (B, L)),
        ("pb", pb, i32, (B, L)), ("bf", bf, i32, (B, L)))
    loss = torch.empty((B, E), dtype=i32, device=sup.device)
    S = torch.empty((B, E), dtype=torch.uint8, device=sup.device)
    live = torch.empty((B,), dtype=i32, device=sup.device)
    stream = torch.cuda.current_stream(sup.device).cuda_stream
    err = _lib().fd_round_tip_launch(
        *(t.data_ptr() for t in (*state, pa, pb, bf, loss, S, live)),
        B, E, L, stream)
    _build.check(err, "fd_round_tip")
    _build.LAUNCHES["fd_round_tip"] += 1
    return state

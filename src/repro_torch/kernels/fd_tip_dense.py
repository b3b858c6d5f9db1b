"""The dense tip engine's whole FD phase — ``csrc/fd_tip_dense.cu``.

Every partition's bottom-up peel over the static pair-butterfly matrix,
one block a partition, in one launch and with no host read between
rounds.  A CUDA tensor launches the kernel, a CPU tensor runs the plain
version (``ref.fd_tip_dense_ref``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["fd_tip_dense"]


@functools.cache
def _lib():
    lib = _build.lib("fd_tip_dense")
    lib.fd_tip_dense_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.fd_tip_dense_launch.restype = ctypes.c_int
    return lib


def fd_tip_dense(pair, rows, off, sup):
    """``pair``: (n, n) float64 pair-butterfly matrix (exact integers,
    zero diagonal); ``rows``: (N,) int32 global ids of the peeled
    vertices, partition by partition; ``off``: (P + 1,) int64 partition
    offsets into ``rows``; ``sup``: (N,) int64 their FD initial supports.
    Returns (theta (N,) int64, rounds (P,) int32, rec (N, 3) int64):
    each vertex's tip number, each partition's round count, and round r
    of partition p's (k, died, frontier) at ``rec[off[p] + r]`` (zero
    past the last round) — see ``ref.fd_tip_dense_ref``."""
    if pair.device.type == "cpu":
        return ref.fd_tip_dense_ref(pair, rows, off, sup)
    n, N, P = pair.shape[0], rows.shape[0], off.shape[0] - 1
    i32, i64 = torch.int32, torch.int64
    _build.require(
        "fd_tip_dense",
        ("pair", pair, torch.float64, (n, n)), ("rows", rows, i32, (N,)),
        ("off", off, i64, (P + 1,)), ("sup", sup, i64, (N,)))
    dev = pair.device
    theta = torch.empty((N,), dtype=i64, device=dev)
    rounds = torch.zeros((P,), dtype=i32, device=dev)
    rec = torch.zeros((N, 3), dtype=i64, device=dev)
    scratch_sup = torch.empty((N,), dtype=i64, device=dev)
    scratch_list = torch.empty((N,), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().fd_tip_dense_launch(
        *(t.data_ptr() for t in (pair, rows, off, sup, scratch_sup,
                                 scratch_list, theta, rounds, rec)),
        n, P, stream)
    _build.check(err, "fd_tip_dense")
    _build.LAUNCHES["fd_tip_dense"] += 1
    return theta, rounds, rec

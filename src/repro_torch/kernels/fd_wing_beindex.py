"""The BE-Index wing engine's whole FD phase — ``csrc/fd_wing_beindex.cu``.

Every partition's bottom-up peel over its sub-index of twin pairs (alg.5
with alg.6's widow/survivor updates), one block a partition, in one
launch and with no host read between rounds.  A CUDA tensor launches the
kernel, a CPU tensor runs the plain version
(``ref.fd_wing_beindex_ref``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["fd_wing_beindex"]

_N_TENSORS = 22


@functools.cache
def _lib():
    lib = _build.lib("fd_wing_beindex")
    lib.fd_wing_beindex_launch.argtypes = (
        [ctypes.c_void_p] * _N_TENSORS + [ctypes.c_int, ctypes.c_void_p])
    lib.fd_wing_beindex_launch.restype = ctypes.c_int
    return lib


def fd_wing_beindex(rows, row_off, sup, edge_off, ent, pa, pb, seg, seg_off,
                    seg_poff, k_init, part):
    """All int32.  Partition p's edges are ``rows[row_off[p]:row_off[p +
    1]]`` (global ids) with FD initial supports ``sup`` (m,).  Twin pair
    q has members ``pa[q]``, ``pb[q]`` and segment ``seg[q]``; segment s
    (the pairs of one bloom whose lower member partition is p) holds the
    pairs ``seg_off[s]:seg_off[s + 1]`` and starts at ``k_init[s]`` alive
    pairs (the bloom's pairs with both members in partitions >= p);
    partition p's segments are ``seg_poff[p]:seg_poff[p + 1]``.
    ``ent[edge_off[e]:edge_off[e + 1]]`` lists the pairs of e's own
    partition that hold e; ``part`` (m,) is each edge's partition.
    Returns (theta (m,) int32, rounds (P,) int32, updates (P,) int64,
    rec (m, 4) int64): each edge's wing number (0 in a partition with no
    pair, which runs no round), each partition's rounds and support
    updates, and round r of partition p's (k, died, frontier, updates)
    at ``rec[row_off[p] + r]`` (zero past the last round) — see
    ``ref.fd_wing_beindex_ref``."""
    if rows.device.type == "cpu":
        return ref.fd_wing_beindex_ref(rows, row_off, sup, edge_off, ent, pa,
                                       pb, seg, seg_off, seg_poff, k_init,
                                       part)
    m, P = sup.shape[0], row_off.shape[0] - 1
    Q, S = pa.shape[0], k_init.shape[0]
    i32, i64 = torch.int32, torch.int64
    _build.require(
        "fd_wing_beindex",
        ("rows", rows, i32, (m,)), ("row_off", row_off, i32, (P + 1,)),
        ("sup", sup, i32, (m,)), ("edge_off", edge_off, i32, (m + 1,)),
        ("ent", ent, i32, tuple(ent.shape[:1])), ("pa", pa, i32, (Q,)),
        ("pb", pb, i32, (Q,)), ("seg", seg, i32, (Q,)),
        ("seg_off", seg_off, i32, (S + 1,)),
        ("seg_poff", seg_poff, i32, (P + 1,)), ("k_init", k_init, i32, (S,)),
        ("part", part, i32, (m,)))
    dev = rows.device
    theta = torch.zeros((m,), dtype=i32, device=dev)
    rounds = torch.zeros((P,), dtype=i32, device=dev)
    updates = torch.zeros((P,), dtype=i64, device=dev)
    rec = torch.zeros((m, 4), dtype=i64, device=dev)
    scratch = dict(sup=torch.empty((m,), dtype=i32, device=dev),
                   list_a=torch.empty((m,), dtype=i32, device=dev),
                   list_b=torch.empty((m,), dtype=i32, device=dev),
                   seglist=torch.empty((max(S, 1),), dtype=i32, device=dev),
                   pdead=torch.zeros((max(Q, 1),), dtype=i32, device=dev),
                   c=torch.zeros((max(S, 1),), dtype=i32, device=dev),
                   kal=k_init.clone() if S else torch.zeros(
                       (1,), dtype=i32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().fd_wing_beindex_launch(
        *(t.data_ptr() for t in (
            rows, row_off, sup, edge_off, ent, pa, pb, seg, seg_off,
            seg_poff, part, *scratch.values(), theta, rounds, updates, rec)),
        P, stream)
    _build.check(err, "fd_wing_beindex")
    _build.LAUNCHES["fd_wing_beindex"] += 1
    return theta, rounds, updates, rec

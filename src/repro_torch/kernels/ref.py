"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, on the same layouts,
with ordinary tensor operations; it mirrors the JAX package's
``kernels/ref.py`` oracle of the same name.  The wrappers use them for
tensors on the CPU, the CPU tests hold them against the JAX package,
and ``chip_smoke.py`` holds each kernel against them on the card.  They
are functional: inputs are never written.
"""
from __future__ import annotations

import torch

__all__ = [
    "pair_wedge_counts_ref",
    "support_update_ref",
    "fd_round_wing_ref",
    "fd_round_tip_ref",
]

BIG = torch.iinfo(torch.int32).max


def pair_wedge_counts_ref(slots: torch.Tensor):
    """Row sums W of a slot matrix and the f32 estimate C(W, 2)."""
    w = slots.to(torch.float32).sum(dim=1)
    return w, w * (w - 1.0) * 0.5


def support_update_ref(pe1, pe2, alive, W):
    """Widow/survivor losses over a pairs-major slot matrix.

    ``pe1``/``pe2``/``alive`` are (n, K) 0/1 flags (a slot's edge 1 / 2
    peeled, the wedge alive), ``W`` (n,) the alive wedges per row.
    Returns f32 ``(contrib1, contrib2, c)``: the per-slot losses of each
    slot's two edges and the dying wedges per row."""
    pe1 = pe1.to(torch.float32)
    pe2 = pe2.to(torch.float32)
    alive = alive.to(torch.float32)
    dies = alive * torch.maximum(pe1, pe2)
    c = dies.sum(dim=1)
    surv_loss = (alive - dies) * c[:, None]
    widow = dies * (W.to(torch.float32) - 1.0)[:, None]
    return (1.0 - pe1) * widow + surv_loss, (1.0 - pe2) * widow + surv_loss, c


def _fd_advance_ref(sup, alive, theta, k):
    """k-advance and frontier compaction of one batched FD round: the
    prologue both fused rounds share."""
    live = alive.any(dim=1)
    k = torch.maximum(k[:, 0], sup.masked_fill(~alive, BIG).amin(dim=1))
    S = alive & (sup <= k[:, None])
    theta = torch.where(S, k[:, None], theta)
    return S, alive & ~S, theta, k[:, None], live


def fd_round_wing_ref(sup, alive, theta, k, rounds, nupd, aslot, W, e1, e2):
    """One wing FD round over B stacked partitions.

    State: sup/alive/theta (B, E) int32, k/rounds/nupd (B, 1) int32, the
    slot alive mask (B, R, K) int32, W (B, R) f32; statics e1/e2
    (B, R, K) int32 partition-local edge ids with sentinel E.  Returns
    the new 8-tuple in the same order.  Dead slots neither die nor lose,
    so the widow/survivor algebra runs over the alive slots only."""
    alive = alive != 0
    S, alive, theta, k, live = _fd_advance_ref(sup, alive, theta, k)

    B, E = sup.shape
    _, R, K = e1.shape
    dev = sup.device
    S_flat = torch.cat([S, S.new_zeros((B, 1))], dim=1).reshape(-1)
    pos = (aslot.reshape(-1) != 0).nonzero().squeeze(1)  # alive slots
    row = pos // K                                        # b·R + r
    part = row // R
    base = (part * (E + 1)).to(torch.int32)
    g1 = e1.reshape(-1)[pos] + base
    g2 = e2.reshape(-1)[pos] + base
    pe1 = S_flat[g1]
    pe2 = S_flat[g2]
    dies = pe1 | pe2
    c_row = torch.zeros(B * R, dtype=torch.float32, device=dev).index_add_(
        0, row, dies.to(torch.float32))
    c_w = c_row[row]
    surv = ~dies
    wm1 = W.to(torch.float32).reshape(-1)[row] - 1.0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    surv_c = torch.where(surv, c_w, zero)
    c1 = torch.round(torch.where(dies & ~pe1, wm1, zero) + surv_c).to(torch.int32)
    c2 = torch.round(torch.where(dies & ~pe2, wm1, zero) + surv_c).to(torch.int32)

    loss = torch.zeros(B * (E + 1), dtype=torch.int32, device=dev)
    loss.index_add_(0, g1, c1)
    loss.index_add_(0, g2, c2)
    loss = loss.reshape(B, E + 1)[:, :E]
    upd = ((dies & (~pe1 | ~pe2)) | (surv & (c_w > 0))).to(torch.int32)
    nu = torch.zeros(B, dtype=torch.int32, device=dev).index_add_(0, part, upd)
    aslot_new = torch.zeros(B * R * K, dtype=torch.int32, device=dev)
    aslot_new[pos] = surv.to(torch.int32)
    return (sup - loss, alive.to(torch.int32), theta, k,
            rounds + live.to(torch.int32)[:, None], nupd + nu[:, None],
            aslot_new.reshape(B, R, K),
            W.to(torch.float32) - c_row.reshape(B, R))


def fd_round_tip_ref(sup, alive, theta, k, rounds, pa, pb, bf):
    """One tip FD round over B stacked partitions: the k-advance plus the
    static pair-butterfly delta (``core.csr.tip_delta_csr``) over the
    (B, L) partition-local pair lists (bf = 0 on padding).  Returns the
    new 5-tuple in the same order."""
    alive = alive != 0
    S, alive, theta, k, live = _fd_advance_ref(sup, alive, theta, k)
    B, E = sup.shape
    off = (torch.arange(B, dtype=torch.int32, device=sup.device) * E)[:, None]
    Sf = S.reshape(-1)
    pag = (pa + off).reshape(-1)
    pbg = (pb + off).reshape(-1)
    bff = bf.reshape(-1)
    loss = torch.zeros(B * E, dtype=torch.int32, device=sup.device)
    loss.index_add_(0, pag, torch.where(Sf[pbg], bff, 0))
    loss.index_add_(0, pbg, torch.where(Sf[pag], bff, 0))
    return (sup - loss.reshape(B, E), alive.to(torch.int32), theta, k,
            rounds + live.to(torch.int32)[:, None])

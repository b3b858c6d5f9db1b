"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, on the same layouts,
with ordinary tensor operations; it mirrors the JAX package's
``kernels/ref.py`` oracle of the same name.  The wrappers use them for
tensors on the CPU, the CPU tests hold them against the JAX package,
and ``chip_smoke.py`` holds each kernel against them on the card.  They
are functional: inputs are never written.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = [
    "pair_wedge_counts_ref",
    "tile_row_counts_ref",
    "support_update_ref",
    "fd_round_wing_ref",
    "fd_round_tip_ref",
    "matmul_f32",
    "matmul_ref",
    "vertex_butterflies_ref",
    "vertex_count_tile_ref",
    "edge_wedge_matrix_ref",
    "bloom_update_ref",
    "flash_attention_ref",
]

BIG = torch.iinfo(torch.int32).max


def pair_wedge_counts_ref(slots: torch.Tensor):
    """Row sums W of a slot matrix and the f32 estimate C(W, 2)."""
    w = slots.to(torch.float32).sum(dim=1)
    return w, w * (w - 1.0) * 0.5


def tile_row_counts_ref(slots: torch.Tensor) -> torch.Tensor:
    """Exact int32 row sums of an int32 0/1 slot matrix (the tile mode
    of the tiled ⋈init); a row sum is at most the width."""
    return slots.sum(dim=1, dtype=torch.int32)


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


@contextlib.contextmanager
def _full_f32():
    """Full float32 products for the block: TF32 keeps ~10 mantissa bits
    and would round the integer counts these products carry."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 whatever the process-wide precision
    setting (the JAX package's ``Precision.HIGHEST``)."""
    with _full_f32():
        return torch.matmul(a, b)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               trans_b: bool = False) -> torch.Tensor:
    """The ``matmul`` kernel's function: ``a @ b`` (``a @ bᵀ`` with
    ``trans_b``) of f32 matrices, f32 accumulation."""
    return matmul_f32(a, b.T if trans_b else b)


def vertex_butterflies_ref(A: torch.Tensor) -> torch.Tensor:
    """⋈_u per row of A: Σ_{u'≠u} C(W[u,u'], 2) with W = A Aᵀ."""
    W = matmul_f32(A, A.T)
    W.fill_diagonal_(0.0)
    return torch.sum(W * (W - 1.0) * 0.5, dim=1)


def vertex_count_tile_ref(A_rows: torch.Tensor,
                          A: torch.Tensor) -> torch.Tensor:
    """One row strip's raw sums Σ_j C(W[r, j], 2) with W = A_rows Aᵀ and
    no diagonal mask (the caller subtracts the self pair C(d_r, 2))."""
    W = matmul_f32(A_rows, A.T)
    return torch.sum(W * (W - 1.0) * 0.5, dim=1)


def edge_wedge_matrix_ref(A: torch.Tensor) -> torch.Tensor:
    """M = (W − 1) · A with W = A Aᵀ; per-edge counts are
    M[u,v] − (d_u − 1) gathered at the edge list."""
    W = matmul_f32(A, A.T)
    return matmul_f32(W - 1.0, A)


def bloom_update_ref(pe, pt, alive, canon, k_alive):
    """Per-bloom batch support update (alg.6 inner loop), dense layout.

    Inputs are [nb, K] bloom-major 0/1 matrices (bool or uint8, padded
    with alive = 0) plus per-bloom pair counts ``k_alive`` [nb] f32.
    Returns f32 (contrib [nb, K], c [nb]): c = dying pairs per bloom;
    contrib = per-link support loss to be scattered onto link_edge by
    the caller."""
    pe, pt, alive, canon = (x != 0 for x in (pe, pt, alive, canon))
    pair_dies = alive & (pe | pt)
    c = torch.sum((pair_dies & canon).to(torch.float32), dim=1)
    widow = alive & ~pe & pt
    surv = alive & ~pair_dies
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    contrib = (torch.where(widow, k_alive[:, None] - 1.0, zero)
               + torch.where(surv, c[:, None], zero))
    return contrib, c


def flash_attention_ref(q, k, v, causal: bool = True, scale=None,
                        offset=None):
    """Plain softmax attention — the ``flash_attention`` kernel's function.

    q: [B, H, Sq, D]; k/v: [B, KVH, Sk, D] with H a multiple of KVH (query
    head h reads key/value head h // (H / KVH); with KVH == H this is the
    JAX package's oracle, "kv heads already broadcast").  With ``causal``,
    key j is visible to query i iff j <= i + ``offset``; the default
    offset sk − sq aligns the last query with the last key.  Scores,
    softmax and products are f32 (full precision); the output has q's
    dtype.  A row that sees no key gives 0 (the JAX oracle's −inf mask
    leaves it NaN).
    """
    B, H, sq, D = q.shape
    KVH, sk = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    offset = sk - sq if offset is None else offset
    qf = q.to(torch.float32).reshape(B, KVH, (H // KVH) * sq, D)
    s = matmul_f32(qf, k.to(torch.float32).transpose(-1, -2)) * scale
    s = s.reshape(B, KVH, H // KVH, sq, sk)
    if causal:
        seen = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None] + offset)
        s = s.masked_fill(~seen, float("-inf"))
        p = torch.where(seen.any(dim=1)[:, None], torch.softmax(s, dim=-1),
                        0.0)
    else:
        p = torch.softmax(s, dim=-1)
    out = matmul_f32(p.reshape(B, KVH, (H // KVH) * sq, sk),
                     v.to(torch.float32))
    return out.reshape(B, H, sq, v.shape[-1]).to(q.dtype)

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
    "fd_tip_dense_ref",
    "fd_wing_beindex_ref",
    "matmul_f32",
    "matmul_ref",
    "pack_s8_ref",
    "choose2_row_sums",
    "vertex_butterflies_ref",
    "vertex_count_tile_ref",
    "edge_wedge_matrix_ref",
    "bloom_update_ref",
    "flash_attention_ref",
    "split_kv_ref",
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


def fd_tip_dense_ref(pair, rows, off, sup):
    """Every dense tip partition's bottom-up peel (the JAX package's
    host loop ``core/peel.py::_tip_fd_peel``, all partitions): partition
    p is ``rows[off[p]:off[p + 1]]`` with FD initial supports ``sup``
    there; each round sets θ = k on the alive with support <= k (k the
    running max of the alive's least support), kills them and takes
    their pair butterflies (``pair``, exact integers) off the survivors'
    supports, in int64.  Returns (theta (N,) int64, rounds (P,) int32,
    rec (N, 3) int64 with round r of partition p's (k, died, frontier)
    at ``off[p] + r``, zero past the last round)."""
    N, P = rows.shape[0], off.shape[0] - 1
    dev = rows.device
    theta = torch.full((N,), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros((P,), dtype=torch.int32, device=dev)
    rec = torch.zeros((N, 3), dtype=torch.int64, device=dev)
    for p in range(P):
        lo, hi = int(off[p]), int(off[p + 1])
        g = rows[lo:hi].to(torch.int64)
        pb = pair[g][:, g].to(torch.int64)
        s = sup[lo:hi].to(torch.int64).clone()
        alive = torch.ones((hi - lo,), dtype=torch.bool, device=dev)
        th = theta[lo:hi]
        k = r = 0
        while bool(alive.any()):
            k = max(k, int(s[alive].min()))
            while True:
                S = alive & (s <= k)
                died = int(S.sum())
                if died == 0:
                    break
                th[S] = k
                alive &= ~S
                s -= pb[:, S].sum(dim=1)
                rec[lo + r] = torch.tensor([k, died, int(alive.sum())],
                                           device=dev)
                r += 1
        rounds[p] = r
    return theta, rounds, rec


def fd_wing_beindex_ref(rows, row_off, sup, edge_off, ent, pa, pb, seg,
                        seg_off, seg_poff, k_init, part):
    """Every BE-Index wing partition's bottom-up peel (the JAX package's
    host loop ``core/peel.py::_wing_fd_beindex``, all partitions), each
    round one whole-sub-index update of ``core/peel.py::_wing_update``:
    partition p's sub-index is the twin pairs of its segments
    ``seg_poff[p]:seg_poff[p + 1]`` (pair q: members ``pa[q]``, ``pb[q]``,
    segment ``seg[q]``), each segment's alive pairs start at ``k_init``;
    its edges ``rows[row_off[p]:row_off[p + 1]]`` start at ``sup``.  A
    round sets θ = k on the alive with support <= k (k the running max of
    the alive's least support) and kills them; a pair dies with either
    member, its widow loses the segment's alive pairs less one, the
    surviving pairs of a segment that lost c pairs lose c each, and the
    round counts its widow and surviving links.  ``edge_off`` and ``ent``
    (the kernel's edge-major index) and ``part`` are not read.  Returns
    (theta (m,) int32, rounds (P,) int32, updates (P,) int64, rec (m, 4)
    int64 with round r of partition p's (k, died, frontier, updates) at
    ``row_off[p] + r``, zero past the last round); a partition with no
    pair runs no round and leaves its θ at 0."""
    m, P = sup.shape[0], row_off.shape[0] - 1
    dev = rows.device
    i32, i64 = torch.int32, torch.int64
    theta = torch.zeros((m,), dtype=i32, device=dev)
    rounds = torch.zeros((P,), dtype=i32, device=dev)
    updates = torch.zeros((P,), dtype=i64, device=dev)
    rec = torch.zeros((m, 4), dtype=i64, device=dev)
    for p in range(P):
        s0, s1 = int(seg_poff[p]), int(seg_poff[p + 1])
        q0, q1 = int(seg_off[s0]), int(seg_off[s1])
        if q0 == q1:
            continue
        a, b = pa[q0:q1].to(i64), pb[q0:q1].to(i64)
        le = torch.stack([a, b], 1).flatten()
        lt = torch.stack([b, a], 1).flatten()
        lb = (seg[q0:q1].to(i64) - s0).repeat_interleave(2)
        canon = le < lt
        k_alive = k_init[s0:s1].to(i64).clone()
        lo, hi = int(row_off[p]), int(row_off[p + 1])
        alive = torch.zeros((m,), dtype=torch.bool, device=dev)
        alive[rows[lo:hi].to(i64)] = True
        s = torch.where(alive, sup.to(i64), 0)
        alive_link = torch.ones_like(le, dtype=torch.bool)
        k = r = 0
        total = 0
        while bool(alive.any()):
            k = max(k, int(s[alive].min()))
            while True:
                S = alive & (s <= k)
                died = int(S.sum())
                if died == 0:
                    break
                theta[S] = k
                alive &= ~S
                pe, pt = S[le], S[lt]
                dies = alive_link & (pe | pt)
                c = torch.zeros_like(k_alive).index_add_(
                    0, lb, (dies & canon).to(i64))
                widow = alive_link & ~pe & pt
                surv = alive_link & ~dies
                c_l = c[lb]
                contrib = (torch.where(widow, k_alive[lb] - 1, 0)
                           + torch.where(surv, c_l, 0))
                s = s - torch.zeros_like(s).index_add_(0, le, contrib)
                n_upd = int(widow.sum() + (surv & (c_l > 0)).sum())
                alive_link &= ~dies
                k_alive -= c
                rec[lo + r] = torch.tensor(
                    [k, died, int(alive.sum()), n_upd], device=dev)
                r += 1
                total += n_upd
        rounds[p] = r
        updates[p] = total
    return theta, rounds, updates, rec


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
    setting (the JAX package's ``Precision.HIGHEST``).  Where autograd
    records it (an operand of two or more dims requires grad), the
    backward's two products are full float32 too (``_MatmulF32``)."""
    if (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
            and a.dim() >= 2 and b.dim() >= 2):
        return _MatmulF32.apply(a, b)
    with _full_f32():
        return torch.matmul(a, b)


class _MatmulF32(torch.autograd.Function):
    """``torch.matmul`` whose forward and backward products are full f32:
    da = g·bᵀ, db = aᵀ·g (a weight [d, n] under activations [..., d]
    takes one [d, rows]·[rows, n] product).  The model's products
    broadcast nothing else: batched operands share their batch dims
    (autograd refuses a gradient of another shape)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _full_f32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = matmul_f32(g, b.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            db = (matmul_f32(a.reshape(-1, a.shape[-1]).T,
                             g.reshape(-1, g.shape[-1])) if b.dim() == 2
                  else matmul_f32(a.transpose(-1, -2), g))
        return da, db


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               trans_b: bool = False) -> torch.Tensor:
    """The ``matmul`` kernel's function: ``a @ b`` (``a @ bᵀ`` with
    ``trans_b``) of f32 matrices, f32 accumulation."""
    return matmul_f32(a, b.T if trans_b else b)


def pack_s8_ref(A: torch.Tensor):
    """The vertex-count kernels' operand of an f32 0/1 matrix A (n, k):
    (n, kp) int8, kp = k rounded up to a multiple of 16, 1 where A != 0,
    zero past column k; and a bool scalar: A holds a value other than 0
    and 1 (NaN included)."""
    n, k = A.shape
    out = torch.zeros((n, -(-k // 16) * 16), dtype=torch.int8,
                      device=A.device)
    out[:, :k] = A != 0
    return out, ~((A == 0) | (A == 1)).all()


def choose2_row_sums(W: torch.Tensor) -> torch.Tensor:
    """int64 Σ_j C(W[r, j], 2) of an f32 matrix of exact integer counts:
    each W entry is a common-neighbour count, at most the adjacency's
    column count (< 2²⁴, so exact in f32); C(W, 2) and the sums are
    taken in int64."""
    w = W.to(torch.int64)
    return torch.sum(w * (w - 1) // 2, dim=1)


def vertex_butterflies_ref(A: torch.Tensor) -> torch.Tensor:
    """⋈_u per row of A, int64: Σ_{u'≠u} C(W[u,u'], 2) with W = A Aᵀ."""
    W = matmul_f32(A, A.T)
    W.fill_diagonal_(0.0)
    return choose2_row_sums(W)


def vertex_count_tile_ref(A_rows: torch.Tensor,
                          A: torch.Tensor) -> torch.Tensor:
    """One row strip's int64 raw sums Σ_j C(W[r, j], 2) with W = A_rows Aᵀ
    and no diagonal mask (the caller subtracts the self pair
    C(d_r, 2))."""
    return choose2_row_sums(matmul_f32(A_rows, A.T))


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
    dtype.  Where v is not f32 (bf16), the unnormalised weights
    e = exp(s − rowmax) are rounded to v's dtype before e·v and the sum
    that divides it is taken from the unrounded e: the TPU kernel's
    arithmetic (``p.astype(v.dtype)`` with ``l`` summed from f32 ``p``).
    A row that sees no key gives 0 (the JAX oracle's −inf mask leaves it
    NaN).
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
    if v.dtype != torch.float32:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        l = e.sum(dim=-1, keepdim=True)
        out = matmul_f32(e.to(v.dtype).float().reshape(B, KVH, -1, sk),
                         v.float()).reshape(l.shape[:-1] + (-1,))
        out = torch.where(l > 0, out / l, 0.0)
    else:
        p = torch.softmax(s, dim=-1)
        if causal:
            p = torch.where(seen.any(dim=1)[:, None], p, 0.0)
        out = matmul_f32(p.reshape(B, KVH, (H // KVH) * sq, sk), v)
    return out.reshape(B, H, sq, v.shape[-1]).to(q.dtype)


# Position p of each group of 8 keys in ``split_kv``'s value planes holds
# key V_KEY_ORDER[p]: the 3×TF32 kernel feeds P as wgmma's A operand,
# whose columns c and c + 4 hold what its score accumulator holds as keys
# 2c and 2c + 1 (csrc/hopper.cuh), so v's keys are stored in that order.
V_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32_planes(x: torch.Tensor) -> torch.Tensor:
    """[2, ...]: hi = x rounded to TF32 (10 mantissa bits, to nearest,
    ties away from zero: ``cvt.rna.tf32.f32``) and lo = rna(x − hi), 0
    where hi is not finite."""
    def rna(t):
        r = ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF)
        return torch.where(torch.isnan(t), t, r.view(torch.float32))

    hi = rna(x)
    return torch.stack([hi, torch.where(torch.isfinite(hi), rna(x - hi), 0.0)])


def split_kv_ref(k: torch.Tensor, v: torch.Tensor):
    """``split_kv``'s planes of f32 k, v [B, KVH, Sk, D]: kp [2, B, KVH,
    Sk, D] and vp [2, B, KVH, D, Skp] (v transposed, Skp = Sk rounded up
    to a multiple of 8, keys in ``V_KEY_ORDER`` within each group of 8,
    zero past Sk)."""
    B, KVH, sk, D = k.shape
    skp = -(-sk // 8) * 8
    vt = torch.zeros((B, KVH, D, skp), dtype=torch.float32, device=v.device)
    vt[..., :sk] = v.float().transpose(-1, -2)
    order = torch.tensor(V_KEY_ORDER, device=v.device)
    vt = vt.reshape(B, KVH, D, skp // 8, 8)[..., order].reshape(B, KVH, D, skp)
    return _tf32_planes(k.float()), _tf32_planes(vt)

"""Recurrent / state-space blocks: Mamba2 (SSD), mLSTM, sLSTM.

The port of the JAX package's ``models/ssm.py``: the same functions,
arguments and layouts.  All sequence mixing goes through one generic
*chunked linear recurrence*

    S_t = d_t · S_{t-1} + g_t · k_t v_tᵀ ,   y_t = q_tᵀ S_t

computed chunk-parallel (intra-chunk: L×L decay-masked products;
inter-chunk: a loop over the chunk summaries, JAX's ``lax.scan``).
Decode is the O(1)-state single-step recurrence.  Every product is a
full-f32 torch product (``ref.matmul_f32``; the JAX package runs these
as ``jnp.einsum``, outside any Pallas kernel), an operand of another
dtype promoted as ``jnp.einsum`` promotes it.  JAX's
``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip`` are
``torch.maximum`` / ``torch.minimum``, which split a tie's gradient
the same way.  The ``*_step`` functions return new states, as JAX's
do; the model writes them into its cache.
"""
from __future__ import annotations

import functools

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.ref import matmul_f32
from .layers import (_is_dtensor, batch_placements, merge_heads, replicated,
                     whole_parts)

__all__ = [
    "chunked_recurrence",
    "recurrence_step",
    "mamba2_mix",
    "mamba2_step",
    "mlstm_mix",
    "mlstm_step",
    "slstm_mix",
    "slstm_step",
]

_F32 = torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at full f32, the operands promoted to a common dtype
    first (``jnp.einsum``'s rule: bf16 with f32 is f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return matmul_f32(a.to(dt), b.to(dt))


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, x.new_tensor(c))


def _min(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(c))


# ============================================================ core scan
def chunked_recurrence(
    q: torch.Tensor,      # [b, h, s, dk]
    k: torch.Tensor,      # [b, h, s, dk]
    v: torch.Tensor,      # [b, h, s, dv]
    decay: torch.Tensor,  # [b, h, s]   in (0, 1]
    gain: torch.Tensor,   # [b, h, s]
    chunk: int = 64,
    unroll: bool = False,
) -> torch.Tensor:
    """y [b, h, s, dv] (f32) of the recurrence over chunks of
    ``min(chunk, s)`` steps; ``s`` must be a multiple of it.  ``unroll``
    (JAX's cost-analysis mode) changes nothing here: the inter-chunk
    scan is a Python loop either way.  On ``DTensor``s each rank runs it
    on its own batch rows and heads (``_per_head``)."""
    if _is_dtensor(q):
        return _per_head(functools.partial(chunked_recurrence, chunk=chunk),
                         (q, k, v, decay, gain), (), 1, 1)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"chunked_recurrence: sequence length {s} is not "
                         f"a multiple of the chunk {L}")
    nc = s // L
    qc = q.to(_F32).reshape(b, h, nc, L, dk)
    kc = k.to(_F32).reshape(b, h, nc, L, dk)
    vc = v.to(_F32).reshape(b, h, nc, L, dv)
    logd = torch.log(_min(_max(decay, 1e-12), 1.0)).reshape(b, h, nc, L)
    gc = gain.reshape(b, h, nc, L).to(_F32)

    cum = torch.cumsum(logd, dim=-1)                       # log Π_{i<=t}
    # intra-chunk: y[t] += Σ_{s<=t} exp(cum[t]-cum[s]) g[s] (q_t·k_s) v_s
    diff = cum[..., :, None] - cum[..., None, :]           # [.., t, s]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(tri, torch.exp(diff), 0.0) * gc[..., None, :]
    scores = matmul_f32(qc, kc.transpose(-1, -2)) * D
    y_intra = matmul_f32(scores, vc)
    del diff, D, scores

    # chunk summaries: S_c = Σ_s exp(cum[L-1]-cum[s]) g[s] k_s v_sᵀ
    wl = torch.exp(cum[..., -1:] - cum) * gc               # [b,h,nc,L]
    S_c = matmul_f32((wl[..., None] * kc).transpose(-1, -2), vc)
    chunk_decay = torch.exp(cum[..., -1])                  # [b,h,nc]

    # inter-chunk scan: y_inter[t] = exp(cum[t]) q_t · S_in
    S = torch.zeros((b, h, dk, dv), dtype=_F32, device=q.device)
    ys = []
    for c in range(nc):
        ys.append(matmul_f32(qc[:, :, c], S)
                  * torch.exp(cum[:, :, c])[..., None])
        S = chunk_decay[:, :, c, None, None] * S + S_c[:, :, c]
    y = y_intra + torch.stack(ys, dim=2)
    return y.reshape(b, h, s, dv)


def recurrence_step(
    S: torch.Tensor,      # [b, h, dk, dv]
    q: torch.Tensor,      # [b, h, dk]
    k: torch.Tensor,
    v: torch.Tensor,      # [b, h, dv]
    decay: torch.Tensor,  # [b, h]
    gain: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step; returns (new state, y [b,h,dv])."""
    S = decay[..., None, None] * S + gain[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    y = matmul_f32(q[..., None, :], S)[..., 0, :]
    return S, y


# ============================================================== Mamba2
def _mamba_parts(x, p, cfg):
    """Shared projections for train/decode.  Returns per-token z, x, B,
    C, dt, decay and the head count and dim."""
    d_in = p["in_proj"].shape[1]
    zxbcdt = _mm(x, p["in_proj"])
    nh = p["A_log"].shape[0]
    dh = (d_in - 2 * cfg.ssm_state - nh) // (2 * nh)
    # jnp.split's cut points (torch.split would read them as sizes)
    z, xin, B, C, dt = torch.tensor_split(
        zxbcdt,
        [dh * nh, 2 * dh * nh, 2 * dh * nh + cfg.ssm_state,
         2 * dh * nh + 2 * cfg.ssm_state],
        dim=-1)
    dt = F.softplus(dt.to(_F32) + p["dt_bias"])
    decay = torch.exp(-torch.exp(p["A_log"].to(_F32)) * dt)
    return z, xin, B, C, dt, decay, nh, dh


def mamba2_mix(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """Mamba2 (SSD) sequence mixing, chunk-parallel.  x: [b, s, d]."""
    b, s, _ = x.shape
    z, xin, B, C, dt, decay, nh, dh = _mamba_parts(x, p, cfg)
    # causal depthwise conv on the x-branch (width ssm_conv)
    xin = _causal_conv(xin, p["conv_w"])
    xh = whole_parts(xin, -1, nh).reshape(b, s, nh, dh)
    v = (dt[..., None] * xh.to(_F32)).transpose(1, 2)
    k = B[:, None].to(_F32).expand(b, nh, s, cfg.ssm_state)
    q = C[:, None].to(_F32).expand(b, nh, s, cfg.ssm_state)
    y = chunked_recurrence(
        q, k, v, decay.transpose(1, 2),
        torch.ones_like(decay).transpose(1, 2), chunk=cfg.ssm_chunk,
        unroll=cfg.unroll_layers)                          # [b,nh,s,dh]
    y = y + p["D"][None, :, None, None] * xh.transpose(1, 2)
    y = merge_heads(y.transpose(1, 2))
    y = y * F.silu(z.to(_F32))
    return _mm(y.to(x.dtype), p["out_proj"])


def mamba2_step(x, state, p, cfg):
    """One decode token.  x: [b, d]; state: (conv_buf, S)."""
    conv_buf, S = state
    b = x.shape[0]
    z, xin, B, C, dt, decay, nh, dh = _mamba_parts(x[:, None], p, cfg)
    z, xin, B, C = z[:, 0], xin[:, 0], B[:, 0], C[:, 0]
    dt, decay = dt[:, 0], decay[:, 0]
    # rolling conv buffer [b, w, d_conv]
    dt_buf = torch.promote_types(conv_buf.dtype, xin.dtype)
    conv_buf = torch.cat([conv_buf[:, 1:].to(dt_buf),
                          xin[:, None].to(dt_buf)], dim=1)
    xin = F.silu(torch.sum(conv_buf * p["conv_w"], dim=1))
    xh = whole_parts(xin, -1, nh).reshape(b, nh, dh)
    v = dt[..., None] * xh.to(_F32)
    k = B[:, None].to(_F32).expand(b, nh, cfg.ssm_state)
    q = C[:, None].to(_F32).expand(b, nh, cfg.ssm_state)
    S, y = recurrence_step(S, q, k, v, decay, torch.ones_like(decay))
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, nh * dh) * F.silu(z.to(_F32))
    out = _mm(y.to(x.dtype), p["out_proj"])
    return out, (conv_buf, S)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width w.shape[0]; x: [b, s, c].  On
    ``DTensor``s each rank convolves its own rows and, where they divide
    ``"model"``, channels (``_per_head`` with the channels as heads)."""
    if _is_dtensor(x):
        return _per_head(lambda xl, wl: _causal_conv(xl, wl.T).contiguous(),
                         (x,), (w.T,), 2, 2)
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i: i + s] * w[i][None, None, :]
    return F.silu(out)


# =============================================================== mLSTM
def _mlstm_proj(x, p, cfg):
    """(q, k, v, forget and input gates before the sigmoid, z) of an
    mLSTM block; q/k/v [..., nh, dh]."""
    nh = cfg.n_heads
    dh = cfg.lstm_proj_factor * cfg.d_model // nh
    xi, z = torch.chunk(_mm(x, p["up_proj"]), 2, dim=-1)
    q, k, v = (whole_parts(_mm(xi, p[w]), -1, nh).unflatten(-1, (nh, dh))
               for w in ("wq", "wk", "wv"))
    f, i = torch.chunk(_mm(xi, p["wg"]).to(_F32), 2, dim=-1)
    return q, k, v, f, i, z, dh


def mlstm_mix(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """xLSTM mLSTM block: matrix memory + sigmoid forget / input gates
    (bounded-gate simplification of exponential gating)."""
    b, s, _ = x.shape
    q, k, v, f, i, z, dh = _mlstm_proj(x, p, cfg)
    nh = q.shape[2]
    decay = torch.sigmoid(f).transpose(1, 2)              # [b,nh,s]
    gain = torch.sigmoid(i).transpose(1, 2)
    qs = q.transpose(1, 2).to(_F32) * dh ** -0.5
    kf = k.transpose(1, 2).to(_F32)
    y = chunked_recurrence(qs, kf, v.transpose(1, 2).to(_F32), decay, gain,
                           chunk=cfg.ssm_chunk, unroll=cfg.unroll_layers)
    # normaliser: the same recurrence with v ≡ 1
    n = chunked_recurrence(qs, kf, torch.ones((b, nh, s, 1), dtype=_F32,
                                              device=x.device),
                           decay, gain, chunk=cfg.ssm_chunk,
                           unroll=cfg.unroll_layers)
    y = y / _max(torch.abs(n), 1.0)
    y = merge_heads(y.transpose(1, 2))
    y = y.to(x.dtype) * F.silu(z)
    return _mm(y, p["down_proj"])


def mlstm_step(x, state, p, cfg):
    """Decode step; state = (S [b,nh,dh,dh], n [b,nh,dh])."""
    S, nstate = state
    b = x.shape[0]
    q, k, v, f, i, z, dh = _mlstm_proj(x, p, cfg)
    decay = torch.sigmoid(f)
    gain = torch.sigmoid(i)
    qf = q.to(_F32) * dh ** -0.5
    kf = k.to(_F32)
    S, y = recurrence_step(S, qf, kf, v.to(_F32), decay, gain)
    nstate = decay[..., None] * nstate + gain[..., None] * kf
    denom = _max(torch.abs(torch.sum(qf * nstate, dim=-1))[..., None], 1.0)
    y = y / denom
    y = y.reshape(b, -1).to(x.dtype) * F.silu(z)
    return _mm(y, p["down_proj"]), (S, nstate)


# =============================================================== sLSTM
def _slstm_cell(g, h, c, n, R):
    """One sLSTM time step from the input gates g [b, nh, 4·dh]: the
    recurrent product of h, the capped exp input gate, the cell."""
    rec = _mm(h.transpose(0, 1), R).transpose(0, 1)       # [b,nh,4·dh]
    i, f, z, o = torch.chunk((g + rec).to(_F32), 4, dim=-1)
    i = torch.exp(_min(i, 8.0))                           # capped exp gate
    f = torch.sigmoid(f)
    c = f * c + i * torch.tanh(z)
    n = f * n + i
    h = torch.sigmoid(o) * c / _max(n, 1.0)
    return h, c, n


def _slstm_scan(gx: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """The sLSTM time loop over gx [b, s, nh, 4·dh]: h [b, s, nh, dh]
    (f32) from zero states."""
    b, s, nh, _ = gx.shape
    h = c = n = torch.zeros((b, nh, R.shape[1]), dtype=_F32, device=gx.device)
    hs = []
    for t in range(s):
        h, c, n = _slstm_cell(gx[:, t], h, c, n, R)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _per_head(fn, acts, weights, head_dim: int, out_head_dim: int):
    """``fn(*acts, *weights)`` on ``DTensor``s through ``local_map``: each
    rank runs it on its own batch rows (dim 0 of every activation) and,
    where the head count (dim ``head_dim`` of the activations, dim 0 of
    the per-head weights) divides ``"model"``, its own heads, so a
    recurrence's many small ops are local ones.  The weights' gradients
    are summed over the data axes.  A plain tensor among ``acts`` (the
    same on every rank) is taken as replicated."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = acts[0].device_mesh
    acts = tuple(a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, replicated(mesh), run_check=False) for a in acts)
    names = mesh.mesh_dim_names
    nh, b = acts[0].shape[head_dim], acts[0].shape[0]
    m = mesh.size(names.index("model")) if "model" in names else 1
    heads = m > 1 and nh % m == 0

    def pl(base, dim):
        return [Shard(dim) if a == "model" and heads else p
                for a, p in zip(names, base)]

    rows = batch_placements(mesh, b)
    wgrad = batch_placements(mesh, b, grad=True)
    return local_map(
        fn, out_placements=pl(rows, out_head_dim),
        in_placements=((pl(rows, head_dim),) * len(acts)
                       + (pl(replicated(mesh), 0),) * len(weights)),
        in_grad_placements=((pl(rows, head_dim),) * len(acts)
                            + (pl(wgrad, 0),) * len(weights)),
        device_mesh=mesh, redistribute_inputs=True)(*acts, *weights)


def slstm_mix(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """sLSTM: scalar-memory LSTM with per-head recurrence (a loop over
    time: inherently sequential, as in the paper)."""
    b, s, _ = x.shape
    nh, dh, _ = p["R"].shape
    gx = whole_parts(_mm(x, p["W"]), -1, nh).reshape(b, s, nh, 4 * dh)
    y = (_per_head(_slstm_scan, (gx,), (p["R"],), 2, 2) if _is_dtensor(gx)
         else _slstm_scan(gx, p["R"]))
    y = merge_heads(y).to(x.dtype)
    return _mm(y, p["out"])


def slstm_step(x, state, p, cfg):
    h, c, n = state
    b = x.shape[0]
    nh, dh, _ = p["R"].shape
    g = whole_parts(_mm(x, p["W"]), -1, nh).reshape(b, nh, 4 * dh)
    h, c, n = _slstm_cell(g, h, c, n, p["R"])
    y = h.reshape(b, nh * dh).to(x.dtype)
    return _mm(y, p["out"]), (h, c, n)

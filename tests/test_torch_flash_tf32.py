"""The arithmetic of the port's 3×TF32 ``flash_attention`` route (f32 at
D 64, 128 and 256) against the JAX package, on the CPU.

The kernel (``tf::flash_tf32_kernel`` in
``kernels/csrc/flash_attention.cu``) runs on the card only.  Here a plain
PyTorch model of its arithmetic and schedule, kept in this file and used
by tests only, shows what the design promises:

* every operand splits into TF32 planes hi = rna(x), lo = rna(x − hi)
  (``tf32_rna`` and ``split`` are ``tests/test_torch_tf32.py``'s, the
  model of ``matmul``'s split); a product is lo·hi + hi·lo + hi·hi;
* key tiles of 4096 / D keys (64, 32, 16), in the kernel's order;
  scores accumulate all of D in one chain of k8 ``wgmma`` steps, three
  a step, small terms first, each step's sum rounded toward zero (the
  tensor cores' rounding, modelled as ``test_torch_tf32.py`` models
  ``matmul``'s);
* the online softmax with the scale folded into exp2, l summed from the
  unrounded f32 p, P split into planes for P·V;
* P·V summed afresh each tile and added to o in f32 (D 64 and 128), or
  chained into o (D 256, where registers leave no room for a second
  accumulator), o's sum committed to the output in f32 and o restarted
  every 1 024 keys (``CHAIN_KEYS``);
* causal masking with an offset, ragged tails and GQA by head index.

Gates: the f32 gates of ``chip_smoke.py`` phase 9, absolute 2·10⁻³ (the
JAX package's f32 kernel tolerance) and 10⁻⁴ in each output row's
‖Δ‖/‖ref‖ (f32 rounds at 2⁻²⁴; a row's typical value shrinks as it sees
more keys, so the absolute gate alone would pass a wrong late row).
Planted faults — the hi·lo term of the scores dropped, v's lo plane
left zero, q's lo plane left zero — fail the row gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from test_torch_tf32 import round_toward_zero, split

torch.set_num_threads(1)

ATOL, ROW_RTOL = 2e-3, 1e-4
K_STEP = 8  # the k depth of one m64nNk8 TF32 wgmma
CHAIN_KEYS = 1024  # keys of one P·V chain into o at D 256 (Shape<D>::kChain)
LOG2E = 1.4426950408889634


def _chain(acc, a, b, terms):
    """acc (f64 values of f32) plus a·b, k8 step by k8 step over the last
    axis of ``a``, each step's three TF32 products (``terms``: pairs of
    plane indices, lo·hi, hi·lo, hi·hi) added one wgmma at a time and
    rounded toward zero."""
    for k0 in range(0, a[0].shape[-1], K_STEP):
        s = slice(k0, k0 + K_STEP)
        for i, j in terms:
            acc = round_toward_zero(
                acc + a[i][..., s].double() @ b[j][..., s, :].double()).double()
    return acc


def flash_3xtf32(q, k, v, causal=True, offset=None, split_o=None,
                 chain_keys=CHAIN_KEYS, fault=None):
    """Attention of f32 q [B, H, Sq, D] over k, v [B, KVH, Sk, D] as the
    3×TF32 kernel computes it (module docstring).  ``split_o`` defaults
    to the kernel's choice (D ≤ 128); without it P·V chains into o for
    ``chain_keys`` keys at a time; ``fault`` plants one of ``FAULTS``."""
    B, H, sq, D = q.shape
    KVH, sk = k.shape[1], k.shape[2]
    bkv = 4096 // D
    chain = max(1, chain_keys // bkv)  # tiles
    split_o = D <= 128 if split_o is None else split_o
    offset = sk - sq if offset is None else offset
    scale_log2 = torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    g = H // KVH
    qp = list(split(q))
    kp = [x.repeat_interleave(g, 1) for x in split(k)]
    vp = [x.repeat_interleave(g, 1) for x in split(v)]
    if fault == "q lo zero":
        qp[1] = torch.zeros_like(qp[1])
    if fault == "v lo zero":
        vp[1] = torch.zeros_like(vp[1])
    qk_terms = ((1, 0), (0, 0)) if fault == "drop hi·lo" else ((1, 0), (0, 1), (0, 0))
    rows = torch.arange(sq)[:, None]
    o = torch.zeros((B, H, sq, D), dtype=torch.float32)
    part = torch.zeros_like(o)
    m = torch.full((B, H, sq, 1), float("-inf"))
    l = torch.zeros((B, H, sq, 1))
    committed = torch.zeros_like(o)  # without split_o: the output's sum
    cs = torch.ones_like(l)  # its scale since its commit
    for t, k0 in enumerate(range(0, sk, bkv)):
        keys = slice(k0, min(k0 + bkv, sk))
        n = keys.stop - keys.start
        kt = [x[:, :, keys].transpose(-1, -2) for x in kp]  # [.., D, n]
        s = _chain(torch.zeros((B, H, sq, n), dtype=torch.float64), qp, kt,
                   qk_terms).float() * scale_log2
        seen = torch.arange(k0, keys.stop)[None, :] <= rows + offset
        if causal:
            s = s.masked_fill(~seen, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        none = m_new == float("-inf")
        alpha = torch.where(none, 1.0, torch.exp2(m - m_new))
        p = torch.exp2(s - torch.where(none, 0.0, m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        pp = list(split(p))
        vt = [x[:, :, keys] for x in vp]  # [.., n, D]
        if split_o:
            o = (o + part) * alpha
            part = _chain(torch.zeros_like(o, dtype=torch.float64), pp, vt,
                          ((1, 0), (0, 1), (0, 0))).float()
        elif t % chain == 0 and t > 0:  # commit, then restart the chain
            committed = _fma(committed, cs, o)
            cs = alpha
            o = _chain(torch.zeros_like(o, dtype=torch.float64), pp, vt,
                       ((1, 0), (0, 1), (0, 0))).float()
        else:
            cs = cs * alpha
            o = _chain((o * alpha).double(), pp, vt, ((1, 0), (0, 1), (0, 0))).float()
    o = o + part if split_o else _fma(committed, cs, o)
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return o * inv


def _fma(a, b, c):
    """a·b + c in f32 with one rounding (fmaf)."""
    return (a.double() * b.double() + c.double()).float()


FAULTS = ("drop hi·lo", "v lo zero", "q lo zero")


def _inputs(seed, qs, ks):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (qs, ks, ks)]


def _jax_want(q, k, v, causal, offset):
    """The JAX package's f32 attention on these inputs: its oracle on
    broadcast heads, or blockwise attention with an explicit offset."""
    g = q.shape[1] // k.shape[1]
    rep = [np.repeat(x, g, axis=1) for x in (k, v)]
    if offset is None:
        return np.asarray(jref.flash_attention_ref(q, *rep, causal=causal))
    return np.asarray(jlayers.blockwise_attention(
        q, k, v, causal=causal, block_q=16, block_k=16, q_offset=offset))


def _gate(got, want):
    """(max abs error, worst row's ‖Δ‖/‖ref‖) over the rows that see a
    key (NaN in the JAX oracle where none)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rows = np.isfinite(want).all(axis=-1) & (np.abs(want).sum(-1) > 0)
    d = got - want
    row = np.linalg.norm(d, axis=-1)[rows] / np.linalg.norm(want, axis=-1)[rows]
    return np.abs(d[rows]).max(), row.max()


CASES = [
    # (q shape, kv shape, causal, offset)
    ((2, 8, 128, 64), (2, 2, 128, 64), True, None),      # GQA 4:1, D 64
    ((1, 4, 160, 128), (1, 1, 160, 128), True, None),    # MQA, ragged tail
    ((1, 4, 96, 128), (1, 4, 200, 128), False, None),    # non-causal, ragged
    ((1, 8, 64, 128), (1, 2, 192, 128), True, 100),      # explicit offset
    ((1, 4, 72, 256), (1, 1, 136, 256), True, None),     # D 256, sk > sq
    ((1, 2, 100, 256), (1, 2, 100, 256), False, None),   # D 256 non-causal
]


@pytest.mark.parametrize("qs,ks,causal,offset", CASES)
def test_model_matches_jax_within_the_f32_gates(qs, ks, causal, offset):
    q, k, v = _inputs(sum(qs) + sum(ks), qs, ks)
    got = flash_3xtf32(*map(torch.from_numpy, (q, k, v)), causal=causal,
                       offset=offset)
    err, row = _gate(got.numpy(), _jax_want(q, k, v, causal, offset))
    assert err <= ATOL and row <= ROW_RTOL, (err, row)
    # and the port's plain version (what chip_smoke.py holds the kernel to)
    plain = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, offset=offset)
    err, row = _gate(got.numpy(), plain.numpy())
    assert err <= ATOL and row <= ROW_RTOL, (err, row)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_model_matches_pallas_interpret(d):
    """Against the JAX package's Pallas kernel itself (interpret mode),
    causal, sq = sk = 256 (its 128 blocks)."""
    q, k, v = _inputs(d, (1, 2, 256, d), (1, 2, 256, d))
    got = flash_3xtf32(*map(torch.from_numpy, (q, k, v)))
    pallas = np.asarray(jops.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, interpret=True))
    err, row = _gate(got.numpy(), pallas)
    assert err <= ATOL and row <= ROW_RTOL, (err, row)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_row_gate(fault):
    """The 10⁻⁴ row gate has teeth: each fault costs about 2⁻¹² of a
    product, and fails it."""
    qs = ks = (1, 4, 256, 128)
    q, k, v = _inputs(5, qs, ks)
    want = _jax_want(q, k, v, True, None)
    got = flash_3xtf32(*map(torch.from_numpy, (q, k, v)), fault=fault)
    err, row = _gate(got.numpy(), want)
    assert row > ROW_RTOL, (fault, err, row)


@pytest.mark.parametrize("d,sk,split_o,chain_keys,row_max", [
    (128, 2048, True, None, 2e-5),        # the kernel at D 128: P·V a tile at a time
    (128, 2048, False, 1 << 30, ROW_RTOL),  # chained over every key
    (256, 4096, False, CHAIN_KEYS, 2e-5),   # the kernel at D 256: restarts
    (256, 4096, False, 1 << 30, ROW_RTOL),  # chained over every key
])
def test_long_rows_within_the_gate_either_way(d, sk, split_o, chain_keys,
                                             row_max):
    """The last rows of a causal prefill (2 048 keys at D 128; 4 096,
    the configs' max_seq, at D 256): P·V's round-toward-zero error grows
    with the keys of its chain into o.  Summed afresh each tile (D 64,
    128) or restarted every ``CHAIN_KEYS`` keys (D 256) it stays under
    2·10⁻⁵ of a row; chained over every key it stays inside the row gate
    (4.6·10⁻⁵ at D 256 and 4 096 keys, the margin the restarts widen)."""
    q, k, v = _inputs(11, (1, 1, 64, d), (1, 1, sk, d))
    kw = {} if chain_keys is None else {"chain_keys": chain_keys}
    got = flash_3xtf32(*map(torch.from_numpy, (q, k, v)), split_o=split_o,
                       **kw)
    want = _jax_want(q, k, v, True, None)
    err, row = _gate(got.numpy(), want)
    assert err <= ATOL and row <= row_max, (err, row)


@pytest.mark.parametrize("sk", [8, 13, 40])
def test_split_kv_plain_version_holds_the_models_planes(sk):
    """``split_kv`` on the CPU (``ref.split_kv_ref``, which the card test
    holds the pre-pass kernel to bit for bit) writes the model's planes:
    k's as they are, v's transposed with each group of 8 keys in
    ``ref.V_KEY_ORDER`` and zero past Sk."""
    k, v = (torch.from_numpy(x) for x in _inputs(sk, (2, 3, sk, 64),
                                                 (2, 3, sk, 64))[1:])
    kp, vp = fa.split_kv(k, v)
    assert torch.equal(kp, torch.stack(split(k)))
    skp = -(-sk // 8) * 8
    assert vp.shape == (2, 2, 3, 64, skp)
    order = torch.tensor(ref.V_KEY_ORDER)
    keys = (torch.arange(skp) // 8) * 8 + order[torch.arange(skp) % 8]
    for plane, want in zip(vp, split(v)):
        inside = keys < sk
        assert torch.equal(plane[..., inside],
                           want.transpose(-1, -2)[..., keys[inside]])
        assert not plane[..., ~inside].any()
    # the order is what the score accumulator holds as A's columns:
    # column c is key 2c, column c + 4 key 2c + 1
    assert [ref.V_KEY_ORDER[c] for c in range(4)] == [0, 2, 4, 6]
    assert [ref.V_KEY_ORDER[c + 4] for c in range(4)] == [1, 3, 5, 7]

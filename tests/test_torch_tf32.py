"""The arithmetic of the port's 3xTF32 ``matmul`` kernel, and the bf16 LM
path, against the JAX package, on the CPU.

The ``matmul`` kernel (``kernels/csrc/butterfly_count.cu``) runs on the
card only.  Here a plain PyTorch model of its arithmetic, kept in this
file and used by tests only, shows what the design promises:

* ``tf32_rna`` rounds f32 to TF32 bit for bit as ``cvt.rna.tf32.f32``
  does (10 mantissa bits, to nearest, ties away from zero);
* each operand splits into hi = rna(x) and lo = rna(x − hi); the product
  is lo·hi + hi·lo + hi·hi.  Each 32-deep k tile is summed alone in k8
  steps, one wgmma each, in the kernel's order; the model sums a step's
  eight products and the tile's partial sum exactly and rounds the
  result toward zero, as the tensor cores round.  The tile sum then
  joins the running sum by a rounded f32 add.  How the tensor cores
  align the products inside a step is not documented, so the model is
  not claimed bit-exact there: the error bound
  (``test_torch_cuda.tf32x3_bound``) allows for it, and the card test
  holds the kernel itself to that bound;
* on the graph products of ``ops.edge_wedge_matrix`` (A 0/1, W = A·Aᵀ
  integers below 2²²) every term and partial sum is an integer below
  2²⁴, so nothing is rounded: the result equals the full-f32 product and
  the JAX package's Pallas kernel (interpret mode) exactly;
* on random f32 it stays within that bound.

Then ChatGLM3 reduced to depth 2 runs in bf16 through both packages on
the weights of ``convert.numpy_params`` cast to bf16 (what the JAX
package's ``init_params(dtype=jnp.bfloat16)`` does to its f32 draw).
Tolerance: relative 3·10⁻² in the 2-norm of the logits, the JAX
package's bf16 tolerance — both packages round every product, norm and
residual to bf16 (2⁻⁸ relative), in orders that differ, and those
roundings compound over two layers.  Faults planted in the port's
attention (the wrong KV head; a softmax scale 10 % off) fail it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.models.config import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.core.graph import powerlaw_bipartite, random_bipartite
from repro_torch.kernels import ops, ref
from repro_torch.models import forward, prefill, reduced
from repro_torch.models.convert import numpy_params, params_from_numpy
from test_torch_cuda import tf32x3_bound

torch.set_num_threads(1)

K_TILE = 32      # the kernel's k tile: one 128-byte row of f32
K_STEP = 8       # the k depth of one m64nNk8 TF32 wgmma
BF16_RTOL = 3e-2


# ------------------------------------------------- the model of the kernel
def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (still stored as f32), as ``cvt.rna.tf32.f32``: add half
    of the 13 dropped bits' unit to the magnitude, clear them.  inf stays;
    NaN is passed through."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def split(x: torch.Tensor):
    """hi, lo TF32 planes of f32 ``x``; lo is 0 where hi is not finite."""
    hi = tf32_rna(x)
    lo = torch.where(torch.isfinite(hi), tf32_rna(x - hi), 0.0)
    return hi, lo


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernel computes it (module docstring).
    A lo plane of zeros, which the kernel skips, adds zeros here."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_TILE):
        part = torch.zeros_like(acc)
        for k8 in range(k0, min(k0 + K_TILE, a.shape[1]), K_STEP):
            s = slice(k8, k8 + K_STEP)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                part = round_toward_zero(
                    part.double() + x[:, s].double() @ y[s].double())
        acc = acc + part
    return acc


def _adjacency(g) -> torch.Tensor:
    return torch.from_numpy(g.adjacency()).to(torch.float32)


def _pad128(x: torch.Tensor) -> torch.Tensor:
    r, c = (-(-n // 128) * 128 - n for n in x.shape)
    return torch.nn.functional.pad(x, (0, c, 0, r))


# -------------------------------------------------------------- rounding
def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {
        one + 2 ** -11: one + 2 ** -10,        # a tie: away from zero
        -(one + 2 ** -11): -(one + 2 ** -10),
        one + 2 ** -12: one,                   # below half: down
        one + 2 ** -11 + 2 ** -20: one + 2 ** -10,
        one + 3 * 2 ** -11: one + 2 ** -9,     # a tie above an odd unit
        2.0 ** 24 + 2 ** 13: 2.0 ** 24 + 2 ** 14,
        float("inf"): float("inf"),
        0.0: 0.0,
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all()


def test_round_toward_zero():
    x = torch.tensor([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30, 3.0],
                     dtype=torch.float64)
    want = torch.tensor([1.0, -1.0, 1 - 2.0 ** -24, 3.0])
    assert torch.equal(round_toward_zero(x), want)


@pytest.mark.parametrize("top", [2 ** 11, 2 ** 16, 2 ** 22])
def test_split_is_exact_for_integers_below_2_22(top):
    x = torch.from_numpy(np.random.default_rng(top).integers(
        0, top, 50_000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)
    if top <= 2 ** 11:
        assert not lo.any()  # 0/1 and small counts have no lo plane


# ------------------------------------------------------ graph products
@pytest.mark.parametrize("g", [random_bipartite(70, 90, 900, seed=1),
                               powerlaw_bipartite(300, 200, 4000, alpha=0.6,
                                                  seed=0)],
                         ids=["rb70", "pl300"])
def test_3xtf32_is_exact_on_the_graph_products(g):
    A = _adjacency(g)
    W = matmul_3xtf32(A, A.T)
    assert torch.equal(W, ref.matmul_ref(A, A, True))
    assert torch.equal(W.double(), A.double() @ A.double().T)
    M = matmul_3xtf32(W, A)
    assert torch.equal(M, ref.matmul_ref(W, A))
    assert torch.equal(M.double(), W.double() @ A.double())
    hi, lo = split(W)
    assert torch.equal(hi + lo, W)


@pytest.mark.parametrize("n_u,n_v,m,seed", [(40, 30, 300, 0),
                                            (130, 70, 1200, 3)])
def test_3xtf32_edge_wedge_matrix_equals_jax(n_u, n_v, m, seed):
    """``ops.edge_wedge_matrix``'s two products in the kernel's arithmetic
    (on the same padded shapes) equal the JAX package's Pallas kernels."""
    A = _adjacency(random_bipartite(n_u, n_v, m, seed=seed))
    Ap = _pad128(A)  # the wrapper's padding (bm = bn = bk = 128)
    W = matmul_3xtf32(Ap, Ap.T)
    M = matmul_3xtf32(W, Ap)
    got = M[:n_u, :n_v] - A.sum(0)[None, :]
    want = np.asarray(jops.edge_wedge_matrix(jnp.asarray(A.numpy()),
                                             interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ random f32
@pytest.mark.parametrize("M,K,N", [(96, 1333, 80), (64, 4096, 48),
                                   (33, 7, 50)])
@pytest.mark.parametrize("dist", ["normal", "uniform", "wide"])
def test_3xtf32_error_on_random_f32(M, K, N, dist):
    """Within ``tf32x3_bound`` of the exact product everywhere, and
    ‖Δ‖/‖C‖ ≤ 10⁻⁵ (the card test's criteria for the kernel itself)."""
    rng = np.random.default_rng(M + K + N)
    if dist == "normal":
        a, b = rng.standard_normal((M, K)), rng.standard_normal((K, N))
    elif dist == "uniform":
        a, b = rng.random((M, K)), rng.random((K, N))
    else:  # magnitudes over 2^±20
        a = rng.standard_normal((M, K)) * 2.0 ** rng.integers(-20, 21, (M, K))
        b = rng.standard_normal((K, N)) * 2.0 ** rng.integers(-20, 21, (K, N))
    a = torch.from_numpy(a.astype(np.float32))
    b = torch.from_numpy(b.astype(np.float32))
    exact = a.double() @ b.double()
    err = (matmul_3xtf32(a, b).double() - exact).abs()
    assert (err <= tf32x3_bound(a, b)).all()
    assert err.norm() / exact.norm() <= 1e-5


# ---------------------------------------------------------- bf16 LM path
def _bf16_chatglm3():
    """(config, bf16 port weights, tokens, JAX bf16 forward logits)."""
    cfg = reduced(get_config("chatglm3_6b"), n_layers=2)
    jcfg = jreduced(jget("chatglm3_6b"), n_layers=2)
    tree = numpy_params(cfg, seed=0)
    tp = params_from_numpy(tree, cfg, "cpu", dtype=torch.bfloat16)
    jp = _map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 24))
    want = np.asarray(JM.forward(jp, jnp.asarray(toks, jnp.int32), jcfg),
                      dtype=np.float32)
    return cfg, tp, torch.from_numpy(toks), want


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_reduced_chatglm3_matches_jax():
    """Forward and prefill logits of ChatGLM3 (depth 2) in bf16 on both
    packages (module docstring: tolerance and why)."""
    cfg, tp, toks, want = _bf16_chatglm3()
    got = forward(tp, toks, cfg)
    assert got.dtype == torch.bfloat16  # as the JAX package's (no upcast)
    assert _rel(got.float().numpy(), want) <= BF16_RTOL
    last = prefill(tp, toks, cfg).float().numpy()
    assert _rel(last, want[:, -1]) <= BF16_RTOL


@pytest.mark.parametrize("fault", ["wrong kv head", "scale 10% off"])
def test_bf16_tolerance_fails_planted_faults(monkeypatch, fault):
    """The relative 3·10⁻² gate is not loose: one fault planted in the
    port's attention (two KV heads swapped; q scaled by 1.1, as a wrong
    softmax scale) fails it."""
    cfg, tp, toks, want = _bf16_chatglm3()
    assert cfg.n_kv_heads == 2
    right = ops.flash_attention

    def planted(q, k, v, **kw):
        if fault == "wrong kv head":
            return right(q, k.flip(1), v.flip(1), **kw)
        return right(q * 1.1, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", planted)
    got = forward(tp, toks, cfg).float().numpy()
    assert _rel(got, want) > BF16_RTOL


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}

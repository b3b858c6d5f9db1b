"""The port's butterfly counting (``core/counting.py``) and its four new
kernel wrappers on the CPU against the JAX package.

* every ``counting`` function against the JAX one on adjacencies drawn
  with numpy from a seed, including the blocked route that
  ``REPRO_DENSE_MAX_ELEMS`` selects and the ``assert_exact`` guard;
* ``approx_vertex_butterflies`` with every column sampled equals the
  exact counts;
* ``ops.vertex_butterflies``, ``vertex_butterflies_tiled``,
  ``edge_wedge_matrix`` and ``bloom_update`` (their plain versions here)
  against the JAX ``ops`` wrappers with the Pallas kernels in interpret
  mode, and the plain versions against the JAX ``kernels/ref.py``
  oracles.

Every count is an exact integer, so the tolerance is exact equality
throughout.  The card's cases are in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import counting as jcount
from repro.core import ref as core_ref
from repro.core.beindex import build_beindex as jbuild_beindex
from repro.core.graph import random_bipartite
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import counting as tcount
from repro_torch.kernels import ops, ref

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

SHAPES = [(40, 30, 200, 4), (130, 70, 700, 7), (257, 129, 1500, 11)]


def _adjacency(n_u, n_v, m, seed):
    g = random_bipartite(n_u, n_v, m, seed=seed)
    return g, g.adjacency()


def _eq(got: torch.Tensor, want, dtype=torch.float32) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == dtype


I64 = torch.int64   # the per-vertex counts: exact int64 in the port


@pytest.mark.parametrize("n_u,n_v,m,seed", SHAPES)
def test_counting_functions_equal_reference(n_u, n_v, m, seed):
    g, A = _adjacency(n_u, n_v, m, seed)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    _eq(tcount.wedge_counts(At), jcount.wedge_counts(Aj))
    _eq(tcount.vertex_butterflies(At), jcount.vertex_butterflies(Aj), I64)
    _eq(tcount.vertex_butterflies_blocked(At, block=64),
        jcount.vertex_butterflies_blocked(Aj, block=64), I64)
    _eq(tcount.vertex_wedge_workload(At), jcount.vertex_wedge_workload(Aj))
    _eq(tcount.total_butterflies(At), jcount.total_butterflies(Aj), I64)
    edges = g.edges.astype(np.int32)
    _eq(tcount.edge_butterflies(At, torch.from_numpy(edges).long()),
        jcount.edge_butterflies(Aj, jnp.asarray(edges)))
    alive_e = np.random.default_rng(seed).random(g.m) < 0.7
    Am = tcount.masked_adjacency((n_u, n_v), torch.from_numpy(edges).long(),
                                 torch.from_numpy(alive_e))
    _eq(Am, jcount.masked_adjacency((n_u, n_v), jnp.asarray(edges),
                                    jnp.asarray(alive_e)))
    alive_u = np.random.default_rng(seed + 1).random(n_u) < 0.6
    _eq(tcount.recount_vertex((n_u, n_v), At, torch.from_numpy(alive_u)),
        jcount.recount_vertex((n_u, n_v), Aj, jnp.asarray(alive_u)), I64)
    # and the pure-python oracle
    bu, _ = core_ref.vertex_butterflies_ref(g)
    np.testing.assert_array_equal(
        np.rint(tcount.vertex_butterflies(At).numpy()).astype(np.int64), bu)


def test_dense_limit_routes_to_the_blocked_path(monkeypatch):
    _, A = _adjacency(130, 70, 700, 3)
    full = tcount.vertex_butterflies(torch.from_numpy(A))
    monkeypatch.setenv("REPRO_DENSE_MAX_ELEMS", str(100 * 100))
    blocked = tcount.vertex_butterflies(torch.from_numpy(A), block=48)
    assert torch.equal(blocked, full)
    np.testing.assert_array_equal(
        blocked.numpy(), np.asarray(jcount.vertex_butterflies(
            jnp.asarray(A), block=48)))


def test_assert_exact_guards_the_f32_integer_range():
    tcount.assert_exact(torch.tensor([0.0, 2.0 ** 24 - 1]))
    for bad in (2.0 ** 24, -(2.0 ** 24)):
        with pytest.raises(OverflowError, match="f32 exact range"):
            tcount.assert_exact(torch.tensor([1.0, bad]))
        with pytest.raises(OverflowError, match="f32 exact range"):
            jcount.assert_exact(jnp.asarray([1.0, bad]))


@pytest.mark.parametrize("n_u,n_v,m,seed", SHAPES[:2])
def test_approx_with_every_column_is_exact(n_u, n_v, m, seed):
    _, A = _adjacency(n_u, n_v, m, seed)
    At = torch.from_numpy(A)
    gen = torch.Generator().manual_seed(seed)
    got = tcount.approx_vertex_butterflies(At, n_v, gen, n_rounds=3)
    assert torch.equal(got, tcount.vertex_butterflies(At))
    want = jcount.approx_vertex_butterflies(jnp.asarray(A), n_v,
                                            jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # fewer columns: an estimate from the generator, finite and >= 0
    est = tcount.approx_vertex_butterflies(At, n_v // 2, gen)
    assert est.shape == (n_u,) and bool(torch.isfinite(est).all())
    assert bool((est >= 0).all())


@settings(max_examples=25, deadline=None)
@given(n_u=st.integers(1, 40), n_v=st.integers(2, 30),
       density=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 16))
def test_vertex_and_edge_counts_property(n_u, n_v, density, seed):
    A = (np.random.default_rng(seed).random((n_u, n_v)) < density).astype(
        np.float32)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    _eq(tcount.vertex_butterflies(At), jcount.vertex_butterflies(Aj), I64)
    _eq(ops.vertex_butterflies(At), jref.vertex_butterflies_ref(Aj), I64)
    _eq(ops.edge_wedge_matrix(At), jref.edge_wedge_matrix_ref(Aj))


# ---------------------------------------------------------------------
# the kernel wrappers (plain versions on the CPU) against JAX ops
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n_u,n_v,m,seed", SHAPES)
@pytest.mark.parametrize("bm,bn", [(128, 128), (256, 128)])
def test_vertex_butterflies_wrapper_equals_reference(n_u, n_v, m, seed, bm,
                                                     bn):
    _, A = _adjacency(n_u, n_v, m, seed)
    At = torch.from_numpy(A)
    got = ops.vertex_butterflies(At, bm=bm, bn=bn)
    _eq(got, jops.vertex_butterflies(jnp.asarray(A), bm=bm, bn=bn,
                                     interpret=True), I64)
    _eq(ref.vertex_butterflies_ref(At), jref.vertex_butterflies_ref(
        jnp.asarray(A)), I64)
    assert torch.equal(got, tcount.vertex_butterflies(At))


@pytest.mark.parametrize("n_u,n_v,m,seed", SHAPES)
@pytest.mark.parametrize("tile_rows", [128, 200])
def test_vertex_butterflies_tiled_equals_reference(n_u, n_v, m, seed,
                                                   tile_rows):
    g, A = _adjacency(n_u, n_v, m, seed)
    got = ops.vertex_butterflies_tiled(torch.from_numpy(A),
                                       tile_rows=tile_rows)
    assert got.dtype == torch.int64
    want = jops.vertex_butterflies_tiled(A, tile_rows=tile_rows,
                                         interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)
    bu, _ = core_ref.vertex_butterflies_ref(g)
    np.testing.assert_array_equal(got.numpy(), bu)


def test_vertex_count_tile_plain_version_keeps_the_self_pair():
    _, A = _adjacency(40, 30, 200, 4)
    At = torch.from_numpy(A)
    raw = ref.vertex_count_tile_ref(At[5:17], At)
    assert raw.dtype == I64
    deg = At[5:17].sum(1).to(I64)
    assert torch.equal(raw - deg * (deg - 1) // 2,
                       ref.vertex_butterflies_ref(At)[5:17])


@pytest.mark.parametrize("n_u,n_v,m,seed", [(50, 40, 260, 260),
                                            (200, 100, 1100, 1100),
                                            (129, 257, 900, 5)])
def test_edge_wedge_matrix_equals_reference(n_u, n_v, m, seed):
    g, A = _adjacency(n_u, n_v, m, seed)
    At = torch.from_numpy(A)
    got = ops.edge_wedge_matrix(At)
    _eq(got, jops.edge_wedge_matrix(jnp.asarray(A), interpret=True))
    _eq(ref.edge_wedge_matrix_ref(At), jref.edge_wedge_matrix_ref(
        jnp.asarray(A)))
    # gathered per-edge counts equal the engine function and the oracle
    e = torch.from_numpy(g.edges).long()
    du = At.sum(1)
    cnt = got[e[:, 0], e[:, 1]] - (du[e[:, 0]] - 1)
    assert torch.equal(cnt, tcount.edge_butterflies(At, e))
    np.testing.assert_array_equal(np.rint(cnt.numpy()).astype(np.int64),
                                  core_ref.edge_butterflies_ref(g))


@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_plain_version_is_the_full_f32_product(trans_b):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 50, (70, 33)).astype(np.float32)
    b = rng.integers(0, 50, (45, 33) if trans_b else (33, 45)).astype(
        np.float32)
    got = ref.matmul_ref(torch.from_numpy(a), torch.from_numpy(b), trans_b)
    want = a.astype(np.int64) @ (b.T if trans_b else b).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def _bloom_inputs(n_u, n_v, m, seed, frac, bb):
    g = random_bipartite(n_u, n_v, m, seed=seed)
    be = jbuild_beindex(g)
    packed = jops.pack_blooms(be.link_edge, be.link_twin, be.link_bloom,
                              be.nb, bb=bb)
    nbp = packed["le"].shape[0]
    peeled = np.zeros(g.m + 1, bool)
    n_peel = int(g.m * frac)
    if n_peel:
        rng = np.random.default_rng(seed)
        peeled[rng.choice(g.m, size=n_peel, replace=False)] = True
    k_alive = np.zeros(nbp, np.float32)
    k_alive[: be.nb] = be.bloom_k
    return be, packed, peeled, k_alive


@pytest.mark.parametrize("n_u,n_v,m,seed", [(40, 30, 180, 4),
                                            (64, 48, 320, 11),
                                            (100, 40, 450, 7)])
@pytest.mark.parametrize("frac", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("bb", [128, 256])
def test_bloom_update_equals_reference(n_u, n_v, m, seed, frac, bb):
    be, packed, peeled, k_alive = _bloom_inputs(n_u, n_v, m, seed, frac, bb)
    tp = ops.pack_blooms(be.link_edge, be.link_twin, be.link_bloom, be.nb,
                         bb=bb)
    for key in ("le", "lt", "valid", "canon", "nb", "nb_pad", "K"):
        np.testing.assert_array_equal(tp[key], packed[key], err_msg=key)
    args = [packed[k] for k in ("valid",)] + [k_alive] + [
        packed[k] for k in ("le", "lt", "canon")]
    want = jops.bloom_update(jnp.asarray(peeled),
                             *(jnp.asarray(x) for x in args), bb=bb,
                             interpret=True)
    got = ops.bloom_update(torch.from_numpy(peeled),
                           *(torch.from_numpy(x) for x in args), bb=bb)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"output {i}")
    assert got[0].dtype == got[1].dtype == torch.float32
    # the kernel's plain version against the JAX oracle on the gathered
    # flags (the sentinel remap is the wrapper's)
    sent = peeled.size - 1
    le = np.where(packed["le"] < 0, sent, packed["le"])
    lt = np.where(packed["lt"] < 0, sent, packed["lt"])
    flags = (peeled[le], peeled[lt], packed["valid"], packed["canon"])
    t_out = ref.bloom_update_ref(*(torch.from_numpy(f.astype(np.uint8))
                                   for f in flags), torch.from_numpy(k_alive))
    j_out = jref.bloom_update_ref(*(jnp.asarray(f) for f in flags),
                                  jnp.asarray(k_alive))
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bloom_update_rejects_unpadded_rows():
    peeled = torch.zeros(5, dtype=torch.bool)
    x = torch.zeros((100, 128), dtype=torch.bool)
    with pytest.raises(ValueError, match="bb=256"):
        ops.bloom_update(peeled, x, torch.zeros(100), x.int(), x.int(), x)

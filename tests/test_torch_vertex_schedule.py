"""A CPU model of the int8 vertex-count kernels' schedule, held to the
JAX package.

``csrc/butterfly_count.cu`` cannot run here, so this file repeats its
arithmetic in plain int64 torch, block by block: the block → tile map
(``vc::tile_of``: 128 × 256 tiles, every tile for ``vertex_count_tile``,
only the 256 × 256 squares on and above the diagonal for
``vertex_count``, in bands of 8), the attribution of each counted entry
(r, c > r) of W = A·Aᵀ to row r and to row c, the zero rows and columns
TMA reads past the edges, and the pack's padding and 0/1 flag.  The
model's counts equal the JAX ``ops.vertex_butterflies`` (Pallas in
interpret mode) on the golden graphs and on ragged shapes that cross
the tile edges.  The kernels themselves are held to their plain
versions on the card (``tests/test_torch_cuda.py``).  Every count is an
exact integer: the tolerance is equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import powerlaw_bipartite, random_bipartite
from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.butterfly_count import pack_s8

torch.set_num_threads(1)

BM, BN, GROUP = 128, 256, 8  # vc::BM, vc::BN, vc::kGroup

GOLDEN = {  # tests/goldens/record_peel_goldens.py's graphs
    "rb30": lambda: random_bipartite(30, 24, 140, seed=0),
    "rb25": lambda: random_bipartite(25, 20, 100, seed=1),
    "pl80": lambda: powerlaw_bipartite(80, 40, 350, seed=2),
    "pl60": lambda: powerlaw_bipartite(60, 50, 300, seed=3),
}
# (n, k): n = 1, below a tile, off the 128-row tiles and the 256-wide
# squares, past 8 squares (a band's triangle and the squares right of
# it); k off the 16-byte pitch and the 128-deep k tiles
RAGGED = [(1, 5), (3, 17), (127, 16), (129, 130), (255, 1), (257, 200),
          (300, 129), (513, 33), (2100, 19)]


def tile_of(p, tri, tiles_m, tiles_n):
    """``vc::tile_of``: block p's (tile row, tile column)."""
    if not tri:
        per_group = GROUP * tiles_n
        first = (p // per_group) * GROUP
        gm = min(tiles_m - first, GROUP)
        return first + (p % per_group) % gm, (p % per_group) // gm
    half, p = p & 1, p >> 1
    i0 = 0
    while True:
        gs = min(GROUP, tiles_n - i0)
        tri_count = gs * (gs + 1) // 2
        count = tri_count + (tiles_n - i0 - gs) * gs
        if p < count:
            if p < tri_count:
                t = 0
                while (t + 1) * (t + 2) // 2 <= p:
                    t += 1
                J, I = i0 + t, i0 + p - t * (t + 1) // 2
            else:
                J, I = i0 + gs + (p - tri_count) // gs, i0 + (p - tri_count) % gs
            return 2 * I + half, J
        p -= count
        i0 += gs


def launched_tiles(rows, n, tri):
    """The tiles of the kernel's grid, in block order, without the
    blocks that return at once (the lower half of the last square row)."""
    tiles_m, tiles_n = -(-rows // BM), -(-n // BN)
    blocks = tiles_n * (tiles_n + 1) if tri else tiles_m * tiles_n
    tiles = [tile_of(p, tri, tiles_m, tiles_n) for p in range(blocks)]
    return [(tm, tn) for tm, tn in tiles if tm < tiles_m]


def model_count(A_rows8, A8, tri):
    """The kernel's int64 accumulator: for each launched tile of W =
    A_rows8·A8ᵀ (zero past the edges, as TMA reads), C(w, 2) summed by
    row (every entry) or, with ``tri``, of each entry (r, c > r) to row r
    and to row c.  Also returns how often each entry was counted."""
    rows, n = A_rows8.shape[0], A8.shape[0]
    tiles_m, tiles_n = -(-rows // BM), -(-n // BN)
    W = torch.zeros((tiles_m * BM, tiles_n * BN), dtype=torch.int64)
    W[:rows, :n] = A_rows8.long() @ A8.long().T  # s8·s8 → s32, exact
    acc = torch.zeros((tiles_n * BN,) if tri else (tiles_m * BM,),
                      dtype=torch.int64)
    seen = torch.zeros_like(W)
    r_ids = torch.arange(BM)[:, None]
    c_ids = torch.arange(BN)[None, :]
    for tm, tn in launched_tiles(rows, n, tri):
        w = W[tm * BM:(tm + 1) * BM, tn * BN:(tn + 1) * BN]
        v = w * (w - 1) // 2
        if tri:
            v = torch.where(tn * BN + c_ids > tm * BM + r_ids, v, 0)
            acc[tn * BN:(tn + 1) * BN] += v.sum(dim=0)  # columns
            seen[tm * BM:(tm + 1) * BM, tn * BN:(tn + 1) * BN] += (
                tn * BN + c_ids > tm * BM + r_ids)
        else:
            seen[tm * BM:(tm + 1) * BM, tn * BN:(tn + 1) * BN] += 1
        acc[tm * BM:(tm + 1) * BM] += v.sum(dim=1)  # rows
    return acc[:rows], seen[:rows, :n]


def _jax_counts(A):
    return np.asarray(jops.vertex_butterflies(jnp.asarray(A)), np.float32)


def _check_both_modes(A):
    n = A.shape[0]
    A8 = pack_s8(torch.from_numpy(A))
    want = _jax_counts(A)
    got, seen = model_count(A8, A8, tri=True)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    # every pair c > r counted once, the diagonal and below never
    assert torch.equal(seen, torch.ones((n, n), dtype=torch.int64).triu(1))
    raw, seen = model_count(A8, A8, tri=False)
    assert bool((seen == 1).all())
    deg = A8.long().sum(dim=1)
    np.testing.assert_array_equal(
        (raw - deg * (deg - 1) // 2).to(torch.float32).numpy(), want)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_schedule_model_equals_jax_on_goldens(name):
    _check_both_modes(GOLDEN[name]().adjacency())


@pytest.mark.parametrize("n,k", RAGGED)
def test_schedule_model_equals_jax_on_ragged_shapes(n, k):
    rng = np.random.default_rng(n * 1000 + k)
    A = (rng.random((n, k)) < 0.3).astype(np.float32)
    _check_both_modes(A)


@pytest.mark.parametrize("n", [1, 256, 257, 2100, 16384])
def test_triangular_grid_covers_each_upper_tile_once(n):
    """The triangular grid launches each tile that holds a pair c > r
    exactly once and no other tile; the tile grid (a 1 024-row strip)
    launches every tile once."""
    tiles_m, tiles_n = -(-n // BM), -(-n // BN)
    tiles = launched_tiles(n, n, tri=True)
    want = {(tm, tn) for tm in range(tiles_m) for tn in range(tiles_n)
            if tn * BN + BN - 1 > tm * BM}
    assert len(tiles) == len(set(tiles)) and set(tiles) == want
    every = launched_tiles(1024, n, tri=False)
    assert sorted(every) == [(tm, tn) for tm in range(8)
                             for tn in range(tiles_n)]


@pytest.mark.parametrize("rows,k", [(1, 1), (5, 16), (33, 17), (200, 300)])
def test_pack_pads_rows_to_16_bytes(rows, k):
    rng = np.random.default_rng(rows + k)
    A = torch.from_numpy((rng.random((rows, k)) < 0.5).astype(np.float32))
    A8 = pack_s8(A)
    kp = -(-k // 16) * 16
    assert A8.dtype == torch.int8 and A8.shape == (rows, kp)
    assert torch.equal(A8[:, :k], A.to(torch.int8))
    assert not bool(A8[:, k:].any())
    # a strip is a row slice: it starts on a 16-byte boundary (TMA)
    assert all((r0 * kp) % 16 == 0 for r0 in range(rows))


@pytest.mark.parametrize("bad", [2.0, 0.5, -1.0, float("nan"), 1e-30])
def test_pack_flags_every_value_but_0_and_1(bad):
    """The pack's flag is an OR over the matrix (each thread's four
    values, then __syncthreads_or per block): one odd value anywhere
    sets it, and every entry point refuses the matrix."""
    A = torch.from_numpy(random_bipartite(40, 30, 200, seed=4).adjacency())
    assert not bool(ref.pack_s8_ref(A)[1])
    A[17, 29] = bad
    assert bool(ref.pack_s8_ref(A)[1])
    for call in (lambda: pack_s8(A), lambda: ops.vertex_butterflies(A),
                 lambda: ops.vertex_butterflies_tiled(A, 128)):
        with pytest.raises(ValueError, match="0/1 adjacency"):
            call()

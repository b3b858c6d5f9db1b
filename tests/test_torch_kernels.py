"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode, on the real packers'
layouts; and the dispatch rule: a CPU tensor takes the plain version, any
other device reaches the kernel or raises.

The fused rounds follow the JAX package's own recipe
(``tests/test_fused_fd.py``): both packages start from the same packed
state and iterate to the fixed point, every output equal every round.
The card's cases (each kernel against its plain version on CUDA tensors)
are in ``tests/test_torch_cuda.py``, which imports no JAX because the
card's machine has none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core.distributed import (pack_fd_partitions_csr,
                                    pack_fd_partitions_tip_csr)
from repro.core.graph import powerlaw_bipartite, random_bipartite
from repro.core.peel import tip_decomposition, wing_decomposition
from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


def _wing_pack(seed, P=4):
    g = random_bipartite(30, 24, 140, seed=seed)
    wed = jcsr.build_wedges(g)
    res = wing_decomposition(g, P=P, engine="csr")
    n = int(res.part.max()) + 1
    p = pack_fd_partitions_csr(wed, res.part, res.support_init, n,
                               bucket=True, slots=True)
    R, _ = p["slot_sizes"]
    W = np.zeros((n, R), np.int32)
    w = min(R, p["W0"].shape[1])
    W[:, :w] = p["W0"][:, :w]
    z = np.zeros_like(p["sup0"])
    z1 = z[:, :1]
    state = (p["sup0"], p["mine"].astype(np.int32), z, z1, z1, z1,
             p["slot_valid"].astype(np.int32), W.astype(np.float32))
    return state, (p["slot_e1"], p["slot_e2"])


def _tip_pack(seed, P=4):
    g = random_bipartite(30, 24, 140, seed=seed)
    wed = jcsr.build_wedges(g)
    res = tip_decomposition(g, side="u", P=P, engine="csr")
    n = int(res.part.max()) + 1
    p = pack_fd_partitions_tip_csr(wed, wed.pair_butterflies0(), res.part,
                                   res.support_init, n, bucket=True,
                                   stacked=True)
    z = np.zeros_like(p["sup0"])
    z1 = z[:, :1]
    state = (p["sup0"], p["mine"].astype(np.int32), z, z1, z1)
    return state, (p["st_pa"], p["st_pb"], p["st_bf"])


def _fixed_point(state, statics, jax_round, torch_round):
    js = tuple(jnp.asarray(x) for x in state)
    jst = tuple(jnp.asarray(x) for x in statics)
    ts = tuple(torch.from_numpy(np.array(x)) for x in state)
    tst = tuple(torch.from_numpy(np.array(x)) for x in statics)
    rounds = 0
    while np.asarray(js[1]).any():
        js = jax_round(*js, *jst, interpret=True)
        out = torch_round(*ts, *tst)
        assert all(a is b for a, b in zip(out, ts)), "state not in place"
        for i, (a, b) in enumerate(zip(ts, js)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"output {i}")
            assert a.numpy().dtype == np.asarray(b).dtype, i
        rounds += 1
        assert rounds < 200, "cascade did not drain"
    assert not ts[1].any()
    return rounds


@pytest.mark.parametrize("seed", [0, 1])
def test_fd_round_wing_matches_reference(seed):
    state, statics = _wing_pack(seed)
    assert _fixed_point(state, statics, jops.fd_round_wing,
                        ops.fd_round_wing) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fd_round_tip_matches_reference(seed):
    state, statics = _tip_pack(seed)
    assert _fixed_point(state, statics, jops.fd_round_tip,
                        ops.fd_round_tip) > 0


def test_fd_round_past_the_fixed_point_changes_nothing_returned():
    """The chunked drivers queue rounds past a partition's fixed point:
    those must leave θ, alive, rounds, nupd, the slots and W as they
    are (only k moves, to the sentinel)."""
    state, statics = _wing_pack(0)
    ts = tuple(torch.from_numpy(np.array(x)) for x in state)
    tst = tuple(torch.from_numpy(np.array(x)) for x in statics)
    while ts[1].any():
        ops.fd_round_wing(*ts, *tst)
    before = tuple(t.clone() for t in ts)
    for _ in range(3):
        ops.fd_round_wing(*ts, *tst)
    for i, (a, b) in enumerate(zip(ts, before)):
        if i == 3:
            assert (a == ref.BIG).all()
        else:
            assert torch.equal(a, b), i


def _slots(name, seed):
    g = (random_bipartite(30, 24, 140, seed=0) if name == "rb30"
         else powerlaw_bipartite(80, 40, 350, seed=2))
    w = jcsr.build_wedges(g)
    rng = np.random.default_rng(seed)
    s = jcsr.pack_update_slots(w)
    pe = np.append(rng.random(w.m) < 0.25, False)
    alive = s["valid"] & (rng.random(s["valid"].shape) < 0.9)
    W = np.zeros(alive.shape[0], np.float32)
    W[:] = alive.sum(axis=1)
    return w, pe[s["e1"]], pe[s["e2"]], alive, W


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["rb30", "pl80"])
def test_support_update_matches_reference(name, seed):
    _, pe1, pe2, alive, W = _slots(name, seed)
    want = jops.support_update(jnp.asarray(pe1), jnp.asarray(pe2),
                               jnp.asarray(alive), jnp.asarray(W),
                               interpret=True)
    got = ops.support_update(*(torch.from_numpy(x)
                               for x in (pe1, pe2, alive, W)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["rb30", "pl80"])
def test_wedge_count_matches_reference(name, seed):
    w, _, _, alive, _ = _slots(name, seed)
    want = jops.pair_wedge_counts(jnp.asarray(alive), interpret=True)
    got = ops.pair_wedge_counts(torch.from_numpy(alive))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t = jcsr.pack_tip_slots(w, w.pair_butterflies0())
    pe = np.append(np.random.default_rng(seed).random(w.n_u) < 0.3, False)
    vals = np.where(pe[t["partner"]], t["bf"], 0).astype(np.int32)
    want = jops.tip_slot_loss(jnp.asarray(vals), interpret=True)
    got = ops.tip_slot_loss(torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    state, statics = _tip_pack(0)
    ts = tuple(torch.from_numpy(np.array(x)) for x in state)
    ops.fd_round_tip(*ts, *(torch.from_numpy(x) for x in statics))
    _, pe1, pe2, alive, W = _slots("rb30", 0)
    ops.support_update(*(torch.from_numpy(x) for x in (pe1, pe2, alive, W)))
    ops.pair_wedge_counts(torch.from_numpy(alive))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor on any device but the CPU goes to the kernel or raises —
    here a ``meta`` tensor, which no kernel takes."""
    m = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.support_update(m, m, m, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.pair_wedge_counts(m)
    s = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    s1 = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fd_round_tip(s, s, s, s1, s1, s, s, s)
    sl = torch.zeros((2, 8, 128), dtype=torch.int32, device="meta")
    w = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fd_round_wing(s, s, s, s1, s1, s1, sl, w, sl, sl)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_state_from_numpy_keeps_arrays_and_values():
    packed = dict(a=np.arange(6, dtype=np.int32).reshape(2, 3), sizes=(2, 3))
    st = ops.state_from_numpy(packed, "cpu")
    assert st["sizes"] == (2, 3)
    assert st["a"].dtype == torch.int32
    np.testing.assert_array_equal(st["a"].numpy(), packed["a"])

"""The port's PBNG → LM bridge and numpy oracles against the JAX package.

* ``repro_torch.core.ref`` (the copied BUP and hierarchy oracles) is
  array-equal to ``repro.core.ref`` on seeded graphs, function by
  function;
* ``core/analysis.py``: ``routing_graph``, ``moe_affinity`` (θ, exact;
  ``tests/test_system.py``'s assignment among the cases) and
  ``interaction_curriculum`` (levels and bounds, exact), the port's peel
  on the CPU against the JAX package's;
* ``data``: ``curriculum_sequences`` and ``sequence_batches``
  (``tests/test_core_extras.py``'s graph among the cases),
  ``synthetic_batches`` and ``memmap_batches``, array-equal and
  deterministic.

Every comparison is exact: integers, or numpy arithmetic copied as it
is.
"""
import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro.core import ref as jref
from repro.core.graph import BipartiteGraph as JGraph
from repro.data import graph_data as jgraph_data
from repro.data import pipeline as jpipeline
from repro_torch.core import analysis, ref
from repro_torch.core.graph import powerlaw_bipartite
from repro_torch.data import (DataConfig, curriculum_sequences,
                              memmap_batches, sequence_batches,
                              synthetic_batches)

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

GRAPHS = {
    "pl40": (40, 24, 160, 0),
    "pl60": (60, 30, 300, 8),      # tests/test_core_extras.py's curriculum graph
    "pl80": (80, 40, 400, 5),      # tests/test_system.py's graph-to-LM graph
}


def _graphs(name):
    n_u, n_v, m, seed = GRAPHS[name]
    t = powerlaw_bipartite(n_u, n_v, m, seed=seed)
    return t, JGraph(t.n_u, t.n_v, t.edges.copy())


def _assert_same(a, b):
    """Equal values, types and dtypes, through lists, tuples and dicts."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a == b


# ------------------------------------------------------------- core/ref
def test_ref_exports_match():
    assert ref.__all__ == jref.__all__


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ref_counts_and_bup_match_jax(name):
    t, j = _graphs(name)
    assert ref.butterfly_count_total(t) == jref.butterfly_count_total(j)
    for fn in ("vertex_butterflies_ref", "edge_butterflies_ref",
               "wedge_count_ref", "bup_wing_ref"):
        _assert_same(getattr(ref, fn)(t), getattr(jref, fn)(j))
    for side in ("u", "v"):
        _assert_same(ref.bup_tip_ref(t, side), jref.bup_tip_ref(j, side))


@pytest.mark.parametrize("name", ["pl40", "pl60"])
def test_ref_hierarchies_match_jax(name):
    t, j = _graphs(name)
    wing = jref.bup_wing_ref(j)
    assert ref.wing_hierarchy_ref(t, wing) == jref.wing_hierarchy_ref(j, wing)
    for side in ("u", "v"):
        tip = jref.bup_tip_ref(j, side)
        assert (ref.tip_hierarchy_ref(t, tip, side)
                == jref.tip_hierarchy_ref(j, tip, side))
    alive = np.random.default_rng(1).random(t.m) > 0.3
    assert set(ref.wing_components_ref(t, alive)) == set(
        jref.wing_components_ref(j, alive))
    alive_u = np.random.default_rng(2).random(t.n_u) > 0.3
    assert set(ref.tip_components_ref(t, alive_u)) == set(
        jref.tip_components_ref(j, alive_u))


# --------------------------------------------------------- core/analysis
def _assignment_cases():
    rng = np.random.default_rng(0)
    system = np.concatenate([rng.integers(0, 4, (50, 2)),
                             rng.integers(4, 8, (50, 2))])
    rng = np.random.default_rng(7)
    # a seeded router: 512 tokens, 16 experts, top-3 of skewed logits
    logits = rng.standard_normal((512, 16)) + np.linspace(0, 1.5, 16)
    router = np.argsort(-logits, axis=1)[:, :3]
    return {"test_system": (system, 8, 4), "router16x3": (router, 16, 8)}


@pytest.mark.parametrize("case", ["test_system", "router16x3"])
def test_moe_affinity_matches_jax(case):
    assign, n_exp, P = _assignment_cases()[case]
    g, jg = analysis.routing_graph(assign, n_exp), janalysis.routing_graph(
        assign, n_exp)
    assert (g.n_u, g.n_v) == (jg.n_u, jg.n_v)
    np.testing.assert_array_equal(g.edges, jg.edges)
    got = analysis.moe_affinity(assign, n_exp, P=P, device="cpu")
    want = janalysis.moe_affinity(assign, n_exp, P=P)
    _assert_same(np.asarray(got), np.asarray(want))
    assert got.shape == (n_exp,) and got.max() > 0
    # the port's own oracle agrees
    np.testing.assert_array_equal(got, ref.bup_tip_ref(g, side="v"))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("n_levels", [3, 4])
def test_interaction_curriculum_matches_jax(name, n_levels):
    t, j = _graphs(name)
    got = analysis.interaction_curriculum(t, n_levels=n_levels, P=4,
                                          device="cpu")
    want = janalysis.interaction_curriculum(j, n_levels=n_levels, P=4)
    _assert_same(got, want)
    # the levels are those of the oracle's wing numbers
    _assert_same(analysis.curriculum_levels(ref.bup_wing_ref(t), n_levels),
                 want)


def test_analysis_defaults_to_cuda():
    import inspect

    for fn in (analysis.moe_affinity, analysis.interaction_curriculum,
               curriculum_sequences):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("name,n_levels,max_len", [
    ("pl60", 3, 8),                # tests/test_core_extras.py's call
    ("pl80", 3, 16),               # tests/test_system.py's call
    ("pl40", 4, 5),
])
def test_curriculum_sequences_match_jax(name, n_levels, max_len):
    t, j = _graphs(name)
    got = curriculum_sequences(t, n_levels=n_levels, P=4, max_len=max_len,
                               device="cpu")
    want = jgraph_data.curriculum_sequences(j, n_levels=n_levels, P=4,
                                            max_len=max_len)
    _assert_same(got, want)
    # every interaction lands in exactly one sequence
    pairs = sorted((int(s[0]), int(x) - t.n_u) for s in got for x in s[1:])
    assert pairs == sorted(map(tuple, t.edges.tolist()))
    for batch, seq_len in ((8, 15), (3, max_len - 1), (16, 31)):
        _assert_same(list(sequence_batches(got, batch, seq_len)),
                     list(jgraph_data.sequence_batches(want, batch, seq_len)))


def test_synthetic_batches_match_jax_and_repeat():
    cfg, jcfg = (DataConfig(batch=4, seq=16, vocab=100, seed=3),
                 jpipeline.DataConfig(batch=4, seq=16, vocab=100, seed=3))
    got = synthetic_batches(cfg, start_step=5)
    want = jpipeline.synthetic_batches(jcfg, start_step=5)
    first = [next(got) for _ in range(3)]
    _assert_same(first, [next(want) for _ in range(3)])
    # restart-safe: step k's batch is the same from any start
    _assert_same(next(synthetic_batches(cfg, start_step=6)), first[1])
    assert not np.array_equal(first[0]["tokens"], first[1]["tokens"])
    extra = {"frames": lambda rng: rng.normal(size=(4, 2))}
    _assert_same(next(synthetic_batches(cfg, 2, extra)),
                 next(jpipeline.synthetic_batches(jcfg, 2, extra)))


def test_memmap_batches_match_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(4).integers(0, 10_000, 1_000).astype(
        np.int32).tofile(path)
    cfg, jcfg = (DataConfig(batch=3, seq=20, vocab=500),
                 jpipeline.DataConfig(batch=3, seq=20, vocab=500))
    got = memmap_batches(path, cfg, start_step=14)
    want = jpipeline.memmap_batches(path, jcfg, start_step=14)
    # 1 000 tokens hold 15 windows of 63: the 16th wraps to the first
    batches = [next(got) for _ in range(4)]
    _assert_same(batches, [next(want) for _ in range(4)])
    _assert_same(batches[2], next(memmap_batches(path, cfg, start_step=1)))


# ------------------------------------------- chip_smoke.py's phase 13
def test_chip_smoke_train_phase_rehearsed_on_cpu(tmp_path):
    """``chip_smoke.py``'s phase 13 on the CPU at a small size: the
    training CLI (reduced), the gradient check (narrow), crash and
    resume, the curriculum on a small graph whose θ digest the JAX
    package gives, and a small router — every gate live, the kernels'
    plain versions in place of the kernels (so no launches)."""
    import hashlib
    import importlib.util
    import os

    from repro.core.peel import wing_decomposition as jwing

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    graph = dict(n_u=80, n_v=40, m=400, alpha=0.6, seed=5)
    g = powerlaw_bipartite(**graph)
    theta = np.asarray(jwing(JGraph(g.n_u, g.n_v, g.edges.copy()), P=4,
                             engine="beindex").theta)
    fullsize = {"small": dict(graph=graph, theta_sha256=hashlib.sha256(
        theta.astype(np.int64).tobytes()).hexdigest())}
    tr = dict(
        cli=["--arch", "tinyllama_1_1b", "--reduced", "--steps", "6",
             "--batch", "2", "--seq", "32", "--lr", "0.3", "--log-every",
             "3"],
        grad=dict(arch="tinyllama_1_1b", batch=2, seq=32, overrides=dict(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab=512)),
        resume=["--arch", "tinyllama_1_1b", "--reduced", "--steps", "6",
                "--batch", "2", "--seq", "16", "--ckpt-every", "2"],
        crash_at=3, resumed_at=2,
        curriculum=dict(graph="small", n_levels=3, P=4, max_len=16,
                        batch=8, n_layers=2, lr=1e-2),
        moe=dict(experts=16, top_k=3, tokens=256, width=8, P=4, seed=0))
    launches = {}
    info = smoke.phase_train(fullsize, "cpu", str(tmp_path), launches, tr=tr)
    assert launches["flash_attention"] == 0
    assert info["cli"]["flash_attention_launches"] == 0
    assert info["profile"] == dict(device_ms=None)
    assert info["grads"]["worst_rel_l2"] <= smoke.TRAIN_GRAD_RTOL
    assert info["cli"]["held_out_loss"][1] < info["cli"]["held_out_loss"][0]
    assert info["curriculum"]["sequences"] > 10
    # the curriculum's gradient check runs at the epoch's S = max_len - 1
    assert info["curriculum"]["grads"]["tokens_shape"] == [8, 15]
    assert info["curriculum"]["grads"]["worst_rel_l2"] <= smoke.TRAIN_GRAD_RTOL
    assert info["moe"]["experts"] == 16
    # the curriculum's θ gate reads the digest: a wrong one fails
    fullsize["small"]["theta_sha256"] = "0" * 64
    with pytest.raises(AssertionError, match="theta sha256"):
        smoke.train_curriculum(fullsize, tr["curriculum"], "cpu", {})


def test_chip_smoke_train_cli_gate_needs_learning(monkeypatch):
    """The CLI run's learning gate on the CPU: with the optimizer
    disabled (every step returns the weights it was given) the held-out
    batch's loss cannot fall, and the run fails."""
    import importlib.util
    import os

    import repro_torch.train as train_pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    make = train_pkg.make_train_step

    def frozen(cfg, tcfg):
        step = make(cfg, tcfg)

        def run(params, opt, batch):
            _, _, metrics = step(params, opt, batch)
            return params, opt, metrics
        return run
    monkeypatch.setattr(train_pkg, "make_train_step", frozen)
    with pytest.raises(AssertionError, match="held-out batch"):
        smoke.train_cli(["--arch", "tinyllama_1_1b", "--reduced", "--steps",
                         "3", "--batch", "2", "--seq", "16", "--lr", "0.3",
                         "--log-every", "3"], "cpu", {})


def test_step_device_split_classes():
    """The profile's classifier on a synthetic event tree: kernels under
    the backward and optimizer labels go to those classes, the rest by
    name, and the classes sum to the device total."""
    import importlib.util
    import os
    from types import SimpleNamespace as NS

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    K = lambda name, us: NS(name=name, duration=us)

    def cpu(name, kernels=(), children=()):
        return NS(name=name, device_type=CPU, kernels=list(kernels),
                  cpu_children=list(children), self_device_time_total=0)

    mm = cpu("aten::mm", [K("sm90_xmma_gemm_f32", 50)])
    exp = cpu("aten::exp", [K("elementwise_kernel", 7)])
    bwd = cpu("flash_attention.backward", children=[mm, exp])
    opt = cpu("adamw_update", children=[cpu("aten::mul", [K("vec_mul", 4)])])
    fwd = cpu("aten::mm", [K("ampere_sgemm_128x64", 30)])
    dev = [NS(name=n, device_type=CUDA, self_device_time_total=us,
              is_user_annotation=False)
           for n, us in (("sm90_xmma_gemm_f32", 50), ("elementwise_kernel", 7),
                         ("vec_mul", 4), ("ampere_sgemm_128x64", 30),
                         ("flash_tf32_kernel<64>", 20), ("split_kv_kernel", 1),
                         ("reduce_kernel", 8))]
    # the labels' device-side spans are not kernels
    dev += [NS(name=n, device_type=CUDA, self_device_time_total=us,
               is_user_annotation=True)
            for n, us in (("flash_attention.backward", 58),
                          ("adamw_update", 4))]
    out = smoke.step_device_split([bwd, opt, fwd, *dev], wall_ms=1.0)
    assert out["device_ms"] == pytest.approx(0.12)
    assert out["split_ms"] == pytest.approx(dict(
        attention_kernel=0.021, attention_backward=0.057, optimizer=0.004,
        gemm=0.030, rest=0.008))

"""The PyTorch port's SSM (xLSTM) and hybrid (Zamba2) families against
the JAX package.

The same numpy-seeded inputs and weights (``convert.numpy_params``) go
through both packages on the CPU:

* every function of ``models/ssm.py`` on one reduced layer's weights,
  and ``chunked_recurrence`` against the sequential ``recurrence_step``
  loop at chunks 8, 16 and 64, as ``tests/test_archs.py`` asks of JAX;
* ``forward``, ``prefill``, a teacher-forced ``serve_step`` and
  ``ContinuousBatcher``'s tokens of reduced xLSTM-1.3B and Zamba2-7B;
* ``train_loss`` and every gradient leaf against
  ``jax.value_and_grad``, and a gradient step that lowers the loss;
* the full configs' parameter counts and cache shapes;
* ``numpy_params``' stream for the dense and MoE configs, unchanged by
  the constant leaves the new families add;
* ``flash_attention``'s pad-and-slice route at Zamba2's head dim 112,
  modelled on the CPU through the plain version;
* ``chip_smoke.py``'s phase 15 rehearsed at a small size (the serving
  CLI among its steps), and the training CLI.

Tolerances.  One function: the largest difference within ``FN_RTOL``
(1e-5) of the output's largest value (f32; only the summation order
differs).  Logits: ``F32`` (2e-3 absolute, as ``tests/test_torch_lm.py``;
measured ≤ 3.1e-4).  Decode against forward: ``tests/test_archs.py``'s
atol 5e-2, rtol 2e-2.  Gradients: ``SSM_GRAD_RTOL`` (2e-4 relative L2
a leaf; measured ≤ 7.9e-5 on Zamba2, 1.1e-5 on xLSTM).  That is wider
than the dense family's 1e-5 because these models amplify f32 rounding:
the chunked recurrence exponentiates cumulated log-decays, and JAX
against itself, at chunk 32 or 8 instead of 16 (the same function),
moves the same gradients by up to 4.7e-5 (Zamba2) and 9.0e-6 (xLSTM).
Each layer on its own agrees to within ``FN_RTOL``.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import get_config as jget
from repro.models import ssm as jssm
from repro.models.config import reduced as jreduced
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import (DenseLM, cache_specs, forward, init_cache,
                                prefill, reduced, ssm, train_loss)
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.models.model import fan_in, flat_items, param_specs
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.train.tree import (tree_items, tree_leaves, tree_map,
                                     tree_unflatten)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 2e-3
FN_RTOL = 1e-5
SSM_GRAD_RTOL = 2e-4
RECURRENT = ("xlstm_1_3b", "zamba2_7b")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=FN_RTOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _models(arch, seed=0, **over):
    cfg = reduced(get_config(arch), **over)
    jcfg = jreduced(jget(arch), **over)
    tree = numpy_params(cfg, seed)
    return (cfg, params_from_numpy(tree, cfg, "cpu"), jcfg,
            jax.tree.map(jnp.asarray, tree))


def _layer(tree, *idx):
    if isinstance(tree, dict):
        return {k: _layer(v, *idx) for k, v in tree.items()}
    for i in idx:
        tree = tree[i]
    return tree


def _both(tree):
    """(torch, JAX) copies of a numpy tree."""
    return (jax.tree.map(torch.from_numpy, tree),
            jax.tree.map(jnp.asarray, tree))


# ------------------------------------------------------------ functions
def _recurrence_inputs(seed=0, b=2, h=3, s=64, dk=8, dv=5):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, h, s, dk), _rand(rng, b, h, s, dk),
            _rand(rng, b, h, s, dv),
            rng.uniform(0.5, 1.0, (b, h, s)).astype(np.float32),
            rng.uniform(0.1, 1.0, (b, h, s)).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_recurrence_matches_jax_and_the_loop(chunk):
    """The chunk-parallel form against JAX's and against the port's own
    sequential ``recurrence_step`` loop (the SSD identity; 1e-3 as
    ``tests/test_archs.py``)."""
    args = _recurrence_inputs()
    got = ssm.chunked_recurrence(*map(torch.from_numpy, args), chunk=chunk)
    _close(got, jssm.chunked_recurrence(*map(jnp.asarray, args),
                                        chunk=chunk))
    q, k, v, d, g = map(torch.from_numpy, args)
    S = torch.zeros((2, 3, 8, 5))
    ys = []
    for t in range(q.shape[2]):
        S, y = ssm.recurrence_step(S, q[:, :, t], k[:, :, t], v[:, :, t],
                                   d[:, :, t], g[:, :, t])
        ys.append(y)
    np.testing.assert_allclose(_np(got), _np(torch.stack(ys, dim=2)),
                               atol=1e-3, rtol=1e-3)
    assert ssm.chunked_recurrence(*map(torch.from_numpy, args), chunk=chunk,
                                  unroll=True).equal(got)
    with pytest.raises(ValueError, match="multiple"):
        ssm.chunked_recurrence(q[:, :, :56], k[:, :, :56], v[:, :, :56],
                               d[:, :, :56], g[:, :, :56], chunk=16)


def test_recurrence_step_matches_jax():
    rng = np.random.default_rng(1)
    args = (_rand(rng, 2, 3, 8, 5), _rand(rng, 2, 3, 8), _rand(rng, 2, 3, 8),
            _rand(rng, 2, 3, 5),
            rng.uniform(0.5, 1, (2, 3)).astype(np.float32),
            rng.uniform(0.1, 1, (2, 3)).astype(np.float32))
    got = ssm.recurrence_step(*map(torch.from_numpy, args))
    want = jssm.recurrence_step(*map(jnp.asarray, args))
    for a, b in zip(got, want):
        _close(a, b)


def test_decay_is_clipped_as_jax():
    """Decays of 0 and above 1 are clipped to [1e-12, 1] before the log,
    and a decay of exactly 1 or 1e-12 splits its gradient as JAX's."""
    q, k, v, d, g = _recurrence_inputs(2, s=16)
    d[:, :, ::5] = 0.0
    d[:, :, 1::5] = 1.5
    d[:, :, 2::5] = 1.0
    got = ssm.chunked_recurrence(*map(torch.from_numpy, (q, k, v, d, g)),
                                 chunk=8)
    _close(got, jssm.chunked_recurrence(*map(jnp.asarray, (q, k, v, d, g)),
                                        chunk=8))
    w = _rand(np.random.default_rng(3), *got.shape)
    td = torch.tensor(d, requires_grad=True)
    (ssm.chunked_recurrence(*map(torch.from_numpy, (q, k, v)), td,
                            torch.from_numpy(g), chunk=8)
     * torch.from_numpy(w)).sum().backward()
    jd = jax.grad(lambda dd: jnp.sum(jssm.chunked_recurrence(
        *map(jnp.asarray, (q, k, v)), dd, jnp.asarray(g), chunk=8) * w))(
            jnp.asarray(d))
    _close(td.grad, jd)


def _mamba_case(seed=0):
    cfg, _, jcfg, _ = _models("zamba2_7b")
    tree = numpy_params(cfg, seed)
    p = _layer(tree["blocks"], 1)
    rng = np.random.default_rng(seed + 5)
    p["dt_bias"] = _rand(rng, *p["dt_bias"].shape)   # not the zero init
    p["A_log"] = 0.5 * _rand(rng, *p["A_log"].shape)
    return cfg, jcfg, p, rng


def test_mamba2_mix_and_parts_match_jax():
    cfg, jcfg, p, rng = _mamba_case()
    x = _rand(rng, 2, 32, cfg.d_model)
    tp, jp = _both(p)
    got = ssm._mamba_parts(torch.from_numpy(x), tp, cfg)
    want = jssm._mamba_parts(jnp.asarray(x), jp, jcfg)
    for a, b in zip(got[:6], want[:6]):
        _close(a, b)
    assert got[6:] == want[6:]
    _close(ssm._causal_conv(torch.from_numpy(x[..., :64]),
                            tp["conv_w"][:, :64]),
           jssm._causal_conv(jnp.asarray(x[..., :64]), jp["conv_w"][:, :64]))
    _close(ssm.mamba2_mix(torch.from_numpy(x), tp, cfg),
           jssm.mamba2_mix(jnp.asarray(x), jp, jcfg))


def test_mamba2_step_matches_jax():
    cfg, jcfg, p, rng = _mamba_case(1)
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // 64
    x = _rand(rng, 2, cfg.d_model)
    conv = _rand(rng, 2, cfg.ssm_conv, d_inner)
    S = _rand(rng, 2, nh, cfg.ssm_state, 64)
    tp, jp = _both(p)
    got = ssm.mamba2_step(torch.from_numpy(x),
                          (torch.from_numpy(conv), torch.from_numpy(S)), tp,
                          cfg)
    want = jssm.mamba2_step(jnp.asarray(x), (jnp.asarray(conv),
                                             jnp.asarray(S)), jp, jcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b)


def test_mlstm_mix_and_step_match_jax():
    cfg, _, jcfg, _ = _models("xlstm_1_3b")
    p = _layer(numpy_params(cfg, 0)["mlstm"], 0, 2)
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 32, cfg.d_model)
    tp, jp = _both(p)
    _close(ssm.mlstm_mix(torch.from_numpy(x), tp, cfg),
           jssm.mlstm_mix(jnp.asarray(x), jp, jcfg))
    nh, dh = cfg.n_heads, cfg.lstm_proj_factor * cfg.d_model // cfg.n_heads
    st = (_rand(rng, 2, nh, dh, dh), _rand(rng, 2, nh, dh))
    xt = _rand(rng, 2, cfg.d_model)
    got = ssm.mlstm_step(torch.from_numpy(xt),
                         tuple(map(torch.from_numpy, st)), tp, cfg)
    want = jssm.mlstm_step(jnp.asarray(xt), tuple(map(jnp.asarray, st)), jp,
                           jcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b)


def test_slstm_mix_and_step_match_jax():
    """sLSTM's time loop and step, with inputs large enough that the
    capped exp gate (exp(min(i, 8))) caps."""
    cfg, _, jcfg, _ = _models("xlstm_1_3b")
    p = _layer(numpy_params(cfg, 0)["slstm"], 0)
    rng = np.random.default_rng(8)
    x = 8 * _rand(rng, 2, 24, cfg.d_model)
    tp, jp = _both(p)
    gi = np.einsum("bsd,de->bse", x, p["W"]).reshape(2, 24, cfg.n_heads, 4, -1)
    assert (gi[:, :, :, 0] > 8).any()
    _close(ssm.slstm_mix(torch.from_numpy(x), tp, cfg),
           jssm.slstm_mix(jnp.asarray(x), jp, jcfg))
    dh2 = cfg.d_model // cfg.n_heads
    st = tuple(_rand(rng, 2, cfg.n_heads, dh2) for _ in range(3))
    st = (st[0], st[1], np.abs(st[2]) + 1)
    got = ssm.slstm_step(torch.from_numpy(x[:, 0]),
                         tuple(map(torch.from_numpy, st)), tp, cfg)
    want = jssm.slstm_step(jnp.asarray(x[:, 0]), tuple(map(jnp.asarray, st)),
                           jp, jcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b)


def test_softplus_threshold_is_within_rounding():
    """``F.softplus`` returns x above 20; JAX's ``logaddexp(x, 0)`` adds
    log1p(e^-x), below half an f32 ulp of x there."""
    x = np.linspace(-30, 60, 9001).astype(np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_prefill_decode_match_jax(arch):
    cfg, tp, jcfg, jp = _models(arch)
    s = 2 * cfg.ssm_chunk          # two chunks: the inter-chunk scan runs
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, s))
    tt = torch.from_numpy(toks)
    want = np.asarray(JM.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = forward(tp, tt, cfg)
    np.testing.assert_allclose(_np(got), want, atol=F32)
    np.testing.assert_allclose(_np(prefill(tp, tt, cfg)), want[:, -1],
                               atol=F32)
    cache = init_cache(cfg, 2, s, "cpu")
    jcache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          JM.cache_specs(jcfg, 2, s, dtype=jnp.float32))
    model = DenseLM(cfg, tp)
    jstep = jax.jit(lambda p, c, t, l: JM.serve_step(p, c, t, l, jcfg))
    for t in range(s):
        lg, cache2 = model.serve_step(cache, tt[:, t], t)
        assert cache2 is cache
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t], jnp.int32),
                            jnp.int32(t))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=F32)
        np.testing.assert_allclose(_np(lg), want[:, t], atol=5e-2,
                                   rtol=2e-2)
    for k, v in cache.items():
        np.testing.assert_allclose(_np(v), np.asarray(jcache[k]), atol=F32)


@pytest.mark.parametrize("arch", RECURRENT)
def test_batcher_tokens_match_jax(arch):
    cfg, tp, jcfg, jp = _models(arch, seed=1)
    rng = np.random.default_rng(3)
    reqs = [dict(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i).tolist(),
                 max_new=5) for i in range(4)]
    eng = ContinuousBatcher(cfg, tp, n_slots=2, max_seq=24, device="cpu")
    jeng = JBatcher(jcfg, jp, n_slots=2, max_seq=24)
    for r in reqs:
        eng.submit(Request(**r))
        jeng.submit(JRequest(**r))
    got = {r.uid: r.output for r in eng.run()}
    want = {r.uid: r.output for r in jeng.run()}
    assert got == want and len(got) == 4
    assert eng.steps == jeng.steps
    # the recurrent state was zeroed at the last quiescent point
    assert eng.position == 0
    assert not any(t.any() for t in eng._cache.values())


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_loss_and_grads_match_jax(arch):
    cfg, _, jcfg, _ = _models(arch)
    tree = numpy_params(cfg, 1)
    rng = np.random.default_rng(2)
    batch = dict(tokens=rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32),
                 labels=rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32))
    jl, jg = jax.value_and_grad(JM.train_loss)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(tree, cfg, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = train_loss(leaves, tb, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for (path, _), got, want in zip(tree_items(leaves), grads, jleaves):
        assert got.shape == want.shape
        assert _rel(_np(got), want) <= SSM_GRAD_RTOL, ".".join(path)
    # a short step down the gradient lowers the loss (tests/test_archs.py
    # steps xLSTM by 0.5·g; Zamba2's gradient here is far larger, so the
    # step is 1e-2 / ‖g‖)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads)).item()
    lr = 0.5 if arch == "xlstm_1_3b" else 1e-2 / norm
    with torch.no_grad():
        stepped = tree_map(lambda p, g: p - lr * g, leaves,
                           tree_unflatten(leaves, list(grads)))
        assert train_loss(stepped, tb, cfg).item() < loss.item()


# -------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", RECURRENT)
def test_param_counts_and_cache_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    # the JAX config's counts, copied, not corrected (xLSTM's "1.3B" is
    # 3.53 G at these widths)
    assert round(cfg.param_count() / 1e9, 2) == {"xlstm_1_3b": 3.53,
                                                 "zamba2_7b": 6.75}[arch]
    got = cache_specs(cfg, 3, 40, torch.float32)
    want = JM.cache_specs(jcfg, 3, 40, dtype=jnp.float32)
    assert list(got) == list(want)
    for k, (shape, dt) in got.items():
        assert shape == tuple(want[k].shape), k
        assert str(dt).split(".")[-1] == str(want[k].dtype), k
    bf = cache_specs(cfg, 1, 8)  # the recurrent states stay f32
    assert {k: str(dt) for k, (_, dt) in bf.items()} == {
        k: ("torch.float32" if str(v.dtype) == "float32" else "torch.bfloat16")
        for k, v in JM.cache_specs(jcfg, 1, 8).items()}


def test_numpy_params_stream_unchanged_for_dense_and_moe():
    """No dense or MoE leaf is constant-zero, and every dense and MoE
    tree is what drawing each non-``ones`` leaf in order gives (the
    stream ``torch_lm.json`` and ``torch_moe.json`` were recorded on)."""
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.family not in ("dense", "moe"):
            continue
        assert {s.init for _, s in flat_items(param_specs(cfg))} <= {
            "normal", "ones"}, arch
        small = reduced(cfg, n_layers=1)
        rng = np.random.default_rng(4)
        for path, arr in flat_items(numpy_params(small, 4)):
            spec = dict(flat_items(param_specs(small)))[path]
            if spec.init == "ones":
                want = np.ones(spec.shape, np.float32)
            else:
                want = rng.standard_normal(spec.shape, dtype=np.float32)
                want *= np.float32(fan_in(spec.shape) ** -0.5)
            np.testing.assert_array_equal(arr, want, err_msg=path)
    for arch in RECURRENT:  # the constant leaves draw nothing
        tree = numpy_params(reduced(get_config(arch)), 0)
        if arch == "zamba2_7b":
            assert not tree["blocks"]["A_log"].any()
            assert not tree["blocks"]["dt_bias"].any()
            assert (tree["blocks"]["D"] == 1).all()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_head_dim_112_pads_to_the_128_instance(dt):
    """Zamba2's shared attention (32/32 heads of D 112, shrunk): the
    wrapper's route on the card pads q, k and v to the D 128 instance,
    runs it at 112^-1/2 and cuts the output to 112; on the CPU the plain
    version on the padded inputs, cut, is the plain version on the
    unpadded ones."""
    assert fa.padded_head_dim(112, 112) == 128
    assert get_config("zamba2_7b").resolved_head_dim == 112
    g = torch.Generator().manual_seed(112)
    q, k, v = (torch.randn((1, 4, 96, 112), generator=g).to(dt)
               for _ in range(3))
    pq, pk, pv = fa.pad_head_dims(q, k, v)
    assert pq.shape[-1] == pk.shape[-1] == pv.shape[-1] == 128
    assert not pv[..., 112:].any()
    got = ref.flash_attention_ref(pq, pk, pv, causal=True,
                                  scale=112 ** -0.5)[..., :112]
    want = ref.flash_attention_ref(q, k, v, causal=True)
    atol = 1e-6 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


# ------------------------------------------------------------------ CLIs
def test_train_cli_on_cpu():
    """``launch.train`` takes the SSM family, as the JAX CLI does (the
    serving CLI runs in the phase 15 rehearsal below)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xlstm_1_3b", "--reduced", "--steps", "4", "--batch", "2", "--seq",
         "16", "--log-every", "1", "--device", "cpu"],
        env=env, check=True, capture_output=True, text=True,
        timeout=300).stdout.splitlines()
    losses = [float(line.split()[4]) for line in out
              if line.startswith("[train] step ")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert out[-1].startswith("[train] done: loss ")


# ------------------------------------------------------- the smoke phase
def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ssm_phase_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 15 on the CPU at a small size: the
    recorder's own ``record`` (the JAX package) writes the goldens for
    reduced xLSTM (one group) and Zamba2 (one shared-block application),
    and the phase holds the port to them (the bf16 golden to the
    recorder's own bf16 drift), with every other gate live.  A chunked
    recurrence that drops the carry between chunks must fail."""
    smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    rec = _load("record_torch_ssm", os.path.join(
        ROOT, "tests", "goldens", "record_torch_ssm.py"))
    depth = {"xlstm_1_3b": 8, "zamba2_7b": 6}
    golden = {arch: rec.record(jreduced(jget(arch), n_layers=n),
                               rec.MODELS[i][2], batch=2, seq=32,
                               positions=(0, 15, 31), n_ids=64,
                               log=lambda msg: None)
              for i, (arch, n) in enumerate(depth.items())}
    golden["zamba2_7b"]["bf16_prefill_rel"] = rec.bf16_prefill_rel(
        jreduced(jget("zamba2_7b"), n_layers=6), golden["zamba2_7b"])
    gcfgs = {arch: reduced(get_config(arch), n_layers=n)
             for arch, n in depth.items()}
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    small = dict(batch=2, seq=32, check_batch=2, check_seq=32, stride=4,
                 recurrence=dict(heads=2, dk=16, dv=8, seq=64))
    spec = dict(
        smoke.SSM,
        attention=dict(smoke.SSM["attention"], heads=4, seq=64, dqk=24,
                       dv=24, time_batch=2, reps=1),
        xlstm=dict(smoke.SSM["xlstm"], cfg=reduced(get_config("xlstm_1_3b")),
                   **small),
        zamba=dict(smoke.SSM["zamba"], cfg=reduced(get_config("zamba2_7b")),
                   serve=dict(
                       smoke.SSM["zamba"]["serve"], slots=2, requests=3,
                       prompt=(3, 6), max_new=4, max_seq=16, eos_index=2),
                   **small),
        cli=[*smoke.SSM["cli"], "--batch", "2", "--prompt-len", "4",
             "--gen", "4"])
    launches = {}
    row, info = smoke.phase_ssm(golden, "cpu", launches, spec=spec,
                                golden_cfgs=gcfgs)
    assert launches == {"flash_attention": 0} and row["launches"] == 0
    assert [c["dtype"] for c in row["cases"]] == ["bfloat16", "float32"]
    assert [c["padded_head_dim"] for c in row["cases"]] == [32, 32]
    for name in ("xlstm", "zamba"):
        assert info[name]["decode"]["max_abs_err"] < 5e-2
        assert info[name]["recurrence"]["max_abs_err"] < 1e-3
    assert info["zamba"]["serve"]["requests"] == 3
    for errs in info["golden"].values():
        assert max(v for k, v in errs.items()
                   if k != "bf16") < smoke.LOGIT_ATOL
    bf16 = info["golden"]["zamba2_7b"]["bf16"]
    assert bf16["rel"] <= bf16["limit"]
    # the inter-chunk carry dropped: decode no longer matches forward
    from repro_torch.models import ssm as tssm
    real = tssm.chunked_recurrence

    def no_carry(q, k, v, decay, gain, chunk=64, unroll=False):
        ys = [real(q[:, :, i:i + chunk], k[:, :, i:i + chunk],
                   v[:, :, i:i + chunk], decay[:, :, i:i + chunk],
                   gain[:, :, i:i + chunk], chunk)
              for i in range(0, q.shape[2], min(chunk, q.shape[2]))]
        return torch.cat(ys, dim=2)
    monkeypatch.setattr(tssm, "chunked_recurrence", no_carry)
    with pytest.raises(AssertionError):
        smoke.phase_ssm(golden, "cpu", {}, spec=spec, golden_cfgs=gcfgs)

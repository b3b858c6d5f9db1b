"""The PyTorch port's MoE family against the JAX package.

The same numpy-seeded inputs and weights (``convert.numpy_params``) go
through both packages on the CPU:

* ``moe.capacity`` over a grid, and ``moe.moe_layer`` at ``reduced``'s
  capacity factor 8 (nothing dropped), at 1.25 with s 64 (drops happen)
  and with an all-zero router (every probability ties; ``lax.top_k``
  sends every token to experts 0..k−1);
* DeepSeek-V2's latent attention (``_mla_qkv``, ``mla_attention``, the
  naive and the absorbed decode) layer by layer;
* ``forward``, ``prefill`` and a teacher-forced ``serve_step`` of reduced
  DBRX and DeepSeek-V2, and ``ContinuousBatcher``'s tokens;
* the full configs' parameter counts (training:
  ``tests/test_torch_moe_train.py``);
* ``ops.flash_attention`` with v's head dim below q's (MLA) and an
  explicit scale, and the wrapper's zero-padding to an instance, modelled
  on the CPU through the plain version;
* ``chip_smoke.py``'s phase 14 rehearsed at a small size.

Tolerances: 1e-5 absolute for one layer (f32, only the summation order
differs); ``F32`` (2e-3, the JAX package's f32 attention tolerance) for
attention and logits, as ``tests/test_torch_lm.py``.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import get_config as jget
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtrans
from repro.models.config import reduced as jreduced
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import (DenseLM, forward, init_cache, moe, prefill,
                                reduced, serve_step, transformer)
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.serve import ContinuousBatcher, Request

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 2e-3
ATOL = 1e-5
MOE = ("dbrx_132b", "deepseek_v2_236b")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _models(arch, n_layers=2, seed=0, **over):
    cfg = reduced(get_config(arch), n_layers=n_layers, **over)
    jcfg = jreduced(jget(arch), n_layers=n_layers, **over)
    tree = numpy_params(cfg, seed)
    return (cfg, params_from_numpy(tree, cfg, "cpu"), jcfg,
            jax.tree.map(jnp.asarray, tree))


def _layer(tree, i):
    """Layer ``i`` of a stacked tree (torch or JAX leaves)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------- dispatch
def test_capacity_matches_jax():
    for arch in MOE:
        for s in (1, 7, 64, 100, 2048):
            for k in (1, 2, 4, 6):
                for E in (8, 16, 160):
                    for cf in (1.0, 1.25, 2.0, 8.0, E / k):
                        cfg = dataclasses.replace(
                            get_config(arch), n_experts=E, top_k=k,
                            capacity_factor=cf)
                        jcfg = dataclasses.replace(
                            jget(arch), n_experts=E, top_k=k,
                            capacity_factor=cf)
                        assert moe.capacity(cfg, s) == jmoe.capacity(jcfg, s)
    # the published configs at the smoke's prefill shape
    assert moe.capacity(get_config("deepseek_v2_236b"), 2048) == 96
    assert moe.capacity(get_config("dbrx_132b"), 2048) == 640


def _dropped(idx, E, C):
    """(token, expert) pairs past their expert's first C in a group."""
    b = idx.shape[0]
    counts = np.stack([np.bincount(idx[i].reshape(-1), minlength=E)
                       for i in range(b)])
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf,s", [(8.0, 16), (1.25, 64)])
def test_moe_layer_matches_jax(arch, cf, s):
    """At ``reduced``'s capacity factor 8 nothing is dropped; at 1.25 and
    s 64 the layer drops pairs, and the same ones as JAX (a different
    pair changes the output by O(1)).  The tokens share a component, so
    the router favours some experts (on independent tokens 8 experts at
    top-2 rarely pass C 24)."""
    cfg, tp, jcfg, jp = _models(arch, n_layers=1, capacity_factor=cf)
    rng = np.random.default_rng(s)
    x = _rand(rng, 2, s, cfg.d_model) + 2 * _rand(rng, cfg.d_model)
    tl, jl = _layer(tp["blocks"]["ffn"], 0), _layer(jp["blocks"]["ffn"], 0)
    got = moe.moe_layer(torch.from_numpy(x), tl, cfg)
    want = jmoe.moe_layer(jnp.asarray(x), jl, jcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    _, idx = moe.route(torch.from_numpy(x), tl["router"], cfg)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, jl["router"]), -1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    drops = _dropped(idx.numpy(), cfg.n_experts, moe.capacity(cfg, s))
    assert (drops > 0) == (cf == 1.25), drops


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_ties_go_to_the_lower_expert(arch):
    """An all-zero router: every probability ties, ``lax.top_k`` picks
    experts 0..k−1 for every token, and the capacity keeps the first C
    tokens of each group in order; the port does the same."""
    cfg, tp, jcfg, jp = _models(arch, n_layers=1, capacity_factor=1.25)
    tl, jl = _layer(tp["blocks"]["ffn"], 0), _layer(jp["blocks"]["ffn"], 0)
    tl["router"] = torch.zeros_like(tl["router"])
    jl["router"] = jnp.zeros_like(jl["router"])
    x = _rand(np.random.default_rng(9), 2, 32, cfg.d_model)
    gates, idx = moe.route(torch.from_numpy(x), tl["router"], cfg)
    assert (idx == torch.arange(cfg.top_k)).all()
    np.testing.assert_allclose(gates.numpy(), 1.0 / cfg.top_k, rtol=1e-6)
    got = moe.moe_layer(torch.from_numpy(x), tl, cfg)
    want = jmoe.moe_layer(jnp.asarray(x), jl, jcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    # 32 tokens on the same k experts, C of them kept: later tokens get
    # the shared experts only (or nothing, without them)
    C = moe.capacity(cfg, 32)
    assert C < 32
    tail = got[:, C:]
    if cfg.n_shared_experts:
        from repro_torch.models.layers import mlp
        tail = tail - mlp(torch.from_numpy(x[:, C:]), tl["shared"],
                          cfg.mlp_type)
    assert tail.abs().max() < ATOL


def test_moe_layer_planted_ties_within_top_k():
    """Planted ties at the k-th place: probabilities equal between a
    chosen and an unchosen expert go to the lower id, as ``lax.top_k``."""
    cfg, tp, jcfg, jp = _models("deepseek_v2_236b", n_layers=1)
    E = cfg.n_experts
    # router columns: experts 1 and 3 equal, 0 and 2 equal, each pair's
    # logits the same on every token
    w = np.zeros((cfg.d_model, E), np.float32)
    w[:, 1] = w[:, 3] = _rand(np.random.default_rng(1), cfg.d_model)
    w[:, 0] = w[:, 2] = 0.5 * w[:, 1]
    x = _rand(np.random.default_rng(2), 2, 16, cfg.d_model)
    _, idx = moe.route(torch.from_numpy(x), torch.from_numpy(w), cfg)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, w), -1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# ------------------------------------------------------------------ MLA
def test_mla_qkv_and_attention_match_jax():
    cfg, tp, jcfg, jp = _models("deepseek_v2_236b", n_layers=1)
    x = _rand(np.random.default_rng(3), 2, 24, cfg.d_model)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    tl, jl = _layer(tp["blocks"]["attn"], 0), _layer(jp["blocks"]["attn"], 0)
    got = transformer._mla_qkv(torch.from_numpy(x), tl, cfg,
                               torch.from_numpy(pos))
    want = jtrans._mla_qkv(x, jl, jcfg, pos)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL)
    got = transformer.mla_attention(torch.from_numpy(x), tl, cfg,
                                    torch.from_numpy(pos))
    want = jtrans.mla_attention(x, jl, jcfg, pos)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_mla_decodes_match_jax_and_each_other():
    """Naive and absorbed MLA decode, step by step, against JAX's: the
    outputs and the compressed cache (roped keys); and the absorbed
    equal to the naive, as ``tests/test_perf_knobs.py::test_mla_absorb_exact``
    requires of JAX."""
    cfg, tp, jcfg, jp = _models("deepseek_v2_236b", n_layers=1)
    tl, jl = _layer(tp["blocks"]["attn"], 0), _layer(jp["blocks"]["attn"], 0)
    xs = _rand(np.random.default_rng(4), 10, 2, cfg.d_model)
    width = cfg.kv_lora + cfg.qk_rope_dim
    outs = {}
    for absorb in (False, True):
        c, jc = dataclasses.replace(cfg, mla_absorb=absorb), \
            dataclasses.replace(jcfg, mla_absorb=absorb)
        fn = (transformer.mla_attention_decode_absorbed if absorb
              else transformer.mla_attention_decode)
        jfn = (jtrans.mla_attention_decode_absorbed if absorb
               else jtrans.mla_attention_decode)
        cache = torch.zeros((2, 12, width))
        jcache = jnp.zeros((2, 12, width))
        steps = []
        for i, x in enumerate(xs):
            o, cache = fn(torch.from_numpy(x), tl, c, cache, i)
            jo, jcache = jfn(x, jl, jc, jcache, jnp.int32(i))
            np.testing.assert_allclose(_np(o), np.asarray(jo), atol=ATOL)
            steps.append(_np(o))
        np.testing.assert_allclose(_np(cache), np.asarray(jcache), atol=ATOL)
        outs[absorb] = np.stack(steps)
        with pytest.raises(IndexError, match="outside"):
            fn(torch.from_numpy(xs[0]), tl, c, cache, 12)
    np.testing.assert_allclose(outs[True], outs[False], atol=ATOL)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_decode_match_jax(arch):
    cfg, tp, jcfg, jp = _models(arch)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 16))
    want = np.asarray(JM.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = _np(forward(tp, torch.from_numpy(toks), cfg))
    np.testing.assert_allclose(got, want, atol=F32)
    np.testing.assert_allclose(_np(prefill(tp, torch.from_numpy(toks), cfg)),
                               want[:, -1], atol=F32)
    np.testing.assert_array_equal(
        _np(DenseLM(cfg, tp)(torch.from_numpy(toks))), got)
    cache = init_cache(cfg, 2, 16, "cpu")
    jcache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          JM.cache_specs(jcfg, 2, 16, dtype=jnp.float32))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
    step = jax.jit(lambda p, c, t, l: JM.serve_step(p, c, t, l, jcfg))
    for i in range(16):
        tl, cache = serve_step(tp, cache, torch.from_numpy(toks[:, i]), i, cfg)
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i], jnp.int32),
                          jnp.int32(i))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32)
        np.testing.assert_allclose(_np(tl), got[:, i], atol=F32)
    for name in cache:
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]),
                                   atol=F32)


def test_forward_drops_like_jax_at_the_published_capacity():
    """Reduced DeepSeek-V2 at capacity factor 1.25: the forward drops
    (token, expert) pairs, so it no longer equals the decode path, and
    it still equals JAX's forward."""
    cfg, tp, jcfg, jp = _models("deepseek_v2_236b", capacity_factor=1.25)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 64))
    want = np.asarray(JM.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = _np(forward(tp, torch.from_numpy(toks), cfg))
    np.testing.assert_allclose(got, want, atol=F32)


def test_batcher_tokens_match_jax():
    cfg, tp, jcfg, jp = _models("deepseek_v2_236b")
    rng = np.random.default_rng(8)
    reqs = [dict(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i).tolist(),
                 max_new=5) for i in range(5)]
    eng = ContinuousBatcher(cfg, tp, n_slots=2, max_seq=32, device="cpu")
    jeng = JBatcher(jcfg, jp, n_slots=2, max_seq=32)
    for r in reqs:
        eng.submit(Request(**r))
        jeng.submit(JRequest(**r))
    got = {r.uid: r.output for r in eng.run()}
    want = {r.uid: r.output for r in jeng.run()}
    assert got == want and len(got) == 5
    assert eng.steps == jeng.steps
    assert set(eng._cache) == {"ckv"}


@pytest.mark.parametrize("arch", MOE)
def test_param_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    # within 5 % of the 132 B and 236 B in the names
    named = int(arch.split("_")[-1][:-1]) * 1e9
    assert abs(cfg.param_count() / named - 1) < 0.05


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_takes_mla_head_dims(causal):
    """q/k of 48 dims and v of 32 (MLA's 192/128 shrunk), with the
    default and an explicit scale, against JAX's ``blockwise_attention``
    (which reads v's own head dim)."""
    rng = np.random.default_rng(10)
    q, k, v = _rand(rng, 2, 4, 40, 48), _rand(rng, 2, 4, 40, 48), \
        _rand(rng, 2, 4, 40, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == (2, 4, 40, 32)
    want = jlayers.blockwise_attention(q, k, v, causal=causal, block_q=16,
                                       block_k=16)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32)
    scaled = ops.flash_attention(tq, tk, tv, causal=causal, scale=0.05)
    want = jlayers.blockwise_attention(q * np.float32(0.05 * 48 ** 0.5), k, v,
                                       causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(_np(scaled), np.asarray(want), atol=F32)


@pytest.mark.parametrize("d,dv,padded", [(192, 128, 256), (48, 48, 64),
                                         (64, 32, 64), (128, 128, 128),
                                         (16, 8, 32)])
def test_kernel_padding_model_on_the_cpu(d, dv, padded):
    """The wrapper's pad-and-slice on the CPU: ``pad_head_dims`` gives
    the instance ``padded_head_dim`` picks, zero past the head dims, and
    the plain version on the padded inputs at D^-1/2, cut to Dv, is the
    plain version on the unpadded ones, in both dtypes."""
    assert fa.padded_head_dim(d, dv) == padded
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(d + dv)
        q, k = (torch.randn((1, 4, 33, d), generator=g).to(dt)
                for _ in range(2))
        v = torch.randn((1, 2, 33, dv), generator=g).to(dt)
        k = k[:, :2]
        pq, pk, pv = fa.pad_head_dims(q, k, v)
        assert pq.shape[-1] == pk.shape[-1] == pv.shape[-1] == padded
        for t, p in ((q, pq), (k, pk), (v, pv)):
            assert torch.equal(p[..., :t.shape[-1]], t)
            assert not p[..., t.shape[-1]:].any()
        if (d, dv) == (padded, padded):
            assert pq is q and pv is v
        got = ref.flash_attention_ref(pq, pk, pv, causal=True,
                                      scale=d ** -0.5)[..., :dv]
        want = ref.flash_attention_ref(q, k, v, causal=True)
        atol = 1e-6 if dt == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)
    with pytest.raises(ValueError, match="largest instance"):
        fa.padded_head_dim(320, 128)


# ------------------------------------------------------- the smoke phase
def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_moe_phase_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 14 on the CPU at a small size: the
    recorder's own ``record`` (the JAX package) writes the golden for a
    reduced DeepSeek-V2 at capacity factor 1.25 (the forward drops), and
    the phase holds the port to it, with every other gate live."""
    smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    rec = _load("record_torch_moe", os.path.join(
        ROOT, "tests", "goldens", "record_torch_moe.py"))
    gcfg = reduced(get_config("deepseek_v2_236b"), n_layers=1,
                   capacity_factor=1.25)
    golden = rec.record(jreduced(jget("deepseek_v2_236b"), n_layers=1,
                                 capacity_factor=1.25),
                        batch=2, seq=32, positions=(0, 15, 31), n_ids=64,
                        log=lambda msg: None)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    moe_spec = smoke.MOE

    def cfg(arch, n):  # the published capacity factor: the forwards drop
        return reduced(get_config(arch), n_layers=n, capacity_factor=1.25)

    spec = dict(
        moe_spec,
        attention=dict(moe_spec["attention"], heads=4, seq=64, dqk=48, dv=32,
                       time_batch=2, reps=1),
        deepseek=dict(moe_spec["deepseek"], cfg=cfg("deepseek_v2_236b", 2),
                      batch=2, seq=64, check_seq=24, stride=4,
                      serve=dict(moe_spec["deepseek"]["serve"], slots=2,
                                 requests=3, prompt=(3, 8), max_new=6,
                                 max_seq=32, eos_index=3)),
        dbrx=dict(moe_spec["dbrx"], cfg=cfg("dbrx_132b", 1), batch=2,
                  seq=64),
        affinity_P=4,
        cli=[*moe_spec["cli"], "--batch", "2", "--prompt-len", "4", "--gen",
             "4"],
        train=dict(moe_spec["train"], cfgs=[cfg("dbrx_132b", 1),
                                            cfg("deepseek_v2_236b", 1)],
                   seq=64, cli_flags=["--steps", "8", "--batch", "2",
                                      "--seq", "32", "--log-every", "1"]))
    launches = {}
    row, info = smoke.phase_moe(golden, "cpu", launches, spec=spec,
                                golden_cfg=gcfg)
    assert launches == {"flash_attention": 0}
    assert [c["dtype"] for c in row["cases"]] == ["bfloat16", "float32"]
    for name in ("deepseek", "dbrx"):
        assert info[name]["moe"]["dropped"] > 0
        assert info[name]["moe"]["rel_l2"] < 1e-5
    assert info["deepseek"]["decode"]["absorbed_vs_naive"] < ATOL
    assert (info["deepseek"]["serve"]["requests"]
            == spec["deepseek"]["serve"]["requests"])
    assert info["deepseek_bf16"]["rel"] < smoke.BF16_LOGIT_RTOL
    assert max(info["golden"].values()) < ATOL * 10
    assert info["golden_dropped"] > 0
    train = info["train"]
    assert set(train) == {"dbrx-132b", "deepseek-v2-236b", "cli"}
    for name in ("dbrx-132b", "deepseek-v2-236b"):
        assert train[name]["plain_worst_rel_l2"] < 1e-5
        assert train[name]["remat_worst_rel_l2"] < 1e-5
    assert train["deepseek-v2-236b"]["moe_layer"]["dropped"] > 0
    layer = train["deepseek-v2-236b"]["moe_layer"]
    assert max(layer["rel_l2"].values()) < 1e-5
    assert set(train["cli"]) == {"dbrx_132b", "deepseek_v2_236b"}
    # a dispatch that keeps the last C pairs of each expert, not the
    # first, fails the per-expert loop
    real = smoke.expert_loop
    monkeypatch.setattr(smoke, "expert_loop",
                        lambda *a, **kw: real(*a, keep_last=True, **kw))
    with pytest.raises(AssertionError, match="per-expert loop"):
        smoke.phase_moe(golden, "cpu", {}, spec=spec, golden_cfg=gcfg)

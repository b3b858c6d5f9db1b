"""The port's MoE-family training against the JAX package.

Reduced DBRX (GQA attention) and DeepSeek-V2 (MLA) on the same
numpy-seeded weights (``convert.numpy_params``) and batches, the port
on the CPU against ``jax.value_and_grad(repro.models.train_loss)`` on
the CPU:

* ``train_loss`` and every gradient leaf, at ``reduced``'s capacity
  factor 8 (nothing dropped), at 1.25 with s 64 (pairs dropped: their
  gradient is 0 in both packages) and with an all-zero router (every
  probability ties; ``lax.top_k``'s gradient goes to experts 0..k−1, the
  port's stable sort picks the same);
* remat ``full`` against ``none`` (the recompute routes every token as
  the forward did);
* ``FlashAttention``'s gradients at MLA's reduced head dims (q/k 48, v
  32) against ``jax.grad`` of JAX's ``blockwise_attention``;
* three whole ``make_train_step`` steps against JAX's;
* a dropped (token, expert) pair's token gets no gradient through the
  routed experts.

``launch.train --arch dbrx_132b|deepseek_v2_236b --reduced`` runs on the
CPU, with the loss falling, in ``chip_smoke.py``'s phase 14 rehearsal
(``tests/test_torch_moe.py``).

Tolerances, as ``tests/test_torch_train.py``'s: the loss within 1e-6
relative, every gradient leaf within ``GRAD_RTOL`` = 1e-5 relative L2
(float32 summation order is all that differs; measured ≤ 2e-6).  A
router near-tie could send a token to another expert under another
summation order; the test prints the least top-k margin when a leaf
misses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import get_config as jget
from repro.models import layers as jlayers
from repro.models.config import reduced as jreduced
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import moe, reduced, train_loss
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                               make_train_step)
from repro_torch.train.tree import tree_items, tree_leaves, tree_map

torch.set_num_threads(1)

GRAD_RTOL = 1e-5
MOE = ("dbrx_132b", "deepseek_v2_236b")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(arch, **kw):
    return jreduced(jget(arch), **kw), reduced(get_config(arch), **kw)


def _batch(cfg, b=2, s=32, seed=2, shared=False):
    """Token and label ids; with ``shared``, every sequence is one
    seeded sequence with a few tokens changed, so the router favours
    some experts and a capacity of 1.25 drops pairs."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s))
    if shared:
        tokens = np.broadcast_to(rng.integers(0, 8, s), (b, s)).copy()
        tokens[:, ::7] = rng.integers(0, cfg.vocab, tokens[:, ::7].shape)
    return dict(tokens=tokens.astype(np.int32),
                labels=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _router_margin(cfg, tree, batch) -> float:
    """The least gap between the k-th and (k+1)-th router probability of
    layer 0 over the batch's embedded tokens (its first layer's input
    is not its router's, but a near-tie shows there first)."""
    x = tree["embed"][batch["tokens"]]
    logits = x @ tree["blocks"]["ffn"]["router"][0]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[..., :cfg.top_k + 1]
    return float((top[..., -2] - top[..., -1]).min())


def _value_and_grad(cfg, tree, batch):
    leaves = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(tree, cfg, device="cpu"))
    loss = train_loss(leaves, _tb(batch), cfg)
    return loss, torch.autograd.grad(loss, tree_leaves(leaves)), leaves


def _hold(cfg, jcfg, tree, batch):
    """The port's loss and gradients against JAX's; returns the port's
    gradients."""
    jl, jg = jax.value_and_grad(JM.train_loss)(
        jax.tree.map(jnp.asarray, tree), _jb(batch), jcfg)
    loss, grads, leaves = _value_and_grad(cfg, tree, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for (path, _), got, want in zip(tree_items(leaves), grads, jleaves):
        assert got.shape == want.shape
        rel = _rel(_np(got), want)
        assert rel <= GRAD_RTOL, (".".join(path), rel, "router margin",
                                  _router_margin(cfg, tree, batch))
    return grads


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf,s", [(8.0, 32), (1.25, 64)])
def test_train_loss_and_grads_match_jax(arch, cf, s):
    jcfg, cfg = _cfgs(arch, n_layers=2, capacity_factor=cf)
    tree = numpy_params(cfg, seed=1)
    batch = _batch(cfg, s=s, shared=cf < 2)
    if cf < 2:  # the capacity is exercised: layer 0's dispatch drops
        x = torch.from_numpy(tree["embed"][batch["tokens"]])
        _, idx = moe.route(x, torch.from_numpy(
            tree["blocks"]["ffn"]["router"][0]), cfg)
        C = moe.capacity(cfg, s)
        counts = np.stack([np.bincount(i.reshape(-1), minlength=cfg.n_experts)
                           for i in idx.numpy()])
        assert np.maximum(counts - C, 0).sum() > 0
    _hold(cfg, jcfg, tree, batch)


@pytest.mark.parametrize("arch", MOE)
def test_grads_with_a_zero_router_match_jax(arch):
    """Every router probability ties: top-k picks experts 0..k−1 with
    gates 1/k, and the router's gradient flows through those picks."""
    jcfg, cfg = _cfgs(arch, n_layers=1)
    tree = numpy_params(cfg, seed=3)
    tree["blocks"]["ffn"]["router"][:] = 0
    grads = _hold(cfg, jcfg, tree, _batch(cfg))
    paths = [".".join(p) for p, _ in tree_items(
        params_from_numpy(tree, cfg, device="cpu"))]
    g = dict(zip(paths, grads))
    # only experts 0..k−1 receive tokens, so only they get gradient
    we1 = g["blocks.ffn.we1"][0]
    assert we1[:cfg.top_k].abs().sum() > 0
    assert not we1[cfg.top_k:].any()
    assert g["blocks.ffn.router"].abs().sum() > 0


@pytest.mark.parametrize("arch", MOE)
def test_remat_full_matches_none(arch):
    """Rematerialisation re-routes every token in the recompute as the
    forward did: remat ``full`` and ``none`` give the same gradients,
    each held to JAX's."""
    got = {}
    for policy in ("full", "none"):
        jcfg, cfg = _cfgs(arch, n_layers=2, capacity_factor=1.25,
                          remat_policy=policy)
        tree = numpy_params(cfg, seed=4)
        got[policy] = _hold(cfg, jcfg, tree, _batch(cfg, s=64, shared=True))
    for a, b in zip(got["full"], got["none"]):
        assert _rel(_np(a), _np(b)) <= GRAD_RTOL


@pytest.mark.parametrize("causal", [True, False])
def test_attention_grads_at_mla_head_dims_match_jax(causal):
    """``FlashAttention`` with v's head dim below q's (MLA's 192/128 at
    the reduced 48/32): dq, dk, dv against ``jax.grad`` of JAX's
    ``blockwise_attention``."""
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((2, 4, 72, 48)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 4, 72, 32)).astype(np.float32)
    w = rng.standard_normal((2, 4, 72, 32)).astype(np.float32)

    def jloss(q, k, v):
        out = jlayers.blockwise_attention(q, k, v, causal=causal,
                                          block_q=16, block_k=16)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert "FlashAttention" in type(out.grad_fn).__name__
    assert tuple(out.shape) == (2, 4, 72, 32)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref_ in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.shape == ref_.shape
        assert _rel(_np(got), ref_) <= GRAD_RTOL, name


def test_attention_backward_reads_v_head_dim():
    """``attention_backward`` at (D 48, Dv 32) equals autograd through
    the plain version on the padded inputs cut to Dv: the zero v columns
    the card's wrapper adds drop out of rowsum(dO ∘ O)."""
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn((1, 4, 40, 48), generator=g) for _ in range(2))
    v = torch.randn((1, 4, 40, 32), generator=g)
    w = torch.randn((1, 4, 40, 32), generator=g)
    out = fa.ref.flash_attention_ref(q, k, v, causal=True)
    got = fa.attention_backward(q, k, v, out, w, True, 48 ** -0.5, 0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    pq, pk, pv = fa.pad_head_dims(*leaves)
    assert pv.shape[-1] == 64
    padded = fa.ref.flash_attention_ref(pq, pk, pv, causal=True,
                                        scale=48 ** -0.5)[..., :32]
    (padded * w).sum().backward()
    for a, b in zip(got, (t.grad for t in leaves)):
        assert a.shape == b.shape
        assert _rel(_np(a), _np(b)) <= GRAD_RTOL


# ----------------------------------------------------------- steps, drops
@pytest.mark.parametrize("arch", MOE)
def test_three_train_steps_match_jax(arch):
    jcfg, cfg = _cfgs(arch, n_layers=2)
    tree = numpy_params(cfg, seed=1)
    params = params_from_numpy(tree, cfg, device="cpu")
    opt = adamw_init(params)
    ocfg = dict(lr=5e-3, total_steps=50)
    jstep = jax.jit(jmake_train_step(
        jcfg, JTrainConfig(opt=JAdamWConfig(**ocfg))))
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(**ocfg)))
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw_init(jparams)
    moved = 0.0
    for i in range(3):
        batch = _batch(cfg, seed=20 + i)
        jparams, jopt, jm = jstep(jparams, jopt, _jb(batch))
        params, opt, m = step(params, opt, _tb(batch))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
        moved += float(m["lr"])
    for got, want in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        got, want = _np(got), np.asarray(want)
        # as tests/test_torch_train.py: Adam normalises each component, so
        # a few weights whose gradient is near 0 may stray, by at most the
        # summed learning rates
        off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
        assert off.mean() <= 1e-3, off.sum()
        assert np.abs(got - want).max() <= moved


def test_drops_give_no_gradient():
    """A dropped (token, expert) pair adds nothing to the output, so its
    token's input gets no gradient through that expert: with C 8 and
    every token routed to experts 0 and 1 by a zero router, the tokens
    past the first 8 of a group get gradient only through the shared
    expert (DeepSeek-V2) and none through the routed experts."""
    cfg = dataclasses.replace(reduced(get_config("deepseek_v2_236b"),
                                      n_layers=1), capacity_factor=1.0,
                              n_shared_experts=0)
    tree = numpy_params(cfg, seed=6)
    p = {k: torch.from_numpy(v[0]).requires_grad_()
         for k, v in tree["blocks"]["ffn"].items()}
    p["router"] = torch.zeros_like(p["router"])
    s = 32
    C = moe.capacity(cfg, s)
    assert C == 8
    x = torch.randn((1, s, cfg.d_model), generator=torch.Generator(
        ).manual_seed(0), requires_grad=True)
    moe.moe_layer(x, p, cfg).sum().backward()
    assert x.grad[0, :C].abs().sum() > 0
    assert not x.grad[0, C:].any()

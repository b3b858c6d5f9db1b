"""Model assembly for the dense and MoE families: parameter specs, init,
the full-sequence forward, prefill and the decode step.

The port of the JAX package's ``models/model.py`` (its decoder-only
dense and MoE subset: GQA or MLA attention, a dense or MoE FFN).
Parameters keep the JAX package's tree: a nested dict whose per-layer
tensors are stacked on a leading [L, ...] axis, so one tree carries
across between the packages (``convert.params_from_numpy``).
``DenseLM`` and ``DecoderBlock`` are ``nn.Module`` views of that tree
for serving (no copies: a block's parameters are the slices of layer i,
registered without grad); ``prefill`` and ``serve_step`` take the tree
as the JAX functions do and run through them.  ``forward`` and
``train_loss`` are functional over the tree's own tensors, so gradients
reach leaves that require them, with each layer rematerialised as the
JAX package's ``_maybe_remat`` does (``torch.utils.checkpoint``).  Every
product is full f32 (``ref.matmul_f32``, backward included), whatever
the process's TF32 setting.

Families other than dense and moe raise ``NotImplementedError`` naming
the ROADMAP item they wait for, and ``train_loss`` refuses moe (item
15b.2b: training through the dispatch).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint

from .config import ModelConfig
from .layers import mrope_positions, rms_norm
from .transformer import _NOT_PORTED, decoder_block, decoder_block_decode
from ..kernels.ref import matmul_f32

__all__ = [
    "PSpec",
    "param_specs",
    "init_params",
    "flat_items",
    "DecoderBlock",
    "DenseLM",
    "forward",
    "train_loss",
    "prefill",
    "serve_step",
    "cache_specs",
    "init_cache",
    "SHAPE_SETS",
    "shape_applicable",
]


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | ones


PORTED_FAMILIES = ("dense", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported (the port "
            f"runs {', '.join(PORTED_FAMILIES)}); {_NOT_PORTED}")


# =====================================================================
# Parameter specs (the JAX package's shapes and key order, without
# sharding axes)
# =====================================================================
def _attn_specs(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    if cfg.is_mla:
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return dict(wq=PSpec((L, d, cfg.n_heads * (dn + dr))),
                    kv_down=PSpec((L, d, cfg.kv_lora + dr)),
                    k_up=PSpec((L, cfg.kv_lora, cfg.n_heads * dn)),
                    v_up=PSpec((L, cfg.kv_lora, cfg.n_heads * dv)),
                    wo=PSpec((L, cfg.n_heads * dv, d)))
    hd = cfg.resolved_head_dim
    return dict(wq=PSpec((L, d, cfg.n_heads * hd)),
                wk=PSpec((L, d, cfg.n_kv_heads * hd)),
                wv=PSpec((L, d, cfg.n_kv_heads * hd)),
                wo=PSpec((L, cfg.n_heads * hd, d)))


def _ffn_specs(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    if cfg.is_moe:
        E, fe = cfg.n_experts, cfg.d_ff_expert
        out: Dict[str, Any] = dict(router=PSpec((L, d, E)),
                                   we1=PSpec((L, E, d, fe)),
                                   we3=PSpec((L, E, d, fe)),
                                   we2=PSpec((L, E, fe, d)))
        if cfg.n_shared_experts:
            fs = fe * cfg.n_shared_experts
            out["shared"] = dict(w1=PSpec((L, d, fs)), w3=PSpec((L, d, fs)),
                                 w2=PSpec((L, fs, d)))
        return out
    ff = cfg.d_ff
    out = dict(w1=PSpec((L, d, ff)), w2=PSpec((L, ff, d)))
    if cfg.mlp_type in ("swiglu", "geglu"):
        out["w3"] = PSpec((L, d, ff))
    return out


def param_specs(cfg: ModelConfig) -> Dict:
    _require_ported(cfg)
    L, d = cfg.n_layers, cfg.d_model
    specs: Dict[str, Any] = dict(embed=PSpec((cfg.vocab, d)),
                                 final_norm=PSpec((d,), "ones"))
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((d, cfg.vocab))
    specs["blocks"] = dict(norm1=PSpec((L, d), "ones"),
                           attn=_attn_specs(cfg, L),
                           norm2=PSpec((L, d), "ones"),
                           ffn=_ffn_specs(cfg, L))
    return specs


def flat_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_items(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _put(tree: dict, path: str, val) -> None:
    node = tree
    parts = path.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = val


def fan_in(shape) -> int:
    """The JAX package's init scale: N(0, 1) · fan_in^-1/2 with fan_in the
    second-to-last dim (the last for a vector)."""
    return shape[-2] if len(shape) >= 2 else shape[-1]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype=torch.float32) -> Dict:
    """Random weights in the JAX package's layout and distribution, drawn
    from ``generator`` (a ``torch.Generator`` on ``device``; seed 0 if
    None) — not the JAX package's numbers, which come from
    ``jax.random``; ``convert.numpy_params`` gives weights both packages
    can load."""
    from ..core.peel import resolve_device

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out: Dict[str, Any] = {}
    for path, spec in flat_items(param_specs(cfg)):
        if spec.init == "ones":
            v = torch.ones(spec.shape, dtype=dtype, device=dev)
        else:
            v = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=dev)
            v = v.mul_(fan_in(spec.shape) ** -0.5).to(dtype)
        _put(out, path, v)
    return out


def layer_trees(blocks: dict) -> list:
    """The stacked [L, ...] block tree as L per-layer dicts of views
    (``unbind``: a backward through them stacks the layers' gradients
    once)."""
    flat = {path: torch.unbind(t, 0) for path, t in flat_items(blocks)}
    out = []
    for i in range(len(next(iter(flat.values())))):
        layer: dict = {}
        for path, ts in flat.items():
            _put(layer, path, ts[i])
        out.append(layer)
    return out


# =====================================================================
# Modules
# =====================================================================
class _TreeModule(nn.Module):
    """Registers the leaves of a nested dict of tensors as parameters
    and rebuilds the dict.  The modules serve: their parameters are
    registered without grad (views of the tree's storage, not copies),
    so a prefill never records a backward.  Training does not go
    through them: ``train_loss`` runs on the tree's own leaves, which
    the trainer marks ``requires_grad_()``."""

    def _register_tree(self, tree: dict) -> None:
        self._paths = []
        for path, t in flat_items(tree):
            self.register_parameter(path.replace(".", "__"),
                                    nn.Parameter(t, requires_grad=False))
            self._paths.append(path)

    def tree(self) -> dict:
        out: dict = {}
        for path in self._paths:
            _put(out, path, getattr(self, path.replace(".", "__")))
        return out


class DecoderBlock(_TreeModule):
    """One pre-norm decoder layer over its parameter dict."""

    def __init__(self, cfg: ModelConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        self._register_tree(p)

    def forward(self, x, positions, causal: bool = True):
        return decoder_block(x, self.tree(), self.cfg, positions, causal)

    def decode(self, x, cache, length: int):
        return decoder_block_decode(x, self.tree(), self.cfg, cache, length)


class DenseLM(_TreeModule):
    """A decoder-only LM of the dense or MoE family (GQA or MLA attention)
    over a parameter tree in the JAX package's layout (``init_params``,
    ``convert.params_from_numpy``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self._register_tree({k: v for k, v in params.items() if k != "blocks"})
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, p) for p in layer_trees(params["blocks"]))

    def embed_tokens(self, tokens):
        return _embed(self.tree(), tokens, self.cfg)

    def unembed(self, x):
        return _unembed(self.tree(), x, self.cfg)

    def forward(self, tokens, positions=None, return_hidden: bool = False):
        """Full-sequence forward -> logits [b, s, vocab] (or hidden)."""
        return _forward(self.tree(), [blk.tree() for blk in self.blocks],
                        tokens, self.cfg, positions, return_hidden)

    def prefill(self, tokens, positions=None):
        """Last-position logits [b, vocab] of the full forward (only the
        last position is unembedded: the same rows of the same product)."""
        return self.unembed(self(tokens, positions, return_hidden=True)[:, -1])

    def serve_step(self, cache: Dict, token, length: int):
        """One decode step: token [b] -> (logits [b, vocab], cache), the
        cache (k/v [L, b, kv, S, hd], or MLA's ckv [L, b, S, lora + dr])
        written at ``length`` in place."""
        x = self.embed_tokens(token[:, None])[:, 0]
        for i, blk in enumerate(self.blocks):
            layer = (cache["ckv"][i] if self.cfg.is_mla
                     else (cache["k"][i], cache["v"][i]))
            x, _ = blk.decode(x, layer, length)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.unembed(x), cache


# =====================================================================
# The JAX package's functional API
# =====================================================================
def _positions(cfg: ModelConfig, b: int, s: int, device) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    return mrope_positions(pos) if cfg.rope_type == "mrope" else pos


def _embed(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.scale_embedding:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(params, x, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return matmul_f32(x, w)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat_policy="dots"``: keep
    the outputs of un-batched matrix products (the projections' ``mm``;
    attention's batched products are recomputed), as JAX's
    ``dots_with_no_batch_dims_saveable``."""
    return (checkpoint.CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.mm.default
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` rematerialised in the backward as ``cfg`` asks (the JAX
    package's ``_maybe_remat``): ``"full"`` keeps only its inputs,
    ``"dots"`` its matrix products' outputs too, ``"none"`` (or
    ``remat=False``) everything.  Nothing to keep without grad."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: expected "
                         "full, dots or none")
    context_fn = (functools.partial(
        checkpoint.create_selective_checkpoint_contexts, _dots_policy)
        if cfg.remat_policy == "dots" else checkpoint.noop_context_fn)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                     context_fn=context_fn)
    return remat


def _forward(params, layers, tokens, cfg: ModelConfig, positions,
             return_hidden: bool) -> torch.Tensor:
    """The full-sequence forward of ``forward`` and ``DenseLM``: the
    embedding, final norm and head from ``params``, the decoder layers
    from the per-layer trees ``layers``, each rematerialised as ``cfg``
    asks."""
    if positions is None:
        positions = _positions(cfg, *tokens.shape, tokens.device)
    body = _maybe_remat(
        lambda h, p: decoder_block(h, p, cfg, positions), cfg)
    x = _embed(params, tokens, cfg)
    for p in layers:
        x = body(x, p)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x if return_hidden else _unembed(params, x, cfg)


def forward(params, tokens, cfg: ModelConfig, positions=None,
            return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits [b, s, vocab] (or hidden), on the
    tree's own tensors: differentiable in every leaf that requires grad,
    each layer rematerialised as ``cfg`` asks."""
    _require_ported(cfg)
    return _forward(params, layer_trees(params["blocks"]), tokens, cfg,
                    positions, return_hidden)


def _nll(params, x, labels, cfg: ModelConfig) -> torch.Tensor:
    logits = _unembed(params, x, cfg).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def train_loss(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    [b, s] integer tensors, optional ``positions``); logits in f32.  With
    ``cfg.loss_chunk``, unembedding and the loss go one chunk of that
    many positions at a time, summed, as the JAX package's scan.  The
    moe family is refused: its backward through the dispatch is not yet
    held to JAX's."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: training the moe family is not ported; ROADMAP "
            "queue 1 item 15b.2b (train_loss through the MoE dispatch, "
            "held to jax.grad)")
    labels = batch["labels"]
    x = forward(params, batch["tokens"], cfg,
                positions=batch.get("positions"), return_hidden=True)
    if cfg.loss_chunk:
        b, s, _ = x.shape
        c = min(cfg.loss_chunk, s)
        if s % c:
            raise ValueError(f"loss_chunk {cfg.loss_chunk}: sequence length "
                             f"{s} is not a multiple of {c}")
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, c):
            tot = tot + torch.sum(_nll(params, x[:, i:i + c],
                                       labels[:, i:i + c], cfg))
        return tot / (b * s)
    return torch.mean(_nll(params, x, labels, cfg))


def prefill(params, tokens, cfg: ModelConfig, positions=None):
    """Prefill = full forward; returns last-position logits."""
    return DenseLM(cfg, params).prefill(tokens, positions)


def serve_step(params, cache: Dict, token, length: int, cfg: ModelConfig):
    """One decode step: token [b] int -> (logits [b, vocab], cache)."""
    return DenseLM(cfg, params).serve_step(cache, token, length)


def cache_specs(cfg: ModelConfig, batch: int, seq: int,
                dtype=torch.bfloat16) -> Dict:
    """{name: (shape, dtype)} of the decode cache: MLA's compressed rows
    (``ckv``), or per-head keys and values."""
    _require_ported(cfg)
    if cfg.is_mla:
        return dict(ckv=((cfg.n_layers, batch, seq,
                          cfg.kv_lora + cfg.qk_rope_dim), dtype))
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.resolved_head_dim)
    return dict(k=(shape, dtype), v=(shape, dtype))


def init_cache(cfg: ModelConfig, batch: int, seq: int, device,
               dtype=torch.float32) -> Dict:
    """A zeroed decode cache of ``cache_specs`` on ``device``."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_specs(cfg, batch, seq, dtype).items()}


# =====================================================================
# Assigned shapes
# =====================================================================
SHAPE_SETS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.is_recurrent:
        return False, (
            "pure full-attention arch: 524k dense-KV decode is "
            "architecturally quadratic — skipped per DESIGN.md §4"
        )
    return True, ""

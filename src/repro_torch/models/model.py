"""Model assembly for every family: parameter specs, init, the
full-sequence forward, the training loss, prefill and the decode step.

The port of the JAX package's ``models/model.py``: GQA or MLA attention
with a dense or MoE FFN (dense, moe; vlm: Qwen2-VL's decoder under
M-RoPE, its patch frontend a stub); xLSTM's groups of mLSTM layers and
one sLSTM (ssm); Zamba2's Mamba2 layers with one shared attention block
applied every ``attn_every`` layers (hybrid); Whisper's encoder and
decoder (audio: ``_whisper_encode`` over precomputed frame embeddings,
its conv frontend a stub, and a decoder whose layers add
cross-attention to the encoder's output).  Parameters keep the JAX
package's tree: a nested dict whose per-layer tensors are stacked on a
leading [L, ...] axis (xLSTM: [G, M, ...] and [G, ...]; Whisper: one
stack for each side), so one tree carries across between the packages
(``convert.params_from_numpy``).  ``DenseLM`` and its layer modules are
``nn.Module`` views of that tree for serving (no copies: a layer's
parameters are its slices, registered without grad); ``prefill`` and
``serve_step`` take the tree as the JAX functions do and run through
them.  ``forward`` and ``train_loss`` are functional over the tree's own
tensors, so gradients reach leaves that require them, with each layer
rematerialised as the JAX package's ``_maybe_remat`` does
(``torch.utils.checkpoint``).  Every product is full f32
(``ref.matmul_f32``, backward included), whatever the process's TF32
setting.

Whisper here is the reference's, not the published model: RMSNorm and
sinusoidal positions on both sides, and a decode step that recomputes
every layer's cross-attention keys and values from the encoder output
(``_decode_whisper``), as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint

from ..device import resolve_device
from .config import ModelConfig
from . import ssm as S
from .layers import (DP_AXES, _is_dtensor, batch_placements, blockwise_attention,
                     constrain, copy_state, mlp, mrope_positions, replicated,
                     rms_norm)
from .transformer import (_heads, _out, attention, attention_decode,
                          decoder_block, decoder_block_decode)
from ..kernels.ref import matmul_f32

__all__ = [
    "PSpec",
    "param_specs",
    "abstract_params",
    "logical_axes",
    "init_params",
    "flat_items",
    "LayerTree",
    "DenseLM",
    "forward",
    "train_loss",
    "prefill",
    "serve_step",
    "cache_specs",
    "init_cache",
    "input_specs",
    "SHAPE_SETS",
    "shape_applicable",
]


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axes, one a dim
    init: str = "normal"  # normal | ones | zeros | a_log


FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"(expected one of {', '.join(FAMILIES)})")


# =====================================================================
# Parameter specs: the JAX package's shapes, logical axes (resolved to
# mesh axes by ``sharding.partition``) and key order
# =====================================================================
_LED = ("layers", "embed", "heads")


def _attn_specs(cfg: ModelConfig, L: int, cross: bool = False) -> Dict:
    d = cfg.d_model
    if cfg.is_mla and not cross:
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return dict(
            wq=PSpec((L, d, cfg.n_heads * (dn + dr)), _LED),
            kv_down=PSpec((L, d, cfg.kv_lora + dr), ("layers", "embed", None)),
            k_up=PSpec((L, cfg.kv_lora, cfg.n_heads * dn),
                       ("layers", None, "heads")),
            v_up=PSpec((L, cfg.kv_lora, cfg.n_heads * dv),
                       ("layers", None, "heads")),
            wo=PSpec((L, cfg.n_heads * dv, d), ("layers", "heads", "embed")))
    hd = cfg.resolved_head_dim
    kv = ("layers", "embed", "kv")
    return dict(wq=PSpec((L, d, cfg.n_heads * hd), _LED),
                wk=PSpec((L, d, cfg.n_kv_heads * hd), kv),
                wv=PSpec((L, d, cfg.n_kv_heads * hd), kv),
                wo=PSpec((L, cfg.n_heads * hd, d), ("layers", "heads", "embed")))


def _ffn_specs(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    up, down = ("layers", "embed", "mlp"), ("layers", "mlp", "embed")
    if cfg.is_moe:
        E, fe = cfg.n_experts, cfg.d_ff_expert
        ex_up = ("layers", "expert", "embed", None)
        out: Dict[str, Any] = dict(
            router=PSpec((L, d, E), ("layers", "embed", None)),
            we1=PSpec((L, E, d, fe), ex_up),
            we3=PSpec((L, E, d, fe), ex_up),
            we2=PSpec((L, E, fe, d), ("layers", "expert", None, "embed")))
        if cfg.n_shared_experts:
            fs = fe * cfg.n_shared_experts
            out["shared"] = dict(w1=PSpec((L, d, fs), up),
                                 w3=PSpec((L, d, fs), up),
                                 w2=PSpec((L, fs, d), down))
        return out
    ff = cfg.d_ff
    out = dict(w1=PSpec((L, d, ff), up), w2=PSpec((L, ff, d), down))
    if cfg.mlp_type in ("swiglu", "geglu"):
        out["w3"] = PSpec((L, d, ff), up)
    return out


def _norm(*lead: int) -> PSpec:
    """A norm's scale: ones, its stacked axes ``layers``."""
    return PSpec(lead, ("layers",) * (len(lead) - 1) + (None,), "ones")


def _decoder_block_specs(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    return dict(norm1=_norm(L, d), attn=_attn_specs(cfg, L),
                norm2=_norm(L, d), ffn=_ffn_specs(cfg, L))


def _mamba_specs(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nh = d_inner // 64                      # mamba2 head dim 64
    d_in = 2 * d_inner + 2 * cfg.ssm_state + nh
    per_head = ("layers", None)
    return dict(norm=_norm(L, d),
                in_proj=PSpec((L, d, d_in), _LED),
                conv_w=PSpec((L, cfg.ssm_conv, d_inner),
                             ("layers", None, "heads")),
                A_log=PSpec((L, nh), per_head, "a_log"),
                dt_bias=PSpec((L, nh), per_head, "zeros"),
                D=PSpec((L, nh), per_head, "ones"),
                out_proj=PSpec((L, d_inner, d), ("layers", "heads", "embed")))


def _xlstm_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    G = cfg.n_layers // cfg.slstm_every
    M = cfg.slstm_every - 1
    di = cfg.lstm_proj_factor * d
    nh = cfg.n_heads
    dh2 = d // nh
    LL = ("layers", "layers")
    return dict(
        mlstm=dict(norm=_norm(G, M, d),
                   up_proj=PSpec((G, M, d, 2 * di), LL + ("embed", "heads")),
                   wq=PSpec((G, M, di, di), LL + (None, "heads")),
                   wk=PSpec((G, M, di, di), LL + (None, "heads")),
                   wv=PSpec((G, M, di, di), LL + (None, "heads")),
                   wg=PSpec((G, M, di, 2 * nh), LL + ("heads", None)),
                   down_proj=PSpec((G, M, di, d), LL + ("heads", "embed"))),
        slstm=dict(norm=_norm(G, d),
                   W=PSpec((G, d, 4 * nh * dh2), _LED),
                   R=PSpec((G, nh, dh2, 4 * dh2), ("layers", "kv", None, None)),
                   out=PSpec((G, nh * dh2, d), ("layers", "heads", "embed"))))


def param_specs(cfg: ModelConfig) -> Dict:
    _check_family(cfg)
    L, d = cfg.n_layers, cfg.d_model
    specs: Dict[str, Any] = dict(embed=PSpec((cfg.vocab, d),
                                             ("vocab", "embed")),
                                 final_norm=_norm(d))
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((d, cfg.vocab), ("embed", "vocab"))
    if cfg.family in ("dense", "moe", "vlm"):
        specs["blocks"] = _decoder_block_specs(cfg, L)
    elif cfg.family == "ssm":
        specs.update(_xlstm_specs(cfg))
    elif cfg.family == "audio":  # whisper enc-dec
        specs["enc_blocks"] = _decoder_block_specs(cfg, cfg.encoder_layers)
        dec = _decoder_block_specs(cfg, L)
        dec["norm_x"] = _norm(L, d)
        dec["cross"] = _attn_specs(cfg, L, cross=True)
        specs["dec_blocks"] = dec
        specs["enc_norm"] = _norm(d)
    else:  # hybrid: the shared block is dense GQA whatever cfg says
        specs["blocks"] = _mamba_specs(cfg, L)
        shared = dataclasses.replace(cfg, kv_lora=0, n_experts=0)

        def one(tree):
            return {k: PSpec(v.shape[1:], v.axes[1:], v.init)
                    for k, v in tree.items()}
        specs["shared_attn"] = dict(norm1=_norm(d),
                                    attn=one(_attn_specs(shared, 1)),
                                    norm2=_norm(d),
                                    ffn=one(_ffn_specs(shared, 1)))
    return specs


def flat_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_items(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    """The parameter tree as ``device="meta"`` tensors of ``dtype``:
    shapes without storage (the JAX package's ``ShapeDtypeStruct``s)."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=dtype,
                                            device="meta"), param_specs(cfg))


def logical_axes(cfg: ModelConfig) -> Dict:
    """The parameter tree of logical axis tuples, one name (or None) a
    dim, that ``sharding.param_shardings`` resolves to a mesh."""
    return _map_specs(lambda s: s.axes, param_specs(cfg))


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
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out: Dict[str, Any] = {}
    for path, spec in flat_items(param_specs(cfg)):
        if spec.init == "ones":
            v = torch.ones(spec.shape, dtype=dtype, device=dev)
        elif spec.init in ("zeros", "a_log"):  # a_log 0: A = -1
            v = torch.zeros(spec.shape, dtype=dtype, device=dev)
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


# the top-level keys whose leaves are stacked per layer (xLSTM: per group)
_LAYER_KEYS = ("blocks", "mlstm", "slstm", "enc_blocks", "dec_blocks")


def _stacked(params, cfg: ModelConfig) -> dict:
    """The part of the tree stacked on a leading layer axis that the
    backbone runs (xLSTM: its group axis, over the mLSTM and sLSTM
    subtrees; Whisper: its decoder, whose encoder ``enc_blocks`` runs
    apart)."""
    if cfg.family == "ssm":
        return {k: params[k] for k in ("mlstm", "slstm")}
    if cfg.family == "audio":
        return params["dec_blocks"]
    return params["blocks"]


def _per_layer(trees: list, cfg: ModelConfig) -> list:
    """``layer_trees`` of ``_stacked`` as the backbone runs them: one dict
    a layer, or for xLSTM one a group with its M mLSTM layers' dicts
    under ``mlstm`` and its sLSTM layer's under ``slstm``."""
    if cfg.family == "ssm":
        return [dict(mlstm=layer_trees(g["mlstm"]), slstm=g["slstm"])
                for g in trees]
    return trees


def _layers(params, cfg: ModelConfig) -> list:
    return _per_layer(layer_trees(_stacked(params, cfg)), cfg)


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


class LayerTree(_TreeModule):
    """One layer's parameters: a decoder layer's (dense, moe, vlm; a
    Whisper encoder layer), a Whisper decoder layer's (its
    cross-attention and ``norm_x`` too), a Mamba2 layer's (hybrid), or
    one xLSTM group's (ssm: its mLSTM layers stacked [M, ...], its sLSTM
    layer); the family's functions in this module run them."""

    def __init__(self, p: dict):
        super().__init__()
        self._register_tree(p)


class DenseLM(_TreeModule):
    """An LM of any family over a parameter tree in the JAX package's
    layout (``init_params``, ``convert.params_from_numpy``), one
    ``LayerTree`` a layer (xLSTM: a group) in ``blocks``; Whisper's
    encoder layers in ``enc_blocks`` beside its decoder's; Zamba2's
    shared attention block sits in the model's own tree."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self._register_tree({k: v for k, v in params.items()
                             if k not in _LAYER_KEYS})
        self.blocks = nn.ModuleList(
            LayerTree(p) for p in layer_trees(_stacked(params, cfg)))
        if cfg.family == "audio":
            self.enc_blocks = nn.ModuleList(
                LayerTree(p) for p in layer_trees(params["enc_blocks"]))

    def layers(self) -> list:
        """The per-layer trees (``_layers``'s structure) of the blocks."""
        return _per_layer([blk.tree() for blk in self.blocks], self.cfg)

    def embed_tokens(self, tokens):
        return _embed(self.tree(), tokens, self.cfg)

    def unembed(self, x):
        return _unembed(self.tree(), x, self.cfg)

    def encode(self, frames):
        """Whisper's encoder output [b, encoder_seq, d] of frame
        embeddings ``frames`` [b, encoder_seq, d] (the audio frontend is
        a stub, as in the JAX package): what a decode cache's
        ``enc_out`` holds."""
        if self.cfg.family != "audio":
            raise ValueError(f"{self.cfg.name}: only the audio family has "
                             "an encoder")
        return _whisper_encode(self.tree(), frames, self.cfg,
                               [blk.tree() for blk in self.enc_blocks])

    def forward(self, tokens, positions=None, frames=None,
                return_hidden: bool = False):
        """Full-sequence forward -> logits [b, s, vocab] (or hidden);
        Whisper's text attends to the encoder's output of ``frames``."""
        enc_out = self.encode(frames) if self.cfg.family == "audio" else None
        return _forward(self.tree(), self.layers(), tokens, self.cfg,
                        positions, return_hidden, enc_out)

    def prefill(self, tokens, positions=None, frames=None):
        """Last-position logits [b, vocab] of the full forward (only the
        last position is unembedded: the same rows of the same product)."""
        return self.unembed(self(tokens, positions, frames,
                                 return_hidden=True)[:, -1])

    def serve_step(self, cache: Dict, token, length: int):
        """One decode step: token [b] -> (logits [b, vocab], cache), the
        cache (``cache_specs``) written in place: keys and values (or
        MLA's ckv rows) at ``length``, recurrent states overwritten;
        Whisper's ``enc_out`` is read, not written."""
        x = self.embed_tokens(token[:, None])[:, 0]
        x = _DECODE[self.cfg.family](self.tree(), self.layers(), cache, x,
                                     length, self.cfg)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.unembed(x), cache


# =====================================================================
# The JAX package's functional API
# =====================================================================
def _positions(cfg: ModelConfig, b: int, s: int, device) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    return mrope_positions(pos) if cfg.rope_type == "mrope" else pos


def _gather_rows(w, tokens):
    """``w[tokens]``; on a ``DTensor`` table each rank gathers its own
    batch rows from the whole table (``local_map``: the same indexing as
    one device, its gradient summed over the data axes)."""
    if not _is_dtensor(w):
        return w[tokens]
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, replicated(mesh),
                                    run_check=False)
    rows = batch_placements(mesh, tokens.shape[0])
    return local_map(
        lambda wl, tl: wl[tl], out_placements=rows,
        in_placements=(replicated(mesh), rows),
        in_grad_placements=(batch_placements(mesh, tokens.shape[0],
                                             grad=True), rows),
        device_mesh=mesh, redistribute_inputs=True)(w, tokens)


def _embed(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    x = _gather_rows(params["embed"], tokens)
    if cfg.scale_embedding:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return constrain(x, (DP_AXES,) + (None,) * (x.ndim - 1))


def _unembed(params, x, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = matmul_f32(x, w)
    return constrain(out, (DP_AXES,) + (None,) * (out.ndim - 2) + ("model",))


@functools.lru_cache(maxsize=16)
def _sinusoid(s: int, d: int, dtype, device=None) -> torch.Tensor:
    """The sinusoidal position table [s, d] (sines, then cosines): made
    in float64 by numpy and cast once to ``dtype``, as the JAX
    package's (the same numbers); kept per (s, d, dtype, device), so
    callers must not write into it."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10_000 ** (2 * i / d))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def _sinusoid_at(pos, d: int, dtype, device=None) -> torch.Tensor:
    """The sinusoidal embedding [d] of one position, in float32 from the
    position (as the JAX package's: not the table's float64 numbers)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = torch.as_tensor(pos, device=device).to(torch.float32) / torch.pow(
        10_000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)


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


_ACT = (DP_AXES, None, None)  # a backbone layer's output: batch over data
_TOK = (DP_AXES, None)        # a decode step's token activations


def _mlstm_layer(h, p, cfg: ModelConfig):
    return constrain(
        h + S.mlstm_mix(rms_norm(h, p["norm"], cfg.norm_eps), p, cfg), _ACT)


def _mamba_layer(h, p, cfg: ModelConfig):
    return h + S.mamba2_mix(rms_norm(h, p["norm"], cfg.norm_eps), p, cfg)


def _shared_block(h, shared, cfg: ModelConfig, positions):
    """Zamba2's shared attention block (pre-norm attention, then MLP);
    on ``DTensor``s its input and branches constrained as
    ``decoder_block``'s."""
    h = constrain(h, _ACT)
    a = rms_norm(h, shared["norm1"], cfg.norm_eps)
    h = h + constrain(attention(a, shared["attn"], cfg, positions,
                                causal=True), _ACT)
    f = rms_norm(h, shared["norm2"], cfg.norm_eps)
    return h + constrain(mlp(f, shared["ffn"], cfg.mlp_type), _ACT)


def _whisper_encode(params, frames, cfg: ModelConfig, layers=None):
    """Whisper's encoder: frames [b, se, d] plus the sinusoid table, then
    non-causal decoder blocks over ``enc_blocks`` (``layers``: their
    per-layer trees, split from the tree unless given), then RMSNorm
    with ``enc_norm``.  The positions go unused (``rope_type`` none)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family needs frames")
    b, se, d = frames.shape
    x = frames + _sinusoid(se, d, frames.dtype, frames.device)[None]
    pos = torch.arange(se, dtype=torch.int32,
                       device=frames.device)[None].expand(b, se)
    body = _maybe_remat(
        lambda h, p: decoder_block(h, p, cfg, pos, causal=False), cfg)
    for p in layer_trees(params["enc_blocks"]) if layers is None else layers:
        x = body(x, p)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attention(x, p, cfg: ModelConfig, memory):
    """q from the text x [b, s, d], k and v from ``memory`` [b, se, d]
    (cast to x's dtype), non-causal through the ``flash_attention``
    kernel; s is 1 in a decode step."""
    hd = cfg.resolved_head_dim
    memory = memory.to(x.dtype)
    q = _heads(x, p["wq"], cfg.n_heads, hd)
    k = _heads(memory, p["wk"], cfg.n_kv_heads, hd)
    v = _heads(memory, p["wv"], cfg.n_kv_heads, hd)
    return _out(blockwise_attention(q, k, v, causal=False), p)


def _whisper_layer(h, p, cfg: ModelConfig, positions, enc_out):
    """One decoder layer: causal self-attention, then ``norm_x`` and
    cross-attention to ``enc_out``, then ``norm2`` and the MLP (on
    ``DTensor``s each branch constrained, as ``decoder_block``'s)."""
    a = rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + constrain(attention(a, p["attn"], cfg, positions, causal=True),
                      _ACT)
    cx = rms_norm(h, p["norm_x"], cfg.norm_eps)
    h = h + constrain(_cross_attention(cx, p["cross"], cfg, enc_out), _ACT)
    f = rms_norm(h, p["norm2"], cfg.norm_eps)
    return constrain(h + constrain(mlp(f, p["ffn"], cfg.mlp_type), _ACT),
                     _ACT)


def _whisper_decode_train(params, x, cfg: ModelConfig, positions, enc_out,
                          layers=None):
    """Whisper's decoder stack over x [b, s, d] (``layers``: the
    per-layer trees of ``dec_blocks``, split unless given), each layer
    rematerialised."""
    body = _maybe_remat(
        lambda h, p, m: _whisper_layer(h, p, cfg, positions, m), cfg)
    for p in layer_trees(params["dec_blocks"]) if layers is None else layers:
        x = body(x, p, enc_out)
    return x


def _backbone(params, layers, x, cfg: ModelConfig, positions, enc_out=None):
    """The layers of ``cfg``'s family over x [b, s, d], each
    rematerialised as the JAX package's backbone does: a decoder layer;
    an mLSTM layer (an xLSTM group's sLSTM layer is not); a Mamba2 layer
    with, after every ``attn_every``-th, the shared block (JAX's
    ``lax.cond`` on a static flag); Whisper's text, the sinusoid table
    added, through its decoder layers against ``enc_out``."""
    if cfg.family in ("dense", "moe", "vlm"):
        body = _maybe_remat(
            lambda h, p: decoder_block(h, p, cfg, positions), cfg)
        for p in layers:
            x = body(x, p)
    elif cfg.family == "ssm":
        body = _maybe_remat(lambda h, p: _mlstm_layer(h, p, cfg), cfg)
        for gp in layers:
            for p in gp["mlstm"]:
                x = body(x, p)
            sp = gp["slstm"]
            x = constrain(x + S.slstm_mix(rms_norm(x, sp["norm"],
                                                   cfg.norm_eps), sp, cfg),
                          _ACT)
    elif cfg.family == "audio":
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        x = _whisper_decode_train(params, x, cfg, positions, enc_out, layers)
    else:
        plain = _maybe_remat(
            lambda h, p: constrain(_mamba_layer(h, p, cfg), _ACT), cfg)
        with_attn = _maybe_remat(lambda h, p, shared: constrain(_shared_block(
            _mamba_layer(h, p, cfg), shared, cfg, positions), _ACT), cfg)
        for i, p in enumerate(layers):
            x = (with_attn(x, p, params["shared_attn"])
                 if (i + 1) % cfg.attn_every == 0 else plain(x, p))
    return x


def _forward(params, layers, tokens, cfg: ModelConfig, positions,
             return_hidden: bool, enc_out=None) -> torch.Tensor:
    """The full-sequence forward of ``forward`` and ``DenseLM``: the
    embedding, final norm, head (and Zamba2's shared block) from
    ``params``, the layers from the per-layer trees ``layers``
    (Whisper's decoder, against the encoder output ``enc_out``)."""
    if positions is None:
        positions = _positions(cfg, *tokens.shape, tokens.device)
    x = _backbone(params, layers, _embed(params, tokens, cfg), cfg,
                  positions, enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x if return_hidden else _unembed(params, x, cfg)


def forward(params, tokens, cfg: ModelConfig, positions=None, frames=None,
            return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits [b, s, vocab] (or hidden), on the
    tree's own tensors: differentiable in every leaf that requires grad,
    each layer rematerialised as ``cfg`` asks.  ``positions`` [b, s]
    (M-RoPE: [b, 3, s]) default to 0..s-1 on every stream; Whisper
    encodes ``frames`` [b, encoder_seq, d] first."""
    _check_family(cfg)
    enc_out = (_whisper_encode(params, frames, cfg)
               if cfg.family == "audio" else None)
    return _forward(params, _layers(params, cfg), tokens, cfg, positions,
                    return_hidden, enc_out)


def _nll(params, x, labels, cfg: ModelConfig) -> torch.Tensor:
    logits = _unembed(params, x, cfg).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def train_loss(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    [b, s] integer tensors, optional ``positions``, Whisper's
    ``frames``); logits in f32.  With
    ``cfg.loss_chunk``, unembedding and the loss go one chunk of that
    many positions at a time, summed, as the JAX package's scan.  The
    MoE family differentiates through its dispatch (gathers, the
    ``index_add_`` into the expert buffer, the sorted gates): a dropped
    (token, expert) pair gets no gradient, as in JAX."""
    labels = batch["labels"]
    x = forward(params, batch["tokens"], cfg,
                positions=batch.get("positions"), frames=batch.get("frames"),
                return_hidden=True)
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


def prefill(params, tokens, cfg: ModelConfig, positions=None, frames=None):
    """Prefill = full forward; returns last-position logits."""
    return DenseLM(cfg, params).prefill(tokens, positions, frames)


def serve_step(params, cache: Dict, token, length: int, cfg: ModelConfig):
    """One decode step: token [b] int -> (logits [b, vocab], cache)."""
    return DenseLM(cfg, params).serve_step(cache, token, length)


# ------------------------------------------------------------- decode
def _write(views, values) -> None:
    """New recurrent states into their cache slots, in place."""
    for t, v in zip(views, values):
        copy_state(t, v)


def _decode_decoder(params, layers, cache, x, length, cfg: ModelConfig):
    for i, p in enumerate(layers):
        layer = (cache["ckv"][i] if cfg.is_mla
                 else (cache["k"][i], cache["v"][i]))
        x, _ = decoder_block_decode(x, p, cfg, layer, length)
    return x


def _decode_xlstm(params, layers, cache, x, length, cfg: ModelConfig):
    eps = cfg.norm_eps
    for g, gp in enumerate(layers):
        for m, p in enumerate(gp["mlstm"]):
            st = (cache["mlstm_S"][g, m], cache["mlstm_n"][g, m])
            y, new = S.mlstm_step(rms_norm(x, p["norm"], eps), st, p, cfg)
            _write(st, new)
            x = x + constrain(y, _TOK)
        sp = gp["slstm"]
        st = tuple(cache[f"slstm_{k}"][g] for k in "hcn")
        y, new = S.slstm_step(rms_norm(x, sp["norm"], eps), st, sp, cfg)
        _write(st, new)
        x = x + constrain(y, _TOK)
    return x


def _decode_zamba(params, layers, cache, x, length, cfg: ModelConfig):
    shared, eps = params["shared_attn"], cfg.norm_eps
    for i, p in enumerate(layers):
        st = (cache["conv"][i], cache["S"][i])
        y, new = S.mamba2_step(rms_norm(x, p["norm"], eps), st, p, cfg)
        _write(st, new)
        x = x + constrain(y, _TOK)
        if (i + 1) % cfg.attn_every == 0:
            a = (i + 1) // cfg.attn_every - 1
            h = rms_norm(x, shared["norm1"], eps)
            h, _ = attention_decode(h, shared["attn"], cfg,
                                    (cache["attn_k"][a], cache["attn_v"][a]),
                                    length)
            x = x + constrain(h, _TOK)
            f = rms_norm(x, shared["norm2"], eps)
            x = x + constrain(mlp(f[:, None], shared["ffn"],
                                  cfg.mlp_type)[:, 0], _TOK)
    return x


def _decode_whisper(params, layers, cache, x, length, cfg: ModelConfig):
    """Whisper's decode step: the token plus its position's sinusoid,
    then per layer self-attention against the cache (written at
    ``length``), cross-attention of the one query row against
    ``enc_out`` (its keys and values recomputed from ``enc_out`` in every
    layer and step, as the JAX package does), the MLP."""
    enc_out, eps = cache["enc_out"], cfg.norm_eps
    x = x + _sinusoid_at(length, cfg.d_model, x.dtype, x.device)[None]
    for i, p in enumerate(layers):
        a = rms_norm(x, p["norm1"], eps)
        a, _ = attention_decode(a, p["attn"], cfg,
                                (cache["k"][i], cache["v"][i]), length)
        x = x + constrain(a, _TOK)
        cx = rms_norm(x, p["norm_x"], eps)
        x = x + constrain(_cross_attention(cx[:, None], p["cross"], cfg,
                                           enc_out)[:, 0], _TOK)
        f = rms_norm(x, p["norm2"], eps)
        x = x + constrain(mlp(f[:, None], p["ffn"], cfg.mlp_type)[:, 0],
                          _TOK)
    return x


# vlm decodes through the decoder path: ``attention_decode`` gives the
# token one position on all three M-RoPE streams, as the JAX package
# does, so a decode step equals the forward only where the forward's
# streams agree (text-only positions)
_DECODE = dict(dense=_decode_decoder, moe=_decode_decoder,
               vlm=_decode_decoder, ssm=_decode_xlstm, hybrid=_decode_zamba,
               audio=_decode_whisper)


def cache_specs(cfg: ModelConfig, batch: int, seq: int,
                dtype=torch.bfloat16) -> Dict:
    """{name: (shape, dtype)} of the decode cache, the JAX package's:
    MLA's compressed rows (``ckv``) or per-head keys and values; xLSTM's
    recurrent states (f32); Zamba2's conv windows (``dtype``), SSM states
    (f32) and the shared block's keys and values, one set an
    application; Whisper's self-attention keys and values and its encoder
    output ``enc_out`` [batch, encoder_seq, d]."""
    _check_family(cfg)
    L, hd, f32 = cfg.n_layers, cfg.resolved_head_dim, torch.float32
    if cfg.family == "ssm":
        G, M = L // cfg.slstm_every, cfg.slstm_every - 1
        nh = cfg.n_heads
        dh = cfg.lstm_proj_factor * cfg.d_model // nh
        hcn = ((G, batch, nh, cfg.d_model // nh), f32)
        return dict(mlstm_S=((G, M, batch, nh, dh, dh), f32),
                    mlstm_n=((G, M, batch, nh, dh), f32),
                    slstm_h=hcn, slstm_c=hcn, slstm_n=hcn)
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        kv = ((L // cfg.attn_every, batch, cfg.n_kv_heads, seq, hd), dtype)
        return dict(conv=((L, batch, cfg.ssm_conv, d_inner), dtype),
                    S=((L, batch, d_inner // 64, cfg.ssm_state, 64), f32),
                    attn_k=kv, attn_v=kv)
    if cfg.is_mla:
        return dict(ckv=((L, batch, seq, cfg.kv_lora + cfg.qk_rope_dim),
                         dtype))
    shape = (L, batch, cfg.n_kv_heads, seq, hd)
    if cfg.family == "audio":
        return dict(k=(shape, dtype), v=(shape, dtype),
                    enc_out=((batch, cfg.encoder_seq, cfg.d_model), dtype))
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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict:
    """Meta-tensor stand-ins for every model input of a ``SHAPE_SETS``
    entry (no allocation): ``tokens`` (and ``labels`` for train),
    Whisper's bf16 ``frames`` [b, encoder_seq, d] and M-RoPE's
    ``positions`` [b, 3, s]; for decode ``token``, the scalar ``length``
    and the bf16 ``cache`` of ``cache_specs``."""
    info = SHAPE_SETS[shape]
    b = batch or info["batch"]
    s = seq or info["seq"]
    i32 = torch.int32
    if info["kind"] in ("train", "prefill"):
        # whisper trains/serves on (audio frames -> text): text length s
        out = dict(tokens=_meta((b, s), i32))
        if info["kind"] == "train":
            out["labels"] = _meta((b, s), i32)
        if cfg.family == "audio":
            out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                  torch.bfloat16)
        if cfg.rope_type == "mrope":
            out["positions"] = _meta((b, 3, s), i32)
        return out
    return dict(token=_meta((b,), i32), length=_meta((), i32),
                cache={name: _meta(shp, dt) for name, (shp, dt)
                       in cache_specs(cfg, b, s).items()})

"""Model assembly for the dense family: parameter specs, init, the
full-sequence forward, prefill and the decode step.

The port of the JAX package's ``models/model.py`` (its dense subset).
Parameters keep the JAX package's tree: a nested dict whose per-layer
tensors are stacked on a leading [L, ...] axis, so one tree carries
across between the packages (``convert.params_from_numpy``).
``DenseLM`` and ``DecoderBlock`` are ``nn.Module`` views of that tree
(no copies: a block's parameters are the slices of layer i); the
functions ``forward``, ``prefill`` and ``serve_step`` take the tree as
the JAX functions do and run through them.  Every product is full f32
(``ref.matmul_f32``), whatever the process's TF32 setting.

Families other than dense raise ``NotImplementedError`` naming the
ROADMAP item they wait for.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

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


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; "
            f"{_NOT_PORTED}")


# =====================================================================
# Parameter specs (the JAX package's shapes, without sharding axes)
# =====================================================================
def param_specs(cfg: ModelConfig) -> Dict:
    _require_dense(cfg)
    L, d, hd, ff = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    specs: Dict[str, Any] = dict(embed=PSpec((cfg.vocab, d)),
                                 final_norm=PSpec((d,), "ones"))
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((d, cfg.vocab))
    ffn = dict(w1=PSpec((L, d, ff)), w2=PSpec((L, ff, d)))
    if cfg.mlp_type in ("swiglu", "geglu"):
        ffn["w3"] = PSpec((L, d, ff))
    specs["blocks"] = dict(
        norm1=PSpec((L, d), "ones"),
        attn=dict(wq=PSpec((L, d, cfg.n_heads * hd)),
                  wk=PSpec((L, d, cfg.n_kv_heads * hd)),
                  wv=PSpec((L, d, cfg.n_kv_heads * hd)),
                  wo=PSpec((L, cfg.n_heads * hd, d))),
        norm2=PSpec((L, d), "ones"),
        ffn=ffn,
    )
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


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked [L, ...] block tree (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# =====================================================================
# Modules
# =====================================================================
class _TreeModule(nn.Module):
    """Registers the leaves of a nested dict of tensors as parameters
    (no grad; the tensors themselves, not copies) and rebuilds the dict."""

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
    """A dense-family decoder LM over a parameter tree in the JAX
    package's layout (``init_params``, ``convert.params_from_numpy``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self._register_tree({k: v for k, v in params.items() if k != "blocks"})
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, layer_params(params["blocks"], i))
            for i in range(cfg.n_layers))

    def embed_tokens(self, tokens):
        x = self.embed[tokens]
        if self.cfg.scale_embedding:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def unembed(self, x):
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return matmul_f32(x, w)

    def positions(self, b: int, s: int, device) -> torch.Tensor:
        pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
        return mrope_positions(pos) if self.cfg.rope_type == "mrope" else pos

    def forward(self, tokens, positions=None, return_hidden: bool = False):
        """Full-sequence forward -> logits [b, s, vocab] (or hidden)."""
        b, s = tokens.shape
        pos = self.positions(b, s, tokens.device) if positions is None else positions
        x = self.embed_tokens(tokens)
        for blk in self.blocks:
            x = blk(x, pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x if return_hidden else self.unembed(x)

    def prefill(self, tokens, positions=None):
        """Last-position logits [b, vocab] of the full forward (only the
        last position is unembedded: the same rows of the same product)."""
        return self.unembed(self(tokens, positions, return_hidden=True)[:, -1])

    def serve_step(self, cache: Dict, token, length: int):
        """One decode step: token [b] -> (logits [b, vocab], cache), the
        cache [L, b, kv, S, hd] written at ``length`` in place."""
        x = self.embed_tokens(token[:, None])[:, 0]
        for i, blk in enumerate(self.blocks):
            x, _ = blk.decode(x, (cache["k"][i], cache["v"][i]), length)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.unembed(x), cache


# =====================================================================
# The JAX package's functional API
# =====================================================================
def forward(params, tokens, cfg: ModelConfig, positions=None,
            return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits [b, s, vocab] (or hidden)."""
    return DenseLM(cfg, params)(tokens, positions, return_hidden)


def prefill(params, tokens, cfg: ModelConfig, positions=None):
    """Prefill = full forward; returns last-position logits."""
    return DenseLM(cfg, params).prefill(tokens, positions)


def serve_step(params, cache: Dict, token, length: int, cfg: ModelConfig):
    """One decode step: token [b] int -> (logits [b, vocab], cache)."""
    return DenseLM(cfg, params).serve_step(cache, token, length)


def cache_specs(cfg: ModelConfig, batch: int, seq: int,
                dtype=torch.bfloat16) -> Dict:
    """{name: (shape, dtype)} of the decode cache."""
    _require_dense(cfg)
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

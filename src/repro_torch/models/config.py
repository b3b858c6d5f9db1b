"""Model configuration schema covering all ten assigned architectures.

A copy of the JAX package's ``models/config.py`` (same fields, defaults
and ``reduced``), with the parameter counts taken from the port's own
specs.  One frozen dataclass; every family (dense / moe / ssm / hybrid /
audio / vlm) is a point in this space.  ``repro_torch/configs/<arch>.py``
holds the exact published values.  The port runs the dense family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MLP / norm flavour
    mlp_type: str = "swiglu"         # swiglu | geglu
    norm_eps: float = 1e-5
    scale_embedding: bool = False    # gemma-style sqrt(d) scaling
    tie_embeddings: bool = True

    # --- RoPE flavour
    rope_type: str = "full"          # full | half | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()

    # --- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v2)
    kv_lora: int = 0                 # compressed kv dim (0 = standard GQA)
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid
    ssm_state: int = 0               # mamba2 state size
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 64
    slstm_every: int = 0             # xlstm: one sLSTM per this many layers
    attn_every: int = 0              # zamba2: shared attn block period
    lstm_proj_factor: int = 2

    # --- encoder-decoder (whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # precomputed frame embeddings (stub)

    # --- modality frontend stub
    frontend: str = "none"           # none | audio_stub | patch_stub

    # --- attention impl
    attn_block_q: int = 512
    attn_block_k: int = 512
    # §Perf knobs (hillclimb levers — defaults = paper-faithful baseline)
    attn_causal_skip: bool = False   # skip upper-triangular kv blocks
    remat_policy: str = "full"       # full | dots | none
    loss_chunk: int = 0              # chunked CE loss (0 = monolithic)
    mla_absorb: bool = False         # absorb k_up/v_up into q/out (decode)
    shard_state_dim: bool = False    # recurrent state: shard feature dim
    #                                  over 'model' (nh often < mesh axis)
    seq_shard: bool = False          # sequence-parallel activations
    #                                  (shard seq over 'model' at layer
    #                                  boundaries; attention re-gathers)

    # --- training
    max_seq: int = 4096
    remat: bool = True

    # --- cost-analysis mode: XLA's HloCostAnalysis counts while/scan
    # bodies ONCE, so the roofline harness compiles unrolled shallow
    # variants (L=1, L=2) and extrapolates the per-layer slope.
    unroll_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora > 0

    @property
    def is_recurrent(self) -> bool:
        """O(1)-state decode (eligible for long_500k)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameter count, from the port's parameter specs (the
        dense family; others raise NotImplementedError)."""
        from .model import param_specs  # lazy, avoids a cycle
        return sum(_numel(s.shape) for _, s in _leaves(param_specs(self)))

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        from .model import param_specs
        total = self.param_count()
        expert = sum(_numel(s.shape) for k, s in _leaves(param_specs(self))
                     if k.endswith((".we1", ".we2", ".we3")))
        per_expert = expert // max(self.n_experts, 1)
        return total - expert + per_expert * self.top_k


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= int(x)
    return n


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-sized variant of an architecture: same family/topology,
    tiny dims.  Keeps structural ratios (GQA grouping, MoE top-k, block
    patterns) intact."""
    small = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4),
        head_dim=32,
        d_ff=256,
        vocab=512,
        max_seq=128,
        attn_block_q=64,
        attn_block_k=64,
        ssm_chunk=16,
    )
    if cfg.n_kv_heads == cfg.n_heads:
        small["n_kv_heads"] = 4
    elif cfg.n_kv_heads == 1:
        small["n_kv_heads"] = 1
    else:
        small["n_kv_heads"] = 2
    if cfg.is_moe:
        small.update(
            n_experts=min(cfg.n_experts, 8),
            top_k=min(cfg.top_k, 2),
            d_ff_expert=128,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            # no capacity drops at toy scale: keeps decode ≡ forward exact
            capacity_factor=8.0,
        )
    if cfg.is_mla:
        small.update(kv_lora=64, qk_nope_dim=32, qk_rope_dim=16,
                     v_head_dim=32)
    if cfg.ssm_state:
        small.update(ssm_state=16)
    if cfg.slstm_every:
        small.update(n_layers=cfg.slstm_every, slstm_every=cfg.slstm_every)
    if cfg.attn_every:
        small.update(n_layers=2 * cfg.attn_every, attn_every=cfg.attn_every)
    if cfg.is_encdec:
        small.update(encoder_layers=2, encoder_seq=64)
    if cfg.mrope_sections:
        # rescale sections to the reduced head_dim (roughly 1:1.5:1.5)
        hd2 = small.get("head_dim", cfg.resolved_head_dim) // 2
        a = hd2 // 4
        b_ = (hd2 - a) // 2
        small.update(mrope_sections=(a, b_, hd2 - a - b_))
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

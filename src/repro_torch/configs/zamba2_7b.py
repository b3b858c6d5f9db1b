"""Zamba2-7B — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_chunk=64, attn_every=6,
    mlp_type="swiglu", rope_type="full", rope_theta=10_000.0,
    tie_embeddings=False,
)

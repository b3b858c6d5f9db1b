"""Qwen2-VL-72B backbone — M-RoPE, patch frontend stubbed
[arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    mlp_type="swiglu", rope_type="mrope", rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="patch_stub", tie_embeddings=False,
)

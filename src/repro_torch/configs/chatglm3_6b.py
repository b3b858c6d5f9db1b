"""ChatGLM3-6B — 2d-RoPE (half-dim rotary), GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=65024,
    mlp_type="swiglu", rope_type="half", rope_theta=10_000.0,
    tie_embeddings=False,
)

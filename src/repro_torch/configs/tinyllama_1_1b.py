"""TinyLlama-1.1B — llama2-architecture small model [arXiv:2401.02385]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab=32000,
    mlp_type="swiglu", rope_type="full", rope_theta=10_000.0,
    tie_embeddings=False,
)

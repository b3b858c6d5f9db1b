"""Gemma-2B — GeGLU, head_dim 256, MQA [arXiv:2403.08295]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000,
    mlp_type="geglu", rope_type="full", rope_theta=10_000.0,
    scale_embedding=True, tie_embeddings=True,
)

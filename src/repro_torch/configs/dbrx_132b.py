"""DBRX-132B — 16 experts top-4, fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    n_experts=16, n_shared_experts=0, top_k=4, d_ff_expert=10752,
    mlp_type="swiglu", rope_type="full", rope_theta=500_000.0,
    tie_embeddings=False,
)

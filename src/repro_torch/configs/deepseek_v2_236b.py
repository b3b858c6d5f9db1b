"""DeepSeek-V2 236B — MLA (kv_lora 512) + 2 shared / 160 routed experts
top-6 [arXiv:2405.04434]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    head_dim=192,  # qk_nope + qk_rope
    mlp_type="swiglu", rope_type="full", rope_theta=10_000.0,
    tie_embeddings=False,
)

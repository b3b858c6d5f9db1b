"""CodeQwen1.5-7B — qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab=92416,
    mlp_type="swiglu", rope_type="full", rope_theta=1_000_000.0,
    tie_embeddings=False,
)

"""xLSTM-1.3B — mLSTM + sLSTM blocks (7:1) [arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8, lstm_proj_factor=2, ssm_chunk=64,
    rope_type="none", tie_embeddings=False,
)

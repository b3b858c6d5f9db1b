"""Whisper-large-v3 — enc-dec; conv frontend is a stub (precomputed frame
embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    is_encdec=True, encoder_layers=32, encoder_seq=1500,
    frontend="audio_stub",
    mlp_type="gelu", rope_type="none", tie_embeddings=True,
)

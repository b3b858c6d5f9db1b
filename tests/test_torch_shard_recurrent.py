"""The SSM, hybrid and audio families' sharded compute on 8 gloo ranks
(xLSTM's chunked recurrence and sLSTM loop, Zamba2's Mamba2 layers and
shared block, Whisper's encoder and cross-attention):
``test_torch_shard_compute.check_archs_on_8_gloo_ranks``'s gates."""
from test_torch_shard_compute import check_archs_on_8_gloo_ranks


def test_ssm_hybrid_and_audio_archs_on_8_gloo_ranks(tmp_path):
    check_archs_on_8_gloo_ranks(tmp_path, "ssm, hybrid and audio")

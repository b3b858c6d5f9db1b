"""The dense and VLM families' sharded compute on 8 gloo ranks (TinyLlama,
CodeQwen1.5, Gemma, ChatGLM3 with 2 KV heads on a 4-way ``"model"`` axis,
Qwen2-VL with M-RoPE): ``test_torch_shard_compute.check_archs_on_8_gloo_
ranks``'s gates."""
from test_torch_shard_compute import check_archs_on_8_gloo_ranks


def test_dense_and_vlm_archs_on_8_gloo_ranks(tmp_path):
    check_archs_on_8_gloo_ranks(tmp_path, "dense and vlm")

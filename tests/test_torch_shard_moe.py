"""The MoE family's sharded compute on 8 gloo ranks (DeepSeek-V2's MLA
and DBRX, experts over ``"model"``, the dispatch and combine on each
rank's groups): ``test_torch_shard_compute.check_archs_on_8_gloo_ranks``'s
gates."""
from test_torch_shard_compute import check_archs_on_8_gloo_ranks


def test_moe_archs_on_8_gloo_ranks(tmp_path):
    check_archs_on_8_gloo_ranks(tmp_path, "moe")

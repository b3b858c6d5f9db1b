"""Architecture registry — one module per assigned architecture."""
from importlib import import_module

from repro_torch.models.config import ModelConfig, reduced

ARCHS = [
    "tinyllama_1_1b",
    "codeqwen1_5_7b",
    "gemma_2b",
    "chatglm3_6b",
    "deepseek_v2_236b",
    "dbrx_132b",
    "xlstm_1_3b",
    "zamba2_7b",
    "whisper_large_v3",
    "qwen2_vl_72b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    mod = name.replace("-", "_").replace(".", "_")
    mod = _ALIAS.get(name, mod)
    return import_module(f"repro_torch.configs.{mod}").CONFIG


def list_archs():
    return list(ARCHS)


__all__ = ["ARCHS", "get_config", "list_archs", "ModelConfig", "reduced"]

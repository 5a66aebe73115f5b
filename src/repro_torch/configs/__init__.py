"""Architecture registry: ``get_config(name, smoke=False)``.

The port serves every arch the reference serves continuously:
granite-3-8b, starcoder2-15b and qwen1.5-110b (dense GQA), minicpm3-4b
(MLA), granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b (MoE) and
qwen2-vl-72b (the VLM backbone, M-RoPE).  The recurrent and enc-dec
archs follow with their families.
"""

from __future__ import annotations

from repro_torch.configs import (
    granite_3_8b,
    granite_moe_1b_a400m,
    minicpm3_4b,
    phi3_5_moe_42b_a6_6b,
    qwen1_5_110b,
    qwen2_vl_72b,
    starcoder2_15b,
)
from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCH_IDS = ("granite_3_8b", "minicpm3_4b", "granite_moe_1b_a400m", "qwen2_vl_72b",
            "starcoder2_15b", "phi3_5_moe_42b_a6_6b", "qwen1_5_110b")

_MODULES = {
    "granite_3_8b": granite_3_8b,
    "minicpm3_4b": minicpm3_4b,
    "granite_moe_1b_a400m": granite_moe_1b_a400m,
    "qwen2_vl_72b": qwen2_vl_72b,
    "starcoder2_15b": starcoder2_15b,
    "phi3_5_moe_42b_a6_6b": phi3_5_moe_42b_a6_6b,
    "qwen1_5_110b": qwen1_5_110b,
}


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    key = canon(name)
    if key not in _MODULES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: {ARCH_IDS}); "
            "see ROADMAP.md queue 1"
        )
    mod = _MODULES[key]
    return mod.SMOKE if smoke else mod.CONFIG

"""Architecture registry: ``get_config(name, smoke=False)``.

The port serves granite-3-8b (dense GQA), minicpm3-4b (MLA) and
granite-moe-1b-a400m (MoE); the others follow with their families.
"""

from __future__ import annotations

from repro_torch.configs import granite_3_8b, granite_moe_1b_a400m, minicpm3_4b
from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCH_IDS = ("granite_3_8b", "minicpm3_4b", "granite_moe_1b_a400m")

_MODULES = {
    "granite_3_8b": granite_3_8b,
    "minicpm3_4b": minicpm3_4b,
    "granite_moe_1b_a400m": granite_moe_1b_a400m,
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

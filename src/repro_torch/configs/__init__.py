"""Architecture registry: ``get_config(name, smoke=False)``.

The port serves dense decoders only: granite-3-8b (GQA) and minicpm3-4b
(MLA) are registered; the others follow with their families.
"""

from __future__ import annotations

from repro_torch.configs import granite_3_8b, minicpm3_4b
from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCH_IDS = ("granite_3_8b", "minicpm3_4b")

_MODULES = {"granite_3_8b": granite_3_8b, "minicpm3_4b": minicpm3_4b}


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

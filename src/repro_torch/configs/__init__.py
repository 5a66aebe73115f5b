"""Architecture registry: ``get_config(name, smoke=False, sparsity_mode=None)``.

Every arch of the reference: granite-3-8b, starcoder2-15b and
qwen1.5-110b (dense GQA), minicpm3-4b (MLA), granite-moe-1b-a400m and
phi3.5-moe-42b-a6.6b (MoE) and qwen2-vl-72b (the VLM backbone, M-RoPE),
served continuously; mamba2-130m (SSM) and hymba-1.5b (hybrid), served
stepped; whisper-base (enc-dec), driven through ``models/encdec.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    granite_3_8b,
    granite_moe_1b_a400m,
    hymba_1_5b,
    mamba2_130m,
    minicpm3_4b,
    phi3_5_moe_42b_a6_6b,
    qwen1_5_110b,
    qwen2_vl_72b,
    starcoder2_15b,
    whisper_base,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell, shape_by_name  # noqa: F401

ARCH_IDS = ("granite_3_8b", "minicpm3_4b", "granite_moe_1b_a400m", "qwen2_vl_72b",
            "starcoder2_15b", "phi3_5_moe_42b_a6_6b", "qwen1_5_110b", "mamba2_130m",
            "hymba_1_5b", "whisper_base")

# pure full-attention archs skip long_500k (the reference's applicability rule)
LONG_CONTEXT_OK = {"hymba_1_5b", "mamba2_130m", "starcoder2_15b"}

_MODULES = {
    "granite_3_8b": granite_3_8b,
    "minicpm3_4b": minicpm3_4b,
    "granite_moe_1b_a400m": granite_moe_1b_a400m,
    "qwen2_vl_72b": qwen2_vl_72b,
    "starcoder2_15b": starcoder2_15b,
    "phi3_5_moe_42b_a6_6b": phi3_5_moe_42b_a6_6b,
    "qwen1_5_110b": qwen1_5_110b,
    "mamba2_130m": mamba2_130m,
    "hymba_1_5b": hymba_1_5b,
    "whisper_base": whisper_base,
}


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str, smoke: bool = False, sparsity_mode: str | None = None) -> ModelConfig:
    """The published configuration of ``name`` (or its reduced smoke
    variant), with the sparsity mode replaced when ``sparsity_mode`` is
    given (``dense`` | ``wdbb`` | ``awdbb``)."""
    key = canon(name)
    if key not in _MODULES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported: the reference has no such arch "
            f"(ported: {ARCH_IDS})"
        )
    mod = _MODULES[key]
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if sparsity_mode is not None:
        cfg = dataclasses.replace(
            cfg, sparsity=dataclasses.replace(cfg.sparsity, mode=sparsity_mode))
    return cfg


def applicable_shapes(name: str) -> list:
    """The dry-run shape cells of ``name``: every cell of ``SHAPES``,
    ``long_500k`` only for the archs of ``LONG_CONTEXT_OK``."""
    return [s for s in SHAPES
            if s.name != "long_500k" or canon(name) in LONG_CONTEXT_OK]

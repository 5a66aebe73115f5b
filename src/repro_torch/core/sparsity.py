"""Framework-level sparsity configuration (port of ``repro.core.sparsity``).

``w_nnz``/``a_nnz`` over blocks of ``bz`` are the weight and activation
density bounds (paper §5, 4/8 typical); ``act_scale`` picks the int8
wire's dynamic activation-scale granularity, ``kv_dtype`` the KV-cache
storage and ``paged_attn`` the paged read: ``"fused"`` runs the fused
paged-attention kernel (#6; its plain version on CPU tensors),
``"gather"`` materializes each request's window and attends in plain
PyTorch, and ``"auto"`` resolves per shape as the reference's does (the
autotune cache, then fused on a CUDA device and gather elsewhere).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import dbb
from repro_torch.core.dap import DAPSpec


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    mode: str = "dense"  # dense | wdbb | awdbb
    w_nnz: int = 4
    a_nnz: int = 4
    bz: int = dbb.DEFAULT_BZ
    a_nnz_per_layer: Optional[Sequence[int]] = None  # variable A-DBB
    exclude_first_layer: bool = True  # paper Table 3 note 2
    act_scale: str = "per_tensor"  # per_tensor | per_row (int8 wire)
    kv_dtype: str = "native"  # native | int8 (KV cache storage)
    paged_attn: str = "auto"  # auto | gather | fused (paged attention read)

    def __post_init__(self):
        if self.mode not in ("dense", "wdbb", "awdbb"):
            raise ValueError(f"unknown sparsity mode {self.mode!r}")
        if self.act_scale not in ("per_tensor", "per_row"):
            raise ValueError(
                f"unknown act_scale {self.act_scale!r}; per_tensor|per_row"
            )
        if self.kv_dtype not in ("native", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; native|int8")
        if self.paged_attn not in ("auto", "gather", "fused"):
            raise ValueError(f"unknown paged_attn {self.paged_attn!r}; auto|gather|fused")

    @property
    def w_cfg(self) -> Optional[dbb.DBBConfig]:
        """The weight bound under ``wdbb`` and ``awdbb``, else None."""
        if self.mode in ("wdbb", "awdbb"):
            return dbb.DBBConfig(self.w_nnz, self.bz)
        return None

    def a_spec(self, layer_idx: int | None = None) -> Optional[DAPSpec]:
        """The DAP spec of layer ``layer_idx``.  The paged layer loop
        passes ``None`` (as the reference's layer scan does), so every
        layer DAP-packs at the default ``a_nnz``."""
        if self.mode != "awdbb":
            return None
        nnz = self.a_nnz
        if self.a_nnz_per_layer is not None and layer_idx is not None:
            nnz = self.a_nnz_per_layer[layer_idx % len(self.a_nnz_per_layer)]
        if nnz >= self.bz:
            return None  # dense bypass
        return DAPSpec(nnz=nnz, bz=self.bz)

    def tighten(self, a_nnz: int) -> "SparsityConfig":
        """A tighter rung of the DBB density ladder: the same weights under
        the activation bound ``a_nnz`` (paper §5.2), the draft model of
        self-speculative decoding (``serve/engine.py``'s ``SpecConfig``).
        ``kv_dtype``, ``paged_attn`` and ``act_scale`` are kept, so the
        draft shares the target's cache layout; a per-layer override list
        is dropped, the draft bound applies to every layer."""
        if not 1 <= a_nnz <= self.bz:
            raise ValueError(f"draft a_nnz must be in [1, bz={self.bz}], got {a_nnz}")
        return dataclasses.replace(self, mode="awdbb", a_nnz=a_nnz, a_nnz_per_layer=None)


DENSE = SparsityConfig(mode="dense")
WDBB_4_8 = SparsityConfig(mode="wdbb", w_nnz=4)
AWDBB_4_8 = SparsityConfig(mode="awdbb", w_nnz=4, a_nnz=4)

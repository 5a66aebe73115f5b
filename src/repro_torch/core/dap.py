"""Dynamic Activation Pruning forward (port of ``repro.core.dap``).

Within each block of ``bz`` channels keep the ``nnz`` largest magnitudes
(the paper's cascaded maxpool, Fig. 8): kernel #5 on a CUDA tensor, its
plain version (``dbb.prune``) on a CPU tensor.  Serving needs the forward
only; the straight-through gradient is a later slice (training).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dbb
from repro_torch.kernels import ops

HW_MAX_STAGES = 5  # paper §6.2: "We cap the maxpool stages at 5"


@dataclasses.dataclass(frozen=True)
class DAPSpec:
    """Per-layer DAP configuration; ``nnz == bz`` bypasses DAP."""

    nnz: int = 4
    bz: int = dbb.DEFAULT_BZ

    def __post_init__(self):
        if self.nnz != self.bz and self.nnz > HW_MAX_STAGES:
            raise ValueError(
                f"DAP hardware supports NNZ<= {HW_MAX_STAGES} (or dense bypass "
                f"NNZ==BZ); got {self.nnz}/{self.bz}"
            )

    @property
    def cfg(self) -> dbb.DBBConfig:
        return dbb.DBBConfig(nnz=self.nnz, bz=self.bz)

    @property
    def is_dense(self) -> bool:
        return self.nnz == self.bz


def apply_dap(a: torch.Tensor, spec: DAPSpec | None) -> torch.Tensor:
    """Top-NNZ-per-block pruning (``ops.dap_prune``, pruned tensor only);
    identity when ``spec`` is None or dense."""
    if spec is None or spec.is_dense:
        return a
    return ops.dap_prune(a, spec.nnz, spec.bz)[0]

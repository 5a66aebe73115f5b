"""Dynamic Activation Pruning (port of ``repro.core.dap``).

Within each block of ``bz`` channels keep the ``nnz`` largest magnitudes
(the paper's cascaded maxpool, Fig. 8): kernel #5's dense form on a CUDA
tensor, its plain version (``dbb.prune``) on a CPU tensor.  Training
(paper §8.1) passes the gradient straight through the kept elements only:
``d DAP(a) / d a`` is the Top-NNZ *selection* mask (:class:`DAPSTE`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import dbb
from repro_torch.sharding import context

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


def selection_mask(a: torch.Tensor, pruned: torch.Tensor, nnz: int, bz: int) -> torch.Tensor:
    """The reference's Top-NNZ selection ``dbb.topk_block_mask(a)``, read
    off DAP's output instead of recomputed: a non-zero is selected iff it
    was kept (``pruned != 0``, what #5's bitmask marks); a block with
    ``c < nnz`` kept non-zeros also selects its ``nnz - c`` lowest-index
    zeros (``-0.0`` included: the cascade's ties go to the lower index);
    a block holding a NaN selects nothing (its max is NaN, which equals
    no element)."""
    kept = dbb._to_blocks(pruned != 0, bz)
    ab = dbb._to_blocks(a, bz)
    zero = ab == 0
    # earlier zeros in the block: a product with the strictly upper
    # triangular ones (small integers, exact in f32); a cumsum along the
    # 8-wide axis is a slow scan on CUDA (3.4 ms at [4096, 1024])
    earlier = torch.ones((bz, bz), dtype=torch.float32, device=a.device).triu(1)
    zero_rank = torch.matmul(zero.to(torch.float32), earlier)
    room = nnz - kept.sum(dim=-1, keepdim=True, dtype=torch.int32)
    fill = zero & (zero_rank < room) & ~torch.isnan(ab).any(dim=-1, keepdim=True)
    return dbb._from_blocks(kept | fill)


def _dap_prune(a: torch.Tensor, nnz: int, bz: int) -> torch.Tensor:
    """``ops.dap_prune``'s pruned tensor.  ``kernels`` imports ``core``,
    so ``kernels.ops`` is imported at the call, not with this module:
    then ``core`` and every ``kernels`` module may be imported first."""
    from repro_torch.kernels import ops

    return ops.dap_prune(a, nnz, bz)[0]


class DAPSTE(torch.autograd.Function):
    """DAP with the straight-through gradient.  Forward: exactly
    ``ops.dap_prune`` (kernel #5's dense form on CUDA, its plain version
    on the CPU).  Backward: the gradient times the selection mask
    (:func:`selection_mask`, derived from the forward's output and the
    saved input: a few elementwise ops, a block sum and an 8 x 8 product,
    where recomputing the cascade takes ``nnz`` rounds of six).  The
    backward is plain PyTorch, as it is plain JAX in the reference."""

    @staticmethod
    def forward(ctx, a, nnz: int, bz: int):
        pruned = _dap_prune(a, nnz, bz)
        ctx.save_for_backward(a, pruned)
        ctx.nnz, ctx.bz = nnz, bz
        return pruned

    @staticmethod
    def backward(ctx, g):
        a, pruned = ctx.saved_tensors
        if isinstance(a, DTensor):  # shard by shard, as the forward pruned
            sel = context.run_local(lambda x, p: selection_mask(x, p, ctx.nnz, ctx.bz),
                                    (a, pruned), context.row_placements(a, ctx.bz))
        else:
            sel = selection_mask(a, pruned, ctx.nnz, ctx.bz)
        return torch.where(sel, g, torch.zeros_like(g)), None, None


def dap(a: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ) -> torch.Tensor:
    """Top-NNZ-per-block pruning along the last axis (``ops.dap_prune``,
    pruned tensor only), through :class:`DAPSTE` when a gradient is
    wanted: the reference's ``custom_vjp`` as one function.  Identity at
    ``nnz == bz``."""
    if nnz == bz:
        return a
    if torch.is_grad_enabled() and a.requires_grad:
        return DAPSTE.apply(a, nnz, bz)
    return _dap_prune(a, nnz, bz)


def apply_dap(a: torch.Tensor, spec: DAPSpec | None) -> torch.Tensor:
    """:func:`dap` at ``spec``; identity when ``spec`` is None or dense."""
    if spec is None or spec.is_dense:
        return a
    return dap(a, spec.nnz, spec.bz)

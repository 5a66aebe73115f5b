"""Density Bound Block (DBB) structured sparsity (port of ``repro.core.dbb``).

The reduction axis (the last axis) is tiled into blocks of ``bz``
elements holding at most ``nnz`` non-zeros (paper §3.1).  The wire format
is rank-ordered: ``values [..., K//bz, nnz]`` plus a ``uint8`` bitmask
``[..., K//bz]`` where bit ``b`` marks a kept non-zero at block position
``b`` and value slot ``j`` holds the ``j``-th set bit's value, so position
``b`` decodes as ``bit_b ? values[popcount(mask & (2^b - 1))] : 0``.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_BZ = 8  # paper §6.2


@dataclasses.dataclass(frozen=True)
class DBBConfig:
    """An ``NNZ/BZ`` density-bound-block configuration."""

    nnz: int = 4
    bz: int = DEFAULT_BZ

    def __post_init__(self):
        if not (1 <= self.nnz <= self.bz):
            raise ValueError(f"NNZ must be in [1, BZ]; got {self.nnz}/{self.bz}")

    @property
    def is_dense(self) -> bool:
        return self.nnz == self.bz

    def __str__(self) -> str:
        return f"{self.nnz}/{self.bz}"


def _to_blocks(x: torch.Tensor, bz: int) -> torch.Tensor:
    k = x.shape[-1]
    if k % bz != 0:
        raise ValueError(f"last dim {k} not divisible by block size {bz}")
    return x.reshape(*x.shape[:-1], k // bz, bz)


def _from_blocks(xb: torch.Tensor) -> torch.Tensor:
    return xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])


def topk_block_mask(x: torch.Tensor, cfg: DBBConfig) -> torch.Tensor:
    """Boolean mask keeping the Top-NNZ magnitudes of each block.

    The DAP hardware's cascade (paper Fig. 8): ``nnz`` max stages over the
    magnitudes in the input's own dtype, each discounting earlier winners,
    ties broken toward the LOWER index.  ``torch.topk`` promises no
    tie-break, so it is not used.
    """
    if cfg.is_dense:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    xb = _to_blocks(x, cfg.bz)
    mag = xb.abs()
    pos = torch.arange(cfg.bz, device=x.device)
    kept = torch.zeros(xb.shape, dtype=torch.bool, device=x.device)
    neg = torch.full_like(mag, float("-inf"))
    bz_t = torch.full_like(pos, cfg.bz)
    for _ in range(cfg.nnz):
        cand = torch.where(kept, neg, mag)
        mx = cand.amax(dim=-1, keepdim=True)
        first = torch.where(cand == mx, pos, bz_t).amin(dim=-1, keepdim=True)
        kept = kept | (pos == first)
    return _from_blocks(kept)


def prune(x: torch.Tensor, cfg: DBBConfig) -> torch.Tensor:
    """Dense -> dense Top-NNZ-per-block pruning."""
    if cfg.is_dense:
        return x
    return torch.where(topk_block_mask(x, cfg), x, torch.zeros_like(x))


@dataclasses.dataclass
class PackedDBB:
    """A compressed DBB tensor: values and per-block positions.

    ``values [..., K//bz, nnz]`` in the dense tensor's dtype; ``indices
    [..., K//bz, nnz]`` int8, the position of each value in its block:
    always ``nnz`` *distinct* positions, the kept ones first in ascending
    order, then unused positions holding 0 (paper §3.1).  ``k`` is the
    dense extent of the last axis."""

    values: torch.Tensor
    indices: torch.Tensor
    cfg: DBBConfig
    k: int

    @property
    def bitmask(self) -> torch.Tensor:
        """The paper's bitmask ``M``: uint8 a block, bit ``b`` set when
        position ``b`` holds a non-zero value."""
        pos = torch.arange(self.cfg.bz, dtype=torch.int32, device=self.values.device)
        onehot = (self.indices[..., None].to(torch.int32) == pos) & (self.values != 0)[..., None]
        bits = onehot.any(dim=-2)  # [..., nblk, BZ]
        return (bits.to(torch.int32) * (2 ** pos)).sum(dim=-1).to(torch.uint8)

    def compression_ratio(self) -> float:
        """Bytes of the dense block over the packed one (an int8 index a
        kept value)."""
        b = self.values.element_size()
        return self.cfg.bz * b / (self.cfg.nnz * (b + 1))


def pack(x: torch.Tensor, cfg: DBBConfig, assume_pruned: bool = False) -> PackedDBB:
    """Dense -> :class:`PackedDBB`, Top-NNZ pruned first unless
    ``assume_pruned`` (then the non-zeros are kept, in position order).
    Exact when every block obeys the bound, as :func:`prune` makes it."""
    xb = _to_blocks(x, cfg.bz)
    pos = torch.arange(cfg.bz, device=x.device)
    keep = xb != 0 if assume_pruned else _to_blocks(topk_block_mask(x, cfg), cfg.bz)
    # kept positions first, ascending, then the rest; the keys are distinct
    key = (~keep).to(torch.int64) * cfg.bz + pos
    order = torch.argsort(key, dim=-1)[..., : cfg.nnz]
    vals = torch.gather(xb, -1, order)
    if not assume_pruned:
        vals = torch.where(torch.gather(keep, -1, order), vals, torch.zeros_like(vals))
    return PackedDBB(values=vals, indices=order.to(torch.int8), cfg=cfg, k=x.shape[-1])


def unpack(p: PackedDBB) -> torch.Tensor:
    """:class:`PackedDBB` -> dense, the inverse of :func:`pack` on
    DBB-compliant tensors: a one-hot sum in float32 as the reference does
    (the DP4M8 mux, paper Fig. 6c); the positions are distinct, so one
    term a position is non-zero and the sum is exact.  Zeros keep XLA's
    signs: its reduce starts from +0.0, as torch's sum does, except over
    one term (NNZ 1), which it copies (a -0.0 term stays -0.0)."""
    pos = torch.arange(p.cfg.bz, dtype=torch.int32, device=p.values.device)
    onehot = p.indices[..., None].to(torch.int32) == pos  # [..., nblk, NNZ, BZ]
    terms = p.values[..., None].float() * onehot.float()
    out_b = terms[..., 0, :] if p.cfg.nnz == 1 else terms.sum(dim=-2)
    out_b = out_b.to(p.values.dtype)
    return _from_blocks(out_b)


def pack_bitmask(x: torch.Tensor, cfg: DBBConfig):
    """Dense -> ``(values [..., K//bz, nnz], bitmask [..., K//bz] uint8)``
    in rank order.  Zeros are never kept: they take no value slot and no
    mask bit; unused slots are zero."""
    xb = _to_blocks(x, cfg.bz)
    kept = _to_blocks(topk_block_mask(x, cfg), cfg.bz) & (xb != 0)
    pos = torch.arange(cfg.bz, device=x.device)
    # set bits first (ascending position), then unset positions; the keys
    # are distinct, so the order is unique
    key = torch.where(kept, pos, cfg.bz + pos)
    order = torch.argsort(key, dim=-1)[..., : cfg.nnz]
    vals = torch.gather(xb, -1, order)
    sel = torch.gather(kept, -1, order)
    vals = torch.where(sel, vals, torch.zeros_like(vals))
    weights = (2 ** pos).to(torch.int32)
    bitmask = (kept.to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)
    return vals, bitmask


def expand_bitmask(values: torch.Tensor, bitmask: torch.Tensor, cfg: DBBConfig) -> torch.Tensor:
    """``(values, bitmask) -> dense``; inverse of :func:`pack_bitmask`:
    ``dense[b] = bit_b ? values[rank(b)] : 0`` with
    ``rank(b) = popcount(mask & (2^b - 1))``.  A one-hot sum in float32
    as the reference does: exactly one term per position is non-zero, so
    it is exact."""
    mask = bitmask.to(torch.int32)
    pos = torch.arange(cfg.bz, dtype=torch.int32, device=values.device)
    bits = (mask[..., None] >> pos) & 1  # [..., nblk, BZ]
    rank = torch.cumsum(bits, dim=-1) - bits  # popcount of lower bits
    slots = torch.arange(cfg.nnz, dtype=torch.int32, device=values.device)
    onehot = rank[..., None] == slots
    gathered = (values[..., None, :].float() * onehot.float()).sum(dim=-1)
    dense_b = (bits.float() * gathered).to(values.dtype)
    return _from_blocks(dense_b)


def pack_bitmask_int8(x: torch.Tensor, cfg: DBBConfig, scale_axis=None):
    """Dense -> ``(int8 values, bitmask, f32 scale)``: :func:`pack_bitmask`
    then symmetric quantization of the kept values, the scale shared over
    the packed-layout axes ``scale_axis`` (None = per tensor)."""
    from repro_torch.core import quant

    vals, bitmask = pack_bitmask(x, cfg)
    q, scale = quant.quantize(vals, axis=scale_axis)
    return q, bitmask, scale


def expand_bitmask_int8(values: torch.Tensor, bitmask: torch.Tensor, scale: torch.Tensor,
                        cfg: DBBConfig, scale_axis=None, dtype=torch.float32) -> torch.Tensor:
    """``(int8 values, bitmask, scale) -> dense``: the inverse of
    :func:`pack_bitmask_int8` up to the quantization grid."""
    from repro_torch.core import quant

    deq = quant.dequantize(values, scale, axis=scale_axis)
    return expand_bitmask(deq, bitmask, cfg).to(dtype)


def block_density(x: torch.Tensor, bz: int = DEFAULT_BZ) -> torch.Tensor:
    """Non-zeros in each block of ``bz`` along the last axis."""
    return (_to_blocks(x, bz) != 0).sum(dim=-1)


def satisfies(x: torch.Tensor, cfg: DBBConfig) -> torch.Tensor:
    """Scalar bool: every block obeys the NNZ bound."""
    return torch.all(block_density(x, cfg.bz) <= cfg.nnz)

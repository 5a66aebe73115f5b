"""W-DBB progressive pruning schedule (port of ``repro.core.schedule``;
paper §8.1, "Training for W-DBB").

The Zhu-Gupta cubic ramp on the per-block kept count: at step ``t`` the
bound falls from ``BZ`` (dense) to the target ``NNZ``,

    nnz(t) = NNZ + (BZ - NNZ) * (1 - min(1, (t - t0) / (t1 - t0)))**3,

rounded up; the weight mask is recomputed from the current magnitudes
every ``update_every`` steps until ``t1``.

The reference decides and blocks on its *stacked* leaves: a per-layer
leaf is one ``[L, ...]`` array, eligible when its rank is at least 2 and
its axis -2 divides by ``bz``, and blocked along that axis.  For a
per-layer weight (``[L, d_in, d_out]``) that is each layer's own input
axis; for a per-layer vector (``[L, d]``: norm scales, biases, mamba2's
``A_log``, ``D``, ``dt_bias``, ``conv_b``) it is the *layer axis*, so
when ``L % bz == 0`` each element keeps or loses its value by its
magnitude among the same element of the other layers of its 8-block.
The port's layers are unstacked, so a per-layer vector is stacked here
for the decision and the mask, and split back (``core/tree.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import dbb, tree


@dataclasses.dataclass(frozen=True)
class WDBBSchedule:
    target: dbb.DBBConfig = dbb.DBBConfig(4, 8)
    begin_step: int = 0
    end_step: int = 1000
    update_every: int = 10

    def nnz_at(self, step) -> torch.Tensor:
        """The current (f32) NNZ bound at ``step``: the cubic ramp."""
        t = torch.clamp(
            (torch.as_tensor(step, dtype=torch.float32) - self.begin_step)
            / max(1, self.end_step - self.begin_step),
            0.0, 1.0,
        )
        span = self.target.bz - self.target.nnz
        return self.target.nnz + span * (1.0 - t) ** 3

    def cfg_at(self, step: int) -> dbb.DBBConfig:
        """The bound at ``step`` rounded up, decided on the host."""
        t = min(1.0, max(0.0, (step - self.begin_step) / max(1, self.end_step - self.begin_step)))
        span = self.target.bz - self.target.nnz
        nnz = int(math.ceil(self.target.nnz + span * (1.0 - t) ** 3))
        return dbb.DBBConfig(nnz=min(nnz, self.target.bz), bz=self.target.bz)

    def should_update(self, step: int) -> bool:
        return step % self.update_every == 0 and step <= self.end_step


def _eligible(g: tree.Group, cfg: dbb.DBBConfig, predicate) -> bool:
    """The reference's rule on the stacked leaf: a float array of rank
    >= 2 whose axis -2 divides by ``bz``, and ``predicate(path, piece)``
    for every piece (paths ``layers/<i>/...``)."""
    p0 = g.pieces[0]
    ndim = p0.ndim + (1 if g.stacked else 0)
    if ndim < 2 or not p0.is_floating_point():
        return False
    axis = len(g.pieces) if g.stacked and p0.ndim == 1 else p0.shape[-2]
    if axis % cfg.bz != 0:
        return False
    if predicate is None:
        return True
    return all(predicate(path, p) for path, p in zip(g.piece_paths(), g.pieces))


def _block_mask(w: torch.Tensor, cfg: dbb.DBBConfig) -> torch.Tensor:
    """Top-NNZ keep mask of ``w`` blocked along axis -2."""
    return dbb.topk_block_mask(w.transpose(-2, -1), cfg).transpose(-2, -1)


def _group_masks(g: tree.Group, cfg: dbb.DBBConfig) -> list:
    if g.stacked and g.pieces[0].ndim == 1:  # blocked along the layer axis
        return list(torch.unbind(_block_mask(torch.stack(g.pieces), cfg), dim=0))
    return [_block_mask(p, cfg) for p in g.pieces]


def wdbb_masks(params, cfg: dbb.DBBConfig, predicate=None):
    """Boolean keep-mask tree (True = keep), shaped like ``params``: the
    Top-NNZ of every eligible leaf's blocks, all-True elsewhere."""

    def one(g):
        if not _eligible(g, cfg, predicate):
            return [torch.ones(p.shape, dtype=torch.bool, device=p.device) for p in g.pieces]
        return _group_masks(g, cfg)

    return tree.map_groups(one, params)


def prune_weights(params, cfg: dbb.DBBConfig, predicate=None):
    """Block-local magnitude pruning of every eligible leaf (the rules of
    :func:`wdbb_masks`); other leaves pass through."""

    def one(g):
        if not _eligible(g, cfg, predicate):
            return list(g.pieces)
        return [torch.where(m, p, torch.zeros_like(p))
                for m, p in zip(_group_masks(g, cfg), g.pieces)]

    return tree.map_groups(one, params)


def apply_masks(params, masks):
    """Zero the masked-off weights (mask True = keep); a leaf whose mask
    has another shape passes through."""
    return tree.tree_map(
        lambda w, m: torch.where(m, w, torch.zeros_like(w)) if m.shape == w.shape else w,
        params, masks,
    )

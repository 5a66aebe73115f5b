"""int8 gradient compression with error feedback (port of
``repro.train.compression``): per-tensor symmetric quantization over
``core/quant.py``, the quantization residual carried to the next step.

The reference quantizes each of its leaves with one scale, and a
per-layer leaf is all ``L`` layers at once.  So the port's per-layer
pieces of one stacked leaf share one scale, from their joint amax
(``core/tree.py``); a compressed tree holds ``(q, scale)`` per piece, the
pieces of a group sharing the scale tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant, tree


def quantize(g: torch.Tensor):
    """``g -> (int8 q, f32 scale)``, symmetric, per tensor."""
    return quant.quantize(g)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return quant.dequantize(q, scale)


def _quantize_group(pieces):
    """Every piece quantized with the one scale of the whole group."""
    amax = torch.stack([p.abs().amax() for p in pieces])
    scale = quant.symmetric_scale(amax)  # the amax of the amaxes is the group's
    return [(torch.clamp(torch.round(p / scale), -quant.QMAX, quant.QMAX).to(torch.int8), scale)
            for p in pieces]


def compress_tree(grads, residuals):
    """Error feedback, then quantization of each of the reference's leaves:
    ``(tree of (q, scale), new residuals)``."""

    def one(g, r_pieces):
        gf = [p.float() + r for p, r in zip(g.pieces, r_pieces)]
        qs = _quantize_group(gf)
        return [(qs_i, x - dequantize(*qs_i)) for qs_i, x in zip(qs, gf)]

    both = tree.map_groups(one, grads, residuals)
    return (tree.tree_map(lambda pair: pair[0], both),
            tree.tree_map(lambda pair: pair[1], both))


def decompress_tree(qtree):
    return tree.tree_map(lambda qs: dequantize(*qs), qtree)


def init_residuals(params):
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

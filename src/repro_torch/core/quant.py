"""Symmetric INT8 quantization (port of ``repro.core.quant``).

``q = clip(round(x / s), ±127)`` with ``s = amax / 127`` in float32 and
``s = 1`` for an all-zero slice.  ``torch.round`` rounds half to even,
like ``jnp.round``, so codes and scales are bit-identical to the
reference.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

QMAX = 127.0

Axis = Union[None, int, Sequence[int]]


def _norm_axes(axis, ndim: int):
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % ndim for a in axis)


def symmetric_scale(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """Scale ``amax / 127`` reduced over ``axis`` (None = whole tensor)."""
    xa = x.float().abs()
    if axis is None:
        amax = xa.amax()
    else:
        amax = xa.amax(dim=_norm_axes(axis, x.ndim))
    # a tensor divisor: ATen's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is one ulp off amax / 127 in places
    return torch.where(amax > 0, amax / torch.full_like(amax, QMAX), torch.ones_like(amax))


def quantize(x: torch.Tensor, axis: Axis = None):
    """``x -> (int8 q, f32 scale)``; ``axis`` names the axes the scale is
    shared over (None = per-tensor scalar)."""
    scale = symmetric_scale(x, axis)
    s_b = scale
    if axis is not None:
        for a in sorted(_norm_axes(axis, x.ndim)):
            s_b = s_b.unsqueeze(a)
    q = torch.clamp(torch.round(x.float() / s_b), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, axis: Axis = None,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``q * scale`` re-broadcast over ``axis``."""
    s_b = scale
    if axis is not None:
        for a in sorted(_norm_axes(axis, q.ndim)):
            s_b = s_b.unsqueeze(a)
    return (q.float() * s_b).to(dtype)


def quantize_rows(x: torch.Tensor):
    """``x [..., D] -> (int8 [..., D], f32 scale [...])``: one scale per row
    (the KV-cache write helper)."""
    return quantize(x, axis=-1)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """Inverse of :func:`quantize_rows` (the KV-cache read helper)."""
    return dequantize(q, scale, axis=-1, dtype=dtype)

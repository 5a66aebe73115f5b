"""Fused matmul epilogues (port of ``repro.kernels.epilogue``).

The plain versions of the int8 matmuls drain their int32 accumulator
through :func:`apply_dequant_epilogue`; the CUDA kernels
(``csrc/dbb_matmul_int8.cu``) repeat the same operations in the same
order: ``float(acc) * (x_scale * w_scale)``, then ``+ bias``, then the
activation, then the cast to the output dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

ACTIVATIONS = (None, "relu", "silu", "gelu")

# jax.nn.gelu's tanh form: sqrt(2/pi) as a float64 cast to the input's
# dtype, and 0.044715 a weak-typed scalar, cast to it too
_GELU_C = math.sqrt(2 / math.pi)
_GELU_K = 0.044715
# XLA's f32 tanh on the CPU (Eigen's rational approximation, each step a
# fused multiply-add): the input clamped to +-_TANH_CLAMP, x itself below
# _TANH_TINY, else x * P(x^2) / Q(x^2)
_TANH_CLAMP = 7.99881172180175781
_TANH_TINY = 0.0004
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
           5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
           4.89352518554385e-03)


def sigmoid(y: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-y))``, each operation rounded to ``y``'s dtype: the
    reference's logistic as it lowers (negate, exp, add, divide), which in
    bf16 rounds after every step (``torch.sigmoid`` rounds once, one bf16
    ulp apart on about half the values); the CUDA epilogues compute it in
    this order too.  Four launches on the card (``torch.sigmoid``: one)."""
    return torch.reciprocal(torch.exp(-y) + 1.0)


@functools.lru_cache(maxsize=None)
def _as(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float (exact in ``dtype``,
    so ATen's scalar arithmetic on it rounds once, as a tensor would)."""
    return torch.tensor(v, dtype=torch.float64).to(dtype).item()


def _tanh_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``tanh`` on the CPU, bit for bit: each fused multiply-add
    in float64 (the f32 product is exact there) rounded to f32 once."""
    x = torch.clamp(y, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = (x * x).double()

    def horner(coeffs):
        acc = torch.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            acc = (x2 * acc.double() + _as(c, torch.float32)).float()
        return acc

    return torch.where(y.abs() < _TANH_TINY, y, (x * horner(_TANH_P)) / horner(_TANH_Q))


def gelu(y: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(y, approximate=True)`` as it lowers: ``y * (0.5 * (1 +
    tanh(c * (y + k * ((y * y) * y)))))``, each operation rounded to
    ``y``'s dtype (``y ** 3`` is ``(y * y) * y``, the integer power's
    lowering) and ``c``, ``k`` rounded to it first.  In bf16 ``tanh`` is
    ATen's (f32 inside, rounded once), which equals XLA's there; in f32
    it is :func:`_tanh_f32`.  ``F.gelu(approximate="tanh")`` rounds once,
    one bf16 ulp apart on 44% of unit-normal values, and a Python 0.044715
    unrounded leaves 0.2% apart.  Nine launches on the card in bf16
    (``F.gelu``: one); the CUDA epilogues compute it in f32 in this order
    with ``tanhf``."""
    c, k = _as(_GELU_C, y.dtype), _as(_GELU_K, y.dtype)
    inner = c * (y + k * ((y * y) * y))
    t = _tanh_f32(inner) if y.dtype == torch.float32 else torch.tanh(inner)
    return y * (0.5 * (1.0 + t))


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """A named activation, dtype-preserving (gelu is the tanh form)."""
    if act is None:
        return y
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "silu":
        return y * sigmoid(y)
    if act == "gelu":
        return gelu(y)
    raise ValueError(f"unknown epilogue activation {act!r}; one of {ACTIVATIONS}")


def apply_epilogue(acc_f32: torch.Tensor, bias: Optional[torch.Tensor],
                   act: Optional[str]) -> torch.Tensor:
    """``act(acc + bias)`` on the float32 accumulator."""
    if bias is not None:
        acc_f32 = acc_f32 + bias.float()
    return apply_act(acc_f32, act)


def apply_dequant_epilogue(acc_i32: torch.Tensor, scale: torch.Tensor,
                           bias: Optional[torch.Tensor],
                           act: Optional[str]) -> torch.Tensor:
    """INT8-path epilogue ``act(float(acc) * scale + bias)``; ``scale`` is
    the combined ``x_scale * w_scale`` (``[1, N]`` or ``[M, N]``)."""
    return apply_epilogue(acc_i32.float() * scale.float(), bias, act)

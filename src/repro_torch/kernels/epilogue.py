"""Fused matmul epilogues (port of ``repro.kernels.epilogue``).

The plain versions of the int8 matmuls drain their int32 accumulator
through :func:`apply_dequant_epilogue`; the CUDA kernels
(``csrc/dbb_matmul_int8.cu``) repeat the same operations in the same
order: ``float(acc) * (x_scale * w_scale)``, then ``+ bias``, then the
activation, then the cast to the output dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = (None, "relu", "silu", "gelu")


def sigmoid(y: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-y))``, each operation rounded to ``y``'s dtype: the
    reference's logistic as it lowers (negate, exp, add, divide), which in
    bf16 rounds after every step (``torch.sigmoid`` rounds once, one bf16
    ulp apart on about half the values); the CUDA epilogues compute it in
    this order too.  Four launches on the card (``torch.sigmoid``: one)."""
    return torch.reciprocal(torch.exp(-y) + 1.0)


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """A named activation, dtype-preserving (gelu is the tanh form)."""
    if act is None:
        return y
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "silu":
        return y * sigmoid(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
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

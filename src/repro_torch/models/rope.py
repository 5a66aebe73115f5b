"""Rotary position embeddings (port of ``repro.models.rope``, standard RoPE)."""

from __future__ import annotations

import torch


def _inv_freq(dh: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))


def rope_cos_sin(pos: torch.Tensor, dh: int, theta: float):
    """pos ``[..., S]`` int -> cos/sin ``[..., S, dh//2]`` float32."""
    freqs = pos.float()[..., None] * _inv_freq(dh, theta, pos.device)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, H, D]`` with cos/sin ``[B, S, D//2]`` (shared by the heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)

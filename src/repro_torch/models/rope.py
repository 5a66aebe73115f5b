"""Position encodings (port of ``repro.models.rope``): standard RoPE,
M-RoPE (Qwen2-VL) and whisper's fixed sinusoidal table."""

from __future__ import annotations

import math

import torch


def _inv_freq(dh: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))


def rope_cos_sin(pos: torch.Tensor, dh: int, theta: float):
    """pos ``[..., S]`` int -> cos/sin ``[..., S, dh//2]`` float32."""
    freqs = pos.float()[..., None] * _inv_freq(dh, theta, pos.device)
    return torch.cos(freqs), torch.sin(freqs)


def mrope_cos_sin(pos3: torch.Tensor, dh: int, theta: float, sections):
    """M-RoPE (Qwen2-VL §2.1): three position streams (t, h, w), each
    frequency index taking the stream its section names.

    ``pos3 [3, B, S]``; ``sections`` sum to ``dh // 2`` (e.g. (16, 24,
    24) for dh=128).  Returns cos/sin ``[B, S, dh//2]``: the reference's
    one-hot sum adds exact zeros, so a select of each section's slice is
    the same bits."""
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to dh // 2 = {dh // 2}")
    cos_all, sin_all = rope_cos_sin(pos3, dh, theta)  # [3, B, S, dh//2]

    def select(t):
        return torch.cat([part[i] for i, part in enumerate(t.split(list(sections), dim=-1))],
                         dim=-1)

    return select(cos_all), select(sin_all)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, H, D]`` with cos/sin ``[B, S, D//2]`` (shared by the heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(n_pos: int, d: int, device="cpu") -> torch.Tensor:
    """Whisper's fixed sinusoidal table ``[n_pos, d]`` (float32): ``sin``
    then ``cos`` of ``pos * exp(-log(1e4) * i / (d/2 - 1))``."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

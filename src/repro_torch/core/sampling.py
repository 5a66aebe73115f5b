"""Sampling (port of ``repro.core.sampling``), greedy only in this slice.

``temperature > 0`` raises ``NotImplementedError`` until the reference's
threefry key derivation is ported (ROADMAP queue 1, item 6): a sampled
token must agree with the reference under the same (seed, position)
keys, so no other generator may stand in for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def validate_sampling(temperature, top_k, top_p, seed=0, where="sampling"):
    """Reject malformed sampling knobs, and sampled decoding, at
    construction time."""
    t = float(temperature)
    if math.isnan(t) or math.isinf(t) or t < 0:
        raise ValueError(
            f"{where}: temperature must be finite and >= 0, got {temperature!r}"
        )
    if top_k is not None:
        if int(top_k) != top_k or int(top_k) < 1:
            raise ValueError(
                f"{where}: top_k must be an int >= 1 (or None to disable), "
                f"got {top_k!r}"
            )
    p = float(top_p)
    if math.isnan(p) or not (0.0 < p <= 1.0):
        raise ValueError(f"{where}: top_p must satisfy 0 < top_p <= 1, got {top_p!r}")
    if int(seed) != seed or int(seed) < 0:
        raise ValueError(f"{where}: seed must be an int >= 0, got {seed!r}")
    if t > 0:
        raise NotImplementedError(
            f"{where}: temperature={temperature!r} needs the threefry sampler, "
            "not yet ported (ROADMAP queue 1, item 6); use temperature=0"
        )


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (greedy in this slice)."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        validate_sampling(
            self.temperature, self.top_k, self.top_p, self.seed,
            where="SamplingParams",
        )


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token per row of ``logits [B, V]`` (already sliced to the
    real vocab): the first maximal index, like ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)

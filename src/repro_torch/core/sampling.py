"""Seeded categorical sampling (port of ``repro.core.sampling``) — the one
sampler every serving path runs: the continuous mixed step, the decode
loop (``lm.paged_decode_loop``), and the one-shot and stepped engines.

Per-row keys are ``fold_in(PRNGKey(seed), position)``, ``position`` being
the fed-stream position of the token whose logits are sampled, on a
bit-for-bit copy of jax's threefry2x32 (``core/prng.py``).  So a row's
token depends on its logits, its knobs and its position only: sampled
output is batch-, ``decode_block``- and preemption-invariant, and equals
the reference's wherever the logits and the float draws agree.

``temperature == 0`` is the plain argmax.  The reference skips the
sampling math with a ``lax.cond`` when no row samples; the port's callers
decide that on the host, from the plan's numpy knobs, and call
:func:`greedy_tokens` (no device value is read to decide).  Sorting,
softmax, cumsum and argmax are plain PyTorch, as the reference samples
outside any kernel.  On CUDA the softmax sum and the cumulative sum run
in float64 and round once: the library picks a reduction's order from
the shapes, and float64 keeps a row's result independent of its batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import prng

# on-device encoding of "no top-k filter" (SamplingParams uses None)
TOP_K_DISABLED = 0


def validate_sampling(temperature, top_k, top_p, seed=0, where="sampling"):
    """Reject malformed sampling knobs at construction time."""
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


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: ``temperature=0`` is exact greedy argmax,
    ``top_k=None`` and ``top_p=1.0`` disable their filters, ``seed`` is
    the base key the per-position keys fold into."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        validate_sampling(
            self.temperature, self.top_k, self.top_p, self.seed,
            where="SamplingParams",
        )

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax token per row of ``logits [B, V]`` (the first maximal index,
    like ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _reduce_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.device.type == "cuda" else torch.float32


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    s = e.to(_reduce_dtype(e)).sum(dim=-1, keepdim=True).float()
    return e / s


def _sample_rows(logits, temps, top_ks, top_ps, seeds, positions) -> torch.Tensor:
    """``_sample_row`` of the reference over every row at once."""
    v = logits.shape[-1]
    scaled = logits.float() / torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    # top-k: threshold at the k-th largest scaled logit (0 = disabled);
    # ties at the threshold are all kept
    k = torch.where(top_ks > 0, torch.clamp_max(top_ks, v), torch.full_like(top_ks, v))
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, (k - 1).long()[:, None])
    neg_inf = torch.tensor(-math.inf, dtype=torch.float32, device=logits.device)
    masked = torch.where(scaled < kth, neg_inf, scaled)
    # top-p over the top-k survivors: keep the smallest prefix of the
    # probability-sorted tokens whose cumulative mass reaches p
    probs = _softmax(masked)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp.to(_reduce_dtype(sp)), dim=-1).float()
    cut = (csum < top_ps[:, None]).sum(dim=-1)
    thr = torch.gather(sp, 1, torch.clamp_max(cut, v - 1)[:, None])
    masked = torch.where(probs < thr, neg_inf, masked)
    # categorical: argmax of gumbel noise plus the filtered logits
    key = prng.fold_in(prng.prng_key(seeds), positions)
    return torch.argmax(prng.gumbel(key, v) + masked, dim=-1).to(torch.int32)


def sample_tokens(logits, temps, top_ks, top_ps, seeds, positions) -> torch.Tensor:
    """One token per row of raw (pre-temperature) ``logits [B, V]``,
    already sliced to the real vocab.  ``temps/top_ps`` are ``[B]`` f32,
    ``top_ks`` ``[B]`` int (0 = disabled), ``seeds`` ``[B]`` uint32 values
    in an integer tensor, ``positions`` ``[B]`` each row's fed-stream
    position (negative padding positions clamp to 0; their tokens are
    never read).  Rows with ``temp == 0`` return the plain argmax.  Only
    enqueues device work: callers whose rows are all greedy call
    :func:`greedy_tokens` instead, deciding on the host."""
    greedy = greedy_tokens(logits)
    pos = torch.clamp_min(positions.long(), 0)
    drawn = _sample_rows(logits, temps.float(), top_ks.long(), top_ps.float(),
                         seeds.long(), pos)
    return torch.where(temps > 0, drawn, greedy)


def device_sampling(temps, top_ks, top_ps, seeds, device) -> Optional[tuple]:
    """The rows' knobs (host numpy ``[B]`` arrays) as the device tuple
    ``(temps, top_ks, top_ps, seeds)``, or None when every row is greedy:
    the host-side short-circuit of the reference's ``lax.cond``."""
    if not (temps > 0).any():
        return None
    return tuple(torch.tensor(a, dtype=dt, device=device) for a, dt in (
        (temps, torch.float32), (top_ks, torch.int64), (top_ps, torch.float32),
        (seeds.astype("int64"), torch.int64)))


def sample_or_greedy(logits: torch.Tensor, sampling: Optional[tuple],
                     positions: torch.Tensor) -> torch.Tensor:
    """The shared sampler over ``sampling``'s knobs, or the argmax when
    it is None."""
    if sampling is None:
        return greedy_tokens(logits)
    return sample_tokens(logits, *sampling, positions)

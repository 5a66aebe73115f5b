"""jax's threefry2x32 PRNG, bit for bit, over torch tensors.

The sampler keys every draw on ``fold_in(PRNGKey(seed), position)``
(``core/sampling.py``), so a sampled token agrees with the reference only
if the keys, the random bits and the float draws built on them are
jax's own.  This module re-derives them from jax 0.9.0's definitions:

* ``PRNGKey(seed)`` — ``threefry_seed``: a 32-bit seed is the key
  ``(0, seed)``;
* ``fold_in(key, data)`` — ``threefry_2x32(key, threefry_seed(data))``;
* ``random_bits(key, n)`` — the *partitionable* layout
  (``jax_threefry_partitionable=True``): counters ``(hi=0, lo=i)`` for the
  flat index ``i``, 32-bit output ``bits1 ^ bits2``;
* ``uniform``/``gumbel`` — ``jax.random._uniform``'s mantissa trick and
  ``_gumbel``'s ``"low"`` mode, in float32.

Every uint32 lives in an int64 tensor masked to 32 bits after each add
(the rotate and xor keep it there), which works alike on the CPU and on
CUDA.  Keys are ``(k0, k1)`` pairs of int64 tensors of any common shape,
so one call derives a key per row.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counter words ``(x0, x1)`` under key
    ``(k0, k1)`` (20 rounds, five key injections), each a uint32 in int64;
    key and counter words broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: torch.Tensor):
    """``jax.random.PRNGKey(seed)`` for uint32 seeds: ``(0, seed)``."""
    seed = _u32(seed)
    return torch.zeros_like(seed), seed


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in(key, uint32(data))``: the hash of the counter
    pair ``(0, data)`` under ``key``."""
    k0, k1 = key
    data = _u32(data)
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def random_bits(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: ``[..., n]`` uint32
    values in int64, the partitionable counter layout."""
    k0, k1 = key
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(lo), lo)
    return b0 ^ b1


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled
    and shifted in float32, and floored at ``minval``."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key, in jax's default
    ``"low"`` mode: ``-log(-log(u))`` with ``u`` uniform on
    ``[tiny, 1)``."""
    u = uniform(key, n, minval=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))

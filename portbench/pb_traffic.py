"""The one traffic generator: a mix file's parameters in, rounds of
requests out.

A round is ``round_size`` requests submitted at once.  Its sizes are a
fixed set: the prompt and output lengths sit at the mid-quantiles of
their distributions, paired by ``pairing_seed``, and each round takes
them in an order drawn from ``pairing_seed`` and the round's index.  The
run's seed draws the token ids alone.  So every seed gives the same
schedule of the same work (the scheduler sees only sizes; random prompts
share no prefix), and runs differ by noise, not by what they serve.
"""

from __future__ import annotations

import math

import numpy as np


def quantiles(spec: dict, n: int) -> list:
    """``n`` lengths at the mid-quantiles ``(i + 1/2) / n`` of ``spec``."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "loguniform":
        a, b = math.log(lo), math.log(hi)
        return [int(round(math.exp(a + (i + 0.5) / n * (b - a)))) for i in range(n)]
    if spec["dist"] == "uniform":
        return [int(round(lo + (i + 0.5) / n * (hi - lo))) for i in range(n)]
    if spec["dist"] == "fixed":
        return [int(lo)] * n
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def round_shapes(mix: dict) -> list:
    """The round's ``(prompt_len, output_len)`` pairs, the same every run."""
    n = mix["round_size"]
    prompts = quantiles(mix["prompt_len"], n)
    outs = quantiles(mix["output_len"], n)
    perm = np.random.default_rng(mix["pairing_seed"]).permutation(n)
    return [(prompts[i], outs[int(perm[i])]) for i in range(n)]


def seed_bits(seed: int) -> int:
    """Any whole number as a non-negative 63-bit seed."""
    return int(seed) % (1 << 63)


class Rounds:
    """Rounds of requests for one run: ``next()`` -> ``(prompts, outputs)``,
    the prompts int32 token arrays drawn uniformly from ``[0, vocab)``."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.shapes = round_shapes(mix)
        self.pairing_seed = mix["pairing_seed"]
        self.vocab = vocab
        self.rng = np.random.default_rng(seed_bits(seed))
        self.index = 0

    def next(self):
        order = np.random.default_rng([self.pairing_seed, self.index]).permutation(len(self.shapes))
        self.index += 1
        prompts, outs = [], []
        for i in order:
            p, o = self.shapes[int(i)]
            prompts.append(self.rng.integers(0, self.vocab, size=p, dtype=np.int32))
            outs.append(o)
        return prompts, outs

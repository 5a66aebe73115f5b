"""Port parity, sampler: ``repro_torch.core.prng`` (jax's threefry2x32)
and ``repro_torch.core.sampling`` against jax 0.9.0 and
``repro.core.sampling`` on the same inputs.

Keys and random bits are held bit for bit over seeds {0, 1, 2^31-1,
2^32-1} and positions {0, 1, 1023, 40000}, uniform draws bit for bit.
Gumbel draws are held within 2^-22 of max(1, |g|): XLA's CPU ``log`` is a
polynomial approximation one ulp off ATen's on about 14% of f32 inputs,
and ``-log(-log(u))`` turns that ulp of the inner log into an absolute
error of about 2^-23 near g = 0.  Tokens are compared for equality on
pinned numpy logits: only a near-tie of ``gumbel + logits`` could part
them.  The unit tests mirror ``tests/test_sampling.py``'s (its goldens
fail in the reference itself and are not mirrored)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsampling
from repro_torch.core import prng
from repro_torch.core.sampling import (
    SamplingParams,
    greedy_tokens,
    sample_tokens,
)
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

SEEDS = (0, 1, 2**31 - 1, 2**32 - 1)
POSITIONS = (0, 1, 1023, 40000)
TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.uint32(pos))


def _tkey(seed, pos):
    return prng.fold_in(prng.prng_key(torch.tensor(seed)), torch.tensor(pos))


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_bit_for_bit(seed, pos):
    """``PRNGKey``, ``fold_in`` and the partitionable 32-bit random bits."""
    jk = jax.random.PRNGKey(np.uint32(seed))
    tk = prng.prng_key(torch.tensor(seed))
    assert [int(tk[0]), int(tk[1])] == np.asarray(jax.random.key_data(jk)).tolist()
    jf, tf = _jkey(seed, pos), _tkey(seed, pos)
    assert [int(tf[0]), int(tf[1])] == np.asarray(jax.random.key_data(jf)).tolist()
    want = np.asarray(jax.random.bits(jf, (1001,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(tf, 1001).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_gumbel(seed):
    """Uniform bit for bit (the mantissa trick is integer work and one
    exact f32 subtraction); gumbel within the bound of the docstring."""
    for pos in POSITIONS:
        jf, tf = _jkey(seed, pos), _tkey(seed, pos)
        for lo in (0.0, TINY):
            want = np.asarray(jax.random.uniform(jf, (2048,), jnp.float32, minval=lo, maxval=1.0))
            np.testing.assert_array_equal(prng.uniform(tf, 2048, minval=lo).numpy(), want)
        want = np.asarray(jax.random.gumbel(jf, (2048,), jnp.float32))
        got = prng.gumbel(tf, 2048).numpy()
        assert np.all(np.abs(got - want) <= 2.0**-22 * np.maximum(1.0, np.abs(want)))
        # the inner -log(u), where the one ulp comes from
        u = np.asarray(jax.random.uniform(jf, (2048,), jnp.float32, minval=TINY, maxval=1.0))
        inner_j = np.asarray(-jnp.log(jnp.asarray(u)))
        inner_t = (-torch.log(torch.tensor(u))).numpy()
        ulps = np.abs(inner_j.view(np.int32).astype(np.int64) - inner_t.view(np.int32))
        assert ulps.max() <= 1


def _args(b, temp=0.7, top_k=0, top_p=1.0, seed=0, pos=5):
    return (np.full((b,), temp, np.float32), np.full((b,), top_k, np.int32),
            np.full((b,), top_p, np.float32), np.full((b,), seed, np.uint32),
            np.full((b,), pos, np.int32))


def _port(logits, temps, top_ks, top_ps, seeds, pos):
    return sample_tokens(torch.from_numpy(logits), torch.from_numpy(temps),
                         torch.from_numpy(top_ks), torch.from_numpy(top_ps),
                         torch.from_numpy(seeds.astype(np.int64)),
                         torch.from_numpy(pos)).numpy()


def _ref(logits, *rows):
    return np.asarray(jsampling.sample_tokens(jnp.asarray(logits), *map(jnp.asarray, rows)))


def _mixed_rows(rng, b):
    return (rng.choice([0.0, 0.7, 1.3], size=b).astype(np.float32),
            rng.choice([0, 1, 5, 50], size=b).astype(np.int32),
            rng.choice([1.0, 0.9, 0.5, 1e-9], size=b).astype(np.float32),
            rng.integers(0, 2**32, size=b, dtype=np.uint64).astype(np.uint32),
            rng.integers(-1, 50000, size=b).astype(np.int32))


SAMPLE_CASES = {  # fixed ids for xdist
    "temperature": lambda rng, b: _args(b, temp=0.7, seed=11),
    "top_k": lambda rng, b: _args(b, temp=1.2, top_k=8, seed=2**31 + 5, pos=1023),
    "top_p": lambda rng, b: _args(b, temp=0.9, top_p=0.8, seed=2**32 - 1, pos=40000),
    "top_k_top_p": lambda rng, b: _args(b, temp=0.8, top_k=50, top_p=0.95, seed=3),
    "mixed_rows": _mixed_rows,
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_tokens_match_reference(case):
    """The reference's tokens on the same f32 logits, 16 pinned draws of
    8 rows over a vocab of 500."""
    rng = np.random.default_rng(list(SAMPLE_CASES).index(case))
    for trial in range(16):
        logits = (rng.normal(size=(8, 500)) * 3).astype(np.float32)
        rows = SAMPLE_CASES[case](rng, 8)
        rows = rows[:4] + ((rows[4] + trial).astype(np.int32),)
        np.testing.assert_array_equal(_port(logits, *rows), _ref(logits, *rows))


def test_sample_tokens_top_k_one_and_tiny_top_p_match_reference_argmax():
    logits = np.random.default_rng(2).normal(size=(6, 64)).astype(np.float32)
    greedy = logits.argmax(-1)
    for kw in (dict(top_k=1), dict(top_p=1e-9)):
        np.testing.assert_array_equal(_port(logits, *_args(6, **kw)), greedy)
        np.testing.assert_array_equal(_ref(logits, *_args(6, **kw)), greedy)


# ------------------------------------------ mirrors of test_sampling.py


def test_sample_tokens_zero_temperature_is_argmax():
    logits = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    np.testing.assert_array_equal(_port(logits, *_args(4, temp=0.0)), logits.argmax(-1))
    np.testing.assert_array_equal(greedy_tokens(torch.from_numpy(logits)).numpy(),
                                  logits.argmax(-1))


def test_sample_tokens_deterministic_and_position_keyed():
    logits = np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32)
    a = _port(logits, *_args(8, pos=5))
    np.testing.assert_array_equal(a, _port(logits, *_args(8, pos=5)))
    assert not np.array_equal(a, _port(logits, *_args(8, pos=6)))
    assert not np.array_equal(a, _port(logits, *_args(8, seed=1, pos=5)))


def test_sample_tokens_top_k_masks_tail():
    """With top_k=2 every draw lands on one of the two largest logits."""
    logits = np.random.default_rng(3).normal(size=(16, 64)).astype(np.float32)
    top2 = np.argsort(logits, axis=-1)[:, -2:]
    for pos in range(8):
        toks = _port(logits, *_args(16, temp=2.0, top_k=2, pos=pos))
        for r in range(16):
            assert toks[r] in top2[r]


def test_sample_tokens_rows_are_independent():
    """A greedy row co-batched with sampled rows returns its argmax, and a
    sampled row's token does not depend on its neighbours."""
    logits = np.random.default_rng(4).normal(size=(3, 64)).astype(np.float32)
    _, top_ks, top_ps, seeds, pos = _args(3)
    temps = np.asarray([0.0, 0.9, 0.0], np.float32)
    mixed = _port(logits, temps, top_ks, top_ps, seeds, pos)
    greedy = logits.argmax(-1)
    assert mixed[0] == greedy[0] and mixed[2] == greedy[2]
    solo = _port(logits[1:2], *(a[1:2] for a in (temps, top_ks, top_ps, seeds, pos)))
    assert mixed[1] == solo[0]


def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(temperature=float("nan")),
                dict(temperature=float("inf")), dict(top_k=0), dict(top_k=-3),
                dict(top_p=0.0), dict(top_p=1.5), dict(top_p=float("nan")), dict(seed=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    for bad in (dict(temperature=-1.0), dict(top_k=0), dict(top_p=2.0)):
        with pytest.raises(ValueError):
            tengine.ServeConfig(**bad)
    SamplingParams(temperature=0.0, top_k=1, top_p=1.0, seed=0)
    scfg = tengine.ServeConfig(temperature=0.7, top_k=8, top_p=0.9, seed=123)
    assert scfg.sampling_params == SamplingParams(0.7, 8, 0.9, 123)

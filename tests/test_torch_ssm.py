"""Port parity, the ``ssm`` family (mamba2-130m): ``ssm.mamba2_forward``
in both branches (the chunked SSD scan and the O(1) recurrent step)
against ``repro.models.ssm``'s on the same converted weights, and the
LM and the stepped engine over it against ``repro.models.lm`` and the
reference engine, at ``_torch_parity.SMALL`` (the smoke's SSM: 4 heads of
32, state 16, conv 4).

Tolerances: in f32, outputs and caches at atol 1e-4 (``test_torch_ring``'s
logits bound) and decode == forward at 5e-4 (``tests/test_models.py``'s);
in bf16, 2e-2 of the output's scale (``tests/test_kernels.py``'s bf16
kernel bound): both sides round the same model-dtype tensors, and differ
only where a sum's order moves a bf16 rounding.  The bf16 cases run
without DAP (``dense``, ``wdbb``): with it a one-ulp difference can flip
a top-4 selection of ``out_proj``'s input and move an output by far more
than an ulp (ROADMAP queue 3, "With DAP"); DAP is held in f32.  Engine
tokens are compared for equality on pinned greedy cases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    GEN_S0,
    check_config_fields,
    chip_smoke_module,
    effective,
    gen_prompts,
    generate_match,
    reference_params,
    small_cfgs,
    stepped_plain_calls,
    to_np,
)
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ARCH = "mamba2_130m"
BF16_TOL = 2e-2
_WEIGHTS = {}


def weights():
    if ARCH not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(ARCH)
        _WEIGHTS[ARCH] = (jcfg, tcfg) + reference_params(jcfg, seed=0)
    return _WEIGHTS[ARCH]


@pytest.mark.parametrize("smoke", [False, True])
def test_mamba2_config_matches_reference(smoke):
    check_config_fields(ARCH, smoke)


def _mixer(dtype, chunk=None, mode="awdbb"):
    """A mixer's reference params and their conversion, the configs in
    ``dtype`` (and ``chunk``, sparsity ``mode``)."""
    jcfg, tcfg = small_cfgs(ARCH, dtype=dtype)
    over = {"sparsity": dataclasses.replace(jcfg.sparsity, mode=mode)}
    if chunk is not None:
        over["ssm"] = dataclasses.replace(jcfg.ssm, chunk=chunk)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    jp, _ = jssm.make_mamba2(jax.random.PRNGKey(3), jcfg, jnp.dtype(dtype))
    # non-trivial A, D and dt_bias (the init draws -1, 1 and 0)
    rng = np.random.default_rng(5)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    nh = np_p["A_log"].shape[0]
    np_p["A_log"] = rng.normal(size=nh).astype(np.float32) * 0.5
    np_p["D"] = rng.normal(size=nh).astype(np.float32)
    np_p["dt_bias"] = rng.normal(size=nh).astype(np.float32) * 0.5
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    return jcfg, tcfg, jp, params_from_numpy(np_p)


def _input(jcfg, b, s, dtype, seed=0):
    u = np.random.default_rng(seed).normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    ju = jnp.asarray(u).astype(jnp.dtype(dtype))
    return ju, torch.from_numpy(np.array(ju.astype(jnp.float32))).to(getattr(torch, dtype))


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_TOL * np.abs(want).max(), rtol=0)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


MIXER_CASES = [("float32", "wdbb"), ("float32", "awdbb"), ("bfloat16", "dense"),
               ("bfloat16", "wdbb")]


@pytest.mark.parametrize("dtype,mode", MIXER_CASES)
def test_mamba2_chunked_matches_reference(dtype, mode):
    """The chunked scan at S = 20 over chunks of 8 (two whole chunks and an
    end-padded one)."""
    jcfg, tcfg, jp, tp = _mixer(dtype, chunk=8, mode=mode)
    ju, tu = _input(jcfg, 2, 20, dtype)
    want, _ = jssm.mamba2_forward(jp, ju, jcfg)
    got = tssm.mamba2_forward(tp, tu, tcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == tuple(want.shape)
    _close(to_np(got.float()), _f32(want), dtype)


@pytest.mark.parametrize("dtype,mode", MIXER_CASES)
def test_mamba2_decode_matches_reference(dtype, mode):
    """Ten recurrent steps from the zero cache: each step's output, and the
    state and conv ring after the last, written in place."""
    jcfg, tcfg, jp, tp = _mixer(dtype, mode=mode)
    ju, tu = _input(jcfg, 2, 10, dtype, seed=1)
    jc = jax.tree_util.tree_map(lambda a: a[0], jssm.make_ssm_cache(2, jcfg, 1, jnp.dtype(dtype)))
    tc = {k: v[0] for k, v in tssm.make_ssm_cache(2, tcfg, 1, getattr(torch, dtype),
                                                  "cpu").items()}
    for t in range(10):
        want, jc = jssm.mamba2_forward(jp, ju[:, t:t + 1], jcfg, cache_layer=jc)
        got = tssm.mamba2_forward(tp, tu[:, t:t + 1], tcfg, cache_layer=tc)
        _close(to_np(got.float()), _f32(want), dtype)
    assert tc["conv"].dtype == getattr(torch, dtype) and tc["state"].dtype == torch.float32
    _close(to_np(tc["state"]), _f32(jc["state"]), dtype)
    _close(to_np(tc["conv"].float()), _f32(jc["conv"]), dtype)


def test_mamba2_chunk_invariance():
    """The port's SSD output does not depend on the chunk size (4, 8, 16:
    an algebraic identity), and each equals the reference's at its chunk."""
    jcfg0, tcfg0, params, tparams = weights()
    toks = gen_prompts(jcfg0.vocab, b=2, s0=16, seed=4)
    outs = []
    for chunk in (4, 8, 16):
        jcfg = dataclasses.replace(jcfg0, ssm=dataclasses.replace(jcfg0.ssm, chunk=chunk))
        tcfg = dataclasses.replace(tcfg0, ssm=dataclasses.replace(tcfg0.ssm, chunk=chunk))
        got = to_np(tlm.forward(tparams, torch.from_numpy(toks), tcfg))
        want = np.asarray(jlm.forward(params, jnp.asarray(toks), jcfg)[0])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        outs.append(got)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-4)


@pytest.mark.parametrize("wire", [None, "native", "int8"])
def test_ssm_decode_matches_forward(wire):
    """Stepped ``decode_step`` over the ring reproduces the chunked
    ``forward`` (decode == forward, 5e-4), and each equals the reference's
    on the same (packed) weights, with the engine's effective config (the
    int8 wire's per-row activation scales); ``prefill`` with a cache
    returns ``forward``'s logits and leaves the state at zero."""
    jcfg, tcfg, params, tparams = weights()
    if wire is not None:
        jcfg, tcfg = effective(jcfg, tcfg, "native", wire)
        params = jengine.pack_params_for_serving(params, jcfg, wire)
        tparams = tengine.pack_params_for_serving(tparams, tcfg, wire)
    b, s = 2, 16
    toks = gen_prompts(jcfg.vocab, b=b, s0=s, seed=2)
    full = to_np(tlm.forward(tparams, torch.from_numpy(toks), tcfg))
    np.testing.assert_allclose(
        full, np.asarray(jlm.forward(params, jnp.asarray(toks), jcfg)[0]), atol=1e-4, rtol=0)
    cache = tlm.make_cache(tcfg, b, 64, "cpu")
    jcache = jlm.make_cache(jcfg, b, 64)
    assert set(cache) == set(jcache) == {"state", "conv"}
    # jitted: eager JAX over 16 steps takes most of this test's time
    j_decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jcfg))
    steps = []
    for t in range(s):
        lg, cache = tlm.decode_step(tparams, cache, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        jl, jcache = j_decode(params, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        np.testing.assert_allclose(to_np(lg), np.asarray(jl), atol=1e-4, rtol=0)
        steps.append(to_np(lg))
    assert np.abs(full - np.concatenate(steps, 1)).max() < 5e-4
    for name in ("state", "conv"):
        np.testing.assert_allclose(to_np(cache[name]), np.asarray(jcache[name]), atol=1e-4)
    logits, filled = tlm.prefill(tparams, torch.from_numpy(toks), tcfg,
                                 cache=tlm.make_cache(tcfg, b, 64, "cpu"))
    np.testing.assert_array_equal(to_np(logits), full)
    assert not filled["state"].any() and not filled["conv"].any()


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_ssm_engine_matches_reference(wire):
    """``Engine.generate`` steps (``auto`` -> stepped: ``prefill_calls ==
    S0``) and its greedy tokens equal the reference engine's on both
    wires, native KV."""
    got, teng = generate_match(*weights(), wire, "native", "stepped")
    assert got.shape[1] > GEN_S0
    jcfg, tcfg, params, tparams = weights()
    auto = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        max_seq=48, pack_weights=True, wire_dtype=wire), device="cpu")
    np.testing.assert_array_equal(auto.generate(gen_prompts(jcfg.vocab), got.shape[1] - GEN_S0),
                                  got)
    assert auto.prefill_calls == GEN_S0


def test_ssm_kv_int8_refused_and_paged_modes_raise():
    """``kv_dtype="int8"`` has no attention KV to quantize: the engine
    refuses it, as the reference's does; batched, continuous and the paged
    entry points raise "recurrent"."""
    jcfg, tcfg, params, tparams = weights()
    with pytest.raises(ValueError, match="no attention KV"):
        jengine.Engine(params, jcfg, jengine.ServeConfig(kv_dtype="int8"))
    with pytest.raises(ValueError, match="no attention KV"):
        tengine.Engine(tparams, tcfg, tengine.ServeConfig(kv_dtype="int8"), device="cpu")
    prompts = gen_prompts(tcfg.vocab, b=1, s0=4)
    for mode in ("batched", "continuous"):
        eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(max_seq=16, prefill_mode=mode),
                             device="cpu")
        with pytest.raises(ValueError, match="recurrent"):
            eng.generate(prompts, 1)
    toks = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="recurrent"):
        tlm.paged_step(tparams, {}, toks, toks, toks, tcfg)
    with pytest.raises(ValueError, match="recurrent"):
        tlm.paged_decode_loop(tparams, {}, toks[:, :1], toks[:, 0], toks, 1, tcfg, max_steps=1)


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_chip_smoke_recurrent_launches_per_pass(wire):
    """``chip_smoke.recurrent_launches``, what the card's mamba2 serves are
    held to, equals a small CPU engine's plain calls a stepped pass."""
    _, tcfg, _, tparams = weights()
    got, eng = stepped_plain_calls(tcfg, tparams, wire, "native")
    passes = eng.prefill_calls + eng.decode_calls
    want = chip_smoke_module().recurrent_launches(eng.cfg, wire)
    assert got == {name: want.get(name, 0) * passes for name in got}


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_chip_smoke_greedy_alone_equals_engine_row(wire):
    """``chip_smoke.greedy_alone``, the card's mamba2 request served alone
    through ``lm.decode_step``, gives the tokens a stepped engine gives
    that request's row of a batch, with finite logits."""
    _, tcfg, _, tparams = weights()
    _, eng = stepped_plain_calls(tcfg, tparams, wire, "native")
    prompts = gen_prompts(tcfg.vocab, b=2, s0=6)
    out = eng.generate(prompts, 3)
    alone, finite = chip_smoke_module().greedy_alone(torch, eng, prompts[1], 3)
    assert finite
    np.testing.assert_array_equal(alone, out[1])

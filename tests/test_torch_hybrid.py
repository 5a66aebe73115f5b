"""Port parity, the ``hybrid`` family (hymba-1.5b: GQA over a sliding
window beside a mamba2 mixer, the two branches mixed as ``0.5 *
(rmsnorm(attn) + rmsnorm(ssm))``): ``blocks.decoder_block``'s hybrid
branch, ``lm.make_cache``/``prefill``/``decode_step``/``forward`` and the
stepped engine against the reference's on the same converted weights, at
``_torch_parity.SMALL`` (the smoke's window of 32 and SSM of 4 heads).

Tolerances as in ``tests/test_torch_ring.py``: logits and float cache
planes at atol 1e-4, integer planes (int8 codes, slot positions) bit for
bit; decode == forward at 5e-4 (``tests/test_models.py``); engine tokens
equal on pinned greedy cases."""

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
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ARCH = "hymba_1_5b"
_WEIGHTS = {}
_JIT = {}


def jitted(jcfg):
    """The reference's ``prefill`` and ``decode_step``, jitted once per
    config (eager JAX takes minutes over 40 steps)."""
    if jcfg not in _JIT:
        _JIT[jcfg] = (
            jax.jit(lambda p, t, c: jlm.prefill(p, t, jcfg, cache=c)),
            jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jcfg)),
        )
    return _JIT[jcfg]


def weights():
    if ARCH not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(ARCH)
        _WEIGHTS[ARCH] = (jcfg, tcfg) + reference_params(jcfg, seed=0)
    return _WEIGHTS[ARCH]


def packed(wire, kv_dtype="native"):
    """The engine's effective configs and both sides' weights on ``wire``
    (None: dense)."""
    jcfg, tcfg, params, tparams = weights()
    jcfg, tcfg = effective(jcfg, tcfg, kv_dtype, wire or "native")
    if wire is not None:
        params = jengine.pack_params_for_serving(params, jcfg, wire)
        tparams = tengine.pack_params_for_serving(tparams, tcfg, wire)
    return jcfg, tcfg, params, tparams


def check_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in jcache:
        got, want = to_np(tcache[name]), np.asarray(jcache[name])
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("smoke", [False, True])
def test_hymba_config_matches_reference(smoke):
    check_config_fields(ARCH, smoke)


@pytest.mark.parametrize("wire", [None, "native", "int8"])
def test_hybrid_block_matches_reference(wire):
    """One hybrid decoder block, cache-less over 40 tokens (past the
    window of 32), on non-trivial A, D and dt_bias."""
    jcfg, tcfg = small_cfgs(ARCH)
    jcfg, tcfg = effective(jcfg, tcfg, "native", wire or "native")
    jp, _ = jblocks.make_decoder_block(jax.random.PRNGKey(4), jcfg, jnp.float32)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(6)
    for name, scale in (("A_log", 0.5), ("D", 1.0), ("dt_bias", 0.5)):
        np_p["ssm"][name] = (rng.normal(size=np_p["ssm"][name].shape) * scale).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    tp = params_from_numpy(np_p)
    if wire is not None:
        jp = jengine.pack_params_for_serving(jp, jcfg, wire)
        tp = tengine.pack_params_for_serving(tp, tcfg, wire)
    x = rng.normal(size=(2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    block = jax.jit(lambda p, x, pos: jblocks.decoder_block(p, x, jcfg, pos)[0])
    want = block(jp, jnp.asarray(x), jnp.asarray(pos))
    got = tblocks.decoder_block(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_hybrid_ring_matches_reference(wire, kv_dtype):
    """``prefill`` fills the attention ring as the reference's does and
    leaves ``ssm_state``/``ssm_conv`` at zero; stepped ``decode_step``
    (the prompt a token at a time, past the window) gives the reference's
    logits at every step and its cache; decode == forward (native KV)."""
    jcfg, tcfg, params, tparams = packed(wire, kv_dtype)
    b, s, max_seq = 2, 40, 48
    toks = gen_prompts(jcfg.vocab, b=b, s0=s, seed=8)
    j_prefill, j_decode = jitted(jcfg)
    jl, jfill = j_prefill(params, jnp.asarray(toks), jlm.make_cache(jcfg, b, max_seq))
    tl, tfill = tlm.prefill(tparams, torch.from_numpy(toks), tcfg,
                            cache=tlm.make_cache(tcfg, b, max_seq, "cpu"))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
    check_cache(tfill, jfill)
    assert not tfill["ssm_state"].any() and not tfill["ssm_conv"].any()
    jc, tc = jlm.make_cache(jcfg, b, max_seq), tlm.make_cache(tcfg, b, max_seq, "cpu")
    steps = []
    for t in range(s):
        jo, jc = j_decode(params, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        to, tc = tlm.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=1e-4, rtol=0)
        steps.append(to_np(to))
    check_cache(tc, jc)
    # the ring the fill wrote is the one stepping writes (slots, positions)
    np.testing.assert_array_equal(to_np(tfill["pos"]), to_np(tc["pos"]))
    if kv_dtype == "native":
        full = to_np(tlm.forward(tparams, torch.from_numpy(toks), tcfg))
        assert np.abs(full - np.concatenate(steps, 1)).max() < 5e-4


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_hybrid_engine_matches_reference(wire, kv_dtype):
    """Stepped ``Engine.generate``: greedy tokens equal the reference
    engine's on both wires and KV dtypes; ``auto`` resolves to stepped
    (``prefill_calls == S0``) with the same tokens."""
    got, _ = generate_match(*weights(), wire, kv_dtype, "stepped")
    jcfg, tcfg, params, tparams = weights()
    auto = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        max_seq=48, pack_weights=True, wire_dtype=wire, kv_dtype=kv_dtype), device="cpu")
    np.testing.assert_array_equal(
        auto.generate(gen_prompts(jcfg.vocab), got.shape[1] - GEN_S0), got)
    assert auto.prefill_calls == GEN_S0


def test_hybrid_batched_and_continuous_raise():
    """Batched and continuous serving raise "recurrent" (no exact one-shot
    fill of the recurrent state, no paged state), as the reference's do;
    so do ``generate_requests`` and the paged entry points."""
    jcfg, tcfg, params, tparams = weights()
    prompts = gen_prompts(tcfg.vocab, b=1, s0=4)
    for mode in ("batched", "continuous"):
        ref = jengine.Engine(params, jcfg, jengine.ServeConfig(max_seq=16, prefill_mode=mode))
        with pytest.raises(ValueError, match="recurrent"):
            ref.generate(prompts, 1)
        eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(max_seq=16, prefill_mode=mode),
                             device="cpu")
        with pytest.raises(ValueError, match="recurrent"):
            eng.generate(prompts, 1)
    eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(max_seq=16, page_size=8),
                         device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        eng.generate_requests([prompts[0]], 2)
    toks = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="recurrent"):
        tlm.paged_verify(tparams, {}, toks, toks, toks, tcfg)



@pytest.mark.parametrize("wire", ["native", "int8"])
def test_chip_smoke_recurrent_launches_per_pass(wire):
    """``chip_smoke.recurrent_launches``, what the card's hymba serves are
    held to, equals a small CPU engine's plain calls a stepped pass."""
    _, tcfg, _, tparams = weights()
    got, eng = stepped_plain_calls(tcfg, tparams, wire, wire)
    passes = eng.prefill_calls + eng.decode_calls
    want = chip_smoke_module().recurrent_launches(eng.cfg, wire)
    assert got == {name: want.get(name, 0) * passes for name in got}


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_chip_smoke_greedy_alone_equals_engine_row(wire):
    """``chip_smoke.greedy_alone``, the card's hymba request served alone
    through ``lm.decode_step``, gives the tokens a stepped engine gives
    that request's row of a batch, with finite logits."""
    _, tcfg, _, tparams = weights()
    _, eng = stepped_plain_calls(tcfg, tparams, wire, wire)
    prompts = gen_prompts(tcfg.vocab, b=2, s0=6)
    out = eng.generate(prompts, 3)
    alone, finite = chip_smoke_module().greedy_alone(torch, eng, prompts[1], 3)
    assert finite
    np.testing.assert_array_equal(alone, out[1])

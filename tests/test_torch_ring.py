"""Port parity, ring cache: ``lm.make_cache``, ``lm.prefill``,
``lm.decode_step`` and ``lm.forward`` of the port against
``repro.models.lm``'s on the same packed weights and inputs, for
granite-3-8b (GQA), minicpm3-4b (MLA: materialized prefill, absorbed ring
decode) and qwen2-vl-72b (M-RoPE, QKV bias) at ``_torch_parity.SMALL``.

Tolerances as in ``tests/test_torch_model.py``: logits at atol 1e-4; the
ring's integer planes (int8 codes, slot positions) bit for bit and its
float planes (native K/V, scales) at 1e-4.  Also ``mha``'s query-chunked
path against the unchunked one, and a sliding window that wraps the
ring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import effective, reference_params, small_cfgs, to_np
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ARCHS = ("granite_3_8b", "minicpm3_4b", "qwen2_vl_72b")
B, S0, MAX_SEQ, N_DEC = 2, 7, 16, 3
_SETUP = {}


def setup(arch, kv_dtype, wire="int8"):
    key = (arch, kv_dtype, wire)
    if key not in _SETUP:
        jcfg0, tcfg0 = small_cfgs(arch)
        params, tparams = reference_params(jcfg0, seed=0, bias_seed=7)
        jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype, wire)
        jp = jengine.pack_params_for_serving(params, jcfg, wire)
        tp = tengine.pack_params_for_serving(tparams, tcfg, wire)
        _SETUP[key] = (jcfg, tcfg, jp, tp)
    return _SETUP[key]


def _tokens(vocab, b=B, s=S0, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def check_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in jcache:
        got, want = to_np(tcache[name]), np.asarray(jcache[name])
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype.kind in "iu":  # int8 codes and slot positions
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_cache_matches_reference(arch, kv_dtype):
    """Planes, shapes, dtypes and empty contents (zeros, scale 1, pos -1);
    MLA's 1-wide v without a scale plane."""
    jcfg, tcfg, _, _ = setup(arch, kv_dtype)
    check_cache(tlm.make_cache(tcfg, B, MAX_SEQ, "cpu"), jlm.make_cache(jcfg, B, MAX_SEQ))


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, kv_dtype):
    """One-shot prefill of 7 tokens, then 3 decode steps: logits at every
    position, and the ring after each call."""
    jcfg, tcfg, jp, tp = setup(arch, kv_dtype)
    toks = _tokens(jcfg.vocab)
    jcache = jlm.make_cache(jcfg, B, MAX_SEQ)
    tcache = tlm.make_cache(tcfg, B, MAX_SEQ, "cpu")
    want, jcache = jax.jit(lambda p, t, c: jlm.prefill(p, t, jcfg, cache=c))(
        jp, jnp.asarray(toks), jcache)
    got, tcache = tlm.prefill(tp, torch.from_numpy(toks), tcfg, cache=tcache)
    v = jcfg.vocab
    np.testing.assert_allclose(to_np(got)[..., :v], np.asarray(want)[..., :v], atol=1e-4, rtol=0)
    check_cache(tcache, jcache)
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jcfg))
    nxt = np.asarray(want)[:, -1, :v].argmax(-1).astype(np.int32)[:, None]
    for i in range(N_DEC):
        want, jcache = step(jp, jcache, jnp.asarray(nxt), jnp.int32(S0 + i))
        got, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(nxt), S0 + i, tcfg)
        np.testing.assert_allclose(to_np(got)[..., :v], np.asarray(want)[..., :v],
                                   atol=1e-4, rtol=0, err_msg=f"decode step {i}")
        check_cache(tcache, jcache)
        nxt = np.asarray(want)[:, -1, :v].argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_cacheless_prefill_match_reference(arch):
    """``forward`` (and ``prefill(cache=None)``) over 70 tokens: above the
    smoke configs' ``attn_chunk`` of 64, so the non-dividing length runs
    unchunked as in the reference; at 128 the two 64-query chunks run."""
    jcfg, tcfg, jp, tp = setup(arch, "native", "native")
    v = jcfg.vocab
    for s in (70, 128):
        toks = _tokens(jcfg.vocab, b=1, s=s, seed=s)
        want = jax.jit(lambda p, t: jlm.forward(p, t, jcfg)[0])(jp, jnp.asarray(toks))
        got = tlm.forward(tp, torch.from_numpy(toks), tcfg)
        np.testing.assert_allclose(to_np(got)[..., :v], np.asarray(want)[..., :v],
                                   atol=1e-4, rtol=0, err_msg=f"S={s}")
        same = tlm.prefill(tp, torch.from_numpy(toks), tcfg)
        assert torch.equal(same, got)


def test_mha_chunked_equals_unchunked():
    """Query chunks attend over every key: the chunked path is the
    unchunked one, bit for bit (each query row's sums are its own)."""
    rng = np.random.default_rng(0)
    b, s, h, kv, d = 2, 32, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    for window in (None, 5):
        whole = tattn.mha(q, k, v, pos, pos, window=window)
        chunked = tattn.mha(q, k, v, pos, pos, window=window, chunk=8)
        assert torch.equal(whole, chunked)
        # a chunk that does not divide S falls back to one block
        assert torch.equal(tattn.mha(q, k, v, pos, pos, window=window, chunk=7), whole)


def test_sliding_window_ring_wraps_like_reference():
    """A window of 4 (the ring holds W = 4 slots) over a 7-token prompt
    and 3 decode steps: the ring keeps the last 4 positions, slot
    ``pos % 4``, and the logits match the reference."""
    jcfg0, tcfg0 = small_cfgs("granite_3_8b", sliding_window=4)
    params, tparams = reference_params(jcfg0, seed=0)
    jcfg, tcfg = effective(jcfg0, tcfg0, "int8")
    jp = jengine.pack_params_for_serving(params, jcfg, "int8")
    tp = tengine.pack_params_for_serving(tparams, tcfg, "int8")
    toks = _tokens(jcfg.vocab)
    jcache, tcache = jlm.make_cache(jcfg, B, MAX_SEQ), tlm.make_cache(tcfg, B, MAX_SEQ, "cpu")
    assert tcache["k"].shape[2] == 4
    want, jcache = jlm.prefill(jp, jnp.asarray(toks), jcfg, cache=jcache)
    got, tcache = tlm.prefill(tp, torch.from_numpy(toks), tcfg, cache=tcache)
    check_cache(tcache, jcache)
    assert sorted(to_np(tcache["pos"])[0, 0].tolist()) == [3, 4, 5, 6]
    nxt = np.zeros((B, 1), np.int32)
    for i in range(N_DEC):
        want, jcache = jlm.decode_step(jp, jcache, jnp.asarray(nxt), jnp.int32(S0 + i), jcfg)
        got, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(nxt), S0 + i, tcfg)
        np.testing.assert_allclose(to_np(got)[..., :jcfg.vocab],
                                   np.asarray(want)[..., :jcfg.vocab], atol=1e-4, rtol=0)
    check_cache(tcache, jcache)


def test_ring_helpers_match_reference():
    """``fill_ring`` then ``_update_ring`` on an int8 ring, in place, give
    the reference's planes bit for bit (same codes, scales and slots), and
    ``kv_roundtrip``/``ring_window`` read back the same values."""
    from repro.models import attention as jattn

    rng = np.random.default_rng(5)
    b, w, d, s = 2, 4, 8, 6
    new_k, new_v = (rng.normal(size=(b, s, d)).astype(np.float32) for _ in range(2))
    jc = {"k": jnp.zeros((b, w, d), jnp.int8), "v": jnp.zeros((b, w, d), jnp.int8),
          "pos": jnp.full((b, w), -1, jnp.int32), "k_scale": jnp.ones((b, w), jnp.float32),
          "v_scale": jnp.ones((b, w), jnp.float32)}
    tc = {k: torch.from_numpy(np.array(a)) for k, a in jc.items()}
    jc = jattn.fill_ring(jc, jnp.asarray(new_k), jnp.asarray(new_v), s)
    tattn.fill_ring(tc, torch.from_numpy(new_k), torch.from_numpy(new_v), s)
    one_k, one_v = (rng.normal(size=(b, 1, d)).astype(np.float32) for _ in range(2))
    jc = jattn._update_ring(jc, jnp.asarray(one_k), jnp.asarray(one_v), jnp.int32(s), w)
    tattn._update_ring(tc, torch.from_numpy(one_k), torch.from_numpy(one_v), s, w)
    for name in jc:
        np.testing.assert_array_equal(to_np(tc[name]), np.asarray(jc[name]), err_msg=name)
    jk, jv = jattn.ring_window(jc, jnp.float32)
    tk, tv = tattn.ring_window(tc, torch.float32)
    np.testing.assert_array_equal(to_np(tk), np.asarray(jk))
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(
        to_np(tattn.kv_roundtrip(torch.from_numpy(new_k))),
        np.asarray(jattn.kv_roundtrip(jnp.asarray(new_k))))
    bare = tattn.make_kv_cache(b, w, d, 3, torch.float32, "cpu")
    want = jattn.make_kv_cache(b, w, d, 3, jnp.float32)
    for name in want:
        np.testing.assert_array_equal(to_np(bare[name]), np.asarray(want[name]))
    assert tattn.kv_is_int8(tc) and not tattn.kv_is_int8(bare)

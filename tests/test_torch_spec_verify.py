"""Port parity, self-speculative decoding beyond granite-3-8b's matrix
(``test_torch_spec.py``): ``lm.paged_verify`` against the reference's on
the same cache and window (GQA and MLA, both KV dtypes, greedy and
sampled); minicpm3-4b (MLA) at ``_torch_parity.SMALL`` (f32), whose spec
engine serves the tokens of the port's plain engine and of the
reference's spec engine, with the reference's ``spec_stats()``, over both
weight wires, both KV dtypes and both draft kinds; and granite-moe-1b-
a400m, where expert capacity couples a call's tokens (a verify window
may drop pairs that one-token decode keeps), so its spec serve is held
to re-serve identity: a fresh spec engine serves the same tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    ARRIVALS,
    FUSED,
    PACKED,
    SPEC_NEW,
    SPEC_SERVE,
    effective,
    prompts_for,
    reference_params,
    small_cfgs,
    spec_match,
    to_np,
)
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch.core.sampling import device_sampling
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

_WEIGHTS = {}


def weights(arch):
    if arch not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(arch)
        _WEIGHTS[arch] = (jcfg, tcfg) + reference_params(jcfg, seed=0)
    return _WEIGHTS[arch]


# -------------------------------------------------------------- paged_verify


VERIFY_CASES = {  # fixed ids for xdist: arch, KV dtype, sampling
    "granite-native-greedy": ("granite_3_8b", "native", "greedy"),
    "granite-int8-sampled": ("granite_3_8b", "int8", "sampled"),
    "minicpm3-native-sampled": ("minicpm3_4b", "native", "sampled"),
    "minicpm3-int8-greedy": ("minicpm3_4b", "int8", "greedy"),
}


@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_paged_verify_matches_reference(case):
    """Both sides prefill rows of 9 and 5 tokens into the same pages on the
    int8 wire, then verify a 6-wide window (row 1's last two indices
    padding; row 0 sampled at temperature 0.7 in the sampled cases):
    ``sampled`` and ``ok`` equal, integer cache planes bit for bit, float
    planes within 1e-4."""
    arch, kv, samp = VERIFY_CASES[case]
    jcfg, tcfg, params, tparams = weights(arch)
    kw = dict(SPEC_SERVE, **PACKED, wire_dtype="int8", kv_dtype=kv)
    jparams = jengine.Engine(params, jcfg, jengine.ServeConfig(paged_attn="gather", **kw)).params
    tp = tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw), device="cpu").params
    jc, tc = effective(jcfg, tcfg, kv, "int8")
    rng = np.random.default_rng(5)
    lens, s = (9, 5), 12
    toks = rng.integers(0, jcfg.vocab, (2, s)).astype(np.int32)
    pos = np.full((2, s), -1, np.int32)
    for i, n in enumerate(lens):
        pos[i, :n] = np.arange(n)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jcache = jpc.make_paged_cache(jc, 9, 8)
    tcache = tpc.make_paged_cache(tc, 9, 8, "cpu")
    # jitted, as the reference engine runs them (op by op is slower here)
    _, jcache = jax.jit(lambda p, c, t, q, tb: jlm.paged_step(p, c, t, q, tb, jc))(
        jparams, jcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables))
    tlm.paged_step(tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
                   torch.from_numpy(tables), tc)
    w = 6
    vt = rng.integers(0, jcfg.vocab, (2, w)).astype(np.int32)
    vp = np.stack([np.arange(9, 9 + w), np.r_[np.arange(5, 9), -1, -1]]).astype(np.int32)
    knobs = (np.array([0.7 if samp == "sampled" else 0.0, 0.0], np.float32),
             np.array([8, 0], np.int32), np.array([0.9, 1.0], np.float32),
             np.array([11, 3], np.uint32))
    js, jok, jcache = jax.jit(lambda p, c, t, q, tb, sm: jlm.paged_verify(
        p, c, t, q, tb, jc, sampling=sm))(jparams, jcache, jnp.asarray(vt), jnp.asarray(vp),
                                          jnp.asarray(tables), tuple(jnp.asarray(a) for a in knobs))
    ts, tok, tcache = tlm.paged_verify(tp, tcache, torch.from_numpy(vt), torch.from_numpy(vp),
                                       torch.from_numpy(tables), tc,
                                       sampling=device_sampling(*knobs, "cpu"))
    assert ts.shape == (2, w) and ts.dtype == torch.int32
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(to_np(tok), np.asarray(jok))
    assert set(tcache) == set(jcache)
    for name in tcache:
        got, want = to_np(tcache[name]), np.asarray(jcache[name])
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)


# ------------------------------------------------- minicpm3-4b's matrix


@pytest.mark.parametrize("draft", ["nnz", "int8_wire"])
@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_spec_mla_matches_plain_and_reference(wire, kv, draft):
    spec_match(*weights("minicpm3_4b"), wire, kv, draft)


# ------------------------------------------------------ granite-moe


@pytest.mark.parametrize("draft", ["nnz", "int8_wire"])
def test_spec_moe_reserves_identically(draft):
    _, tcfg, _, tparams = weights("granite_moe_1b_a400m")
    prompts = prompts_for(tcfg.vocab)
    kw = dict(SPEC_SERVE, **PACKED, **FUSED, wire_dtype="native")

    def serve():
        eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
            spec=tengine.SpecConfig(draft=draft), **kw), device="cpu")
        return eng.generate_requests(prompts, SPEC_NEW, arrivals=ARRIVALS), eng

    first, eng = serve()
    again, _ = serve()
    for i, (a, b) in enumerate(zip(first, again)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert [r.finish_reason for r in eng.last_results] == ["length"] * len(prompts)
    assert eng.spec_stats()["spec_runs"] > 0 and eng.paged_compiles == 3

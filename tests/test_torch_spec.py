"""Port parity, self-speculative decoding (``tests/test_spec_decode.py``'s
cases on the port, on the CPU): the acceptance rule, ``SpecConfig`` and
``SparsityConfig.tighten`` validation, and the port's spec engine on
granite-3-8b at ``_torch_parity.SMALL`` (f32) against both the port's
plain continuous serve and the reference's spec engine: tokens equal and
``spec_stats()`` equal, over both weight wires, both KV dtypes and both
draft kinds (``lm.paged_verify`` and minicpm3-4b's matrix are
``test_torch_spec_verify.py``).

Then the reference file's other cases, held byte for byte against the
port's plain engine: mixed lengths and arrivals, the identical draft
accepting everything, ``decode_block=1``, the three-signature budget,
rollback leaking no page, a stop inside the window at blocks 1 and 16,
a per-row stop freeing its row, verified pages adopted by the prefix
cache, and a sampled serve (temperature 0.7, seed 11)."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (
    ARRIVALS,
    FUSED,
    PACKED,
    SPEC_SERVE,
    prompts_for,
    reference_params,
    small_cfgs,
    spec_match,
)
from repro.core import sparsity as jsparsity
from repro.serve import engine as jengine
from repro_torch.core import sparsity as tsparsity
from repro_torch.serve import engine as tengine
from repro_torch.serve.scheduler import FINISH_LENGTH, FINISH_STOP

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = small_cfgs()
    return (jcfg, tcfg) + reference_params(jcfg, seed=0)


def _prompts(vocab, b=2, s0=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s0)).astype(np.int32)


def _mixed(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in lengths]


def _engine(tcfg, tparams, spec=None, wire="int8", **over):
    kw = {**SPEC_SERVE, **PACKED, **FUSED, "wire_dtype": wire, **over}
    return tengine.Engine(tparams, tcfg, tengine.ServeConfig(spec=spec, **kw), device="cpu")


# ------------------------------------------------------- acceptance rule


def test_spec_accept_matches_reference():
    target = np.array([7, 3, 9, 5], np.int32)
    for draft, k in (([7, 3, 9], 4), ([7, 8, 9], 4), ([1, 2, 3], 4), ([], 1), ([7, 3], 3)):
        d = np.array(draft, np.int32)
        assert tengine.spec_accept(d, target, k) == jengine.spec_accept(d, target, k)
    assert tengine.spec_accept(np.array([7, 3, 9]), target, 4) == 4
    assert tengine.spec_accept(np.array([7, 8, 9]), target, 4) == 2
    assert tengine.spec_accept(np.array([1, 2, 3]), target, 4) == 1
    assert tengine.spec_accept(np.zeros((0,), np.int32), np.array([5]), 1) == 1


def test_tighten_matches_reference():
    """``tighten`` keeps the KV dtype, the paged read and the activation
    scale, drops the per-layer list, and refuses a bound outside [1, bz],
    field for field as the reference's."""
    kw = dict(mode="wdbb", w_nnz=4, a_nnz=4, a_nnz_per_layer=(4, 8), act_scale="per_row",
              kv_dtype="int8", paged_attn="gather")
    j, t = jsparsity.SparsityConfig(**kw), tsparsity.SparsityConfig(**kw)
    for nnz in (1, 2, 8):
        jt, tt = j.tighten(nnz), t.tighten(nnz)
        for f in dataclasses.fields(tt):
            assert getattr(tt, f.name) == getattr(jt, f.name), f.name
        assert (tt.mode, tt.a_nnz, tt.a_nnz_per_layer) == ("awdbb", nnz, None)
        assert (tt.kv_dtype, tt.paged_attn, tt.act_scale) == ("int8", "gather", "per_row")
    for bad in (0, 9):
        with pytest.raises(ValueError, match="a_nnz"):
            t.tighten(bad)


def test_spec_config_validation(granite):
    _, tcfg, _, tparams = granite
    for mod in (jengine, tengine):
        with pytest.raises(ValueError):
            mod.SpecConfig(draft="fp4")
        with pytest.raises(ValueError):
            mod.SpecConfig(draft_nnz=0)
        with pytest.raises(ValueError, match="continuous"):
            mod.ServeConfig(spec=mod.SpecConfig(), prefill_mode="batched")
    dense = dataclasses.replace(tcfg, sparsity=dataclasses.replace(tcfg.sparsity, mode="dense"))
    with pytest.raises(ValueError, match="int8_wire"):
        tengine.Engine(tparams, dense, tengine.ServeConfig(
            spec=tengine.SpecConfig(draft="int8_wire"), prefill_mode="continuous"), device="cpu")
    with pytest.raises(ValueError, match="a_nnz"):
        _engine(tcfg, tparams, tengine.SpecConfig(draft_nnz=99))
    # the int8 copy is packed from dense weights: native-packed ones refuse
    packed = tengine.pack_params_for_serving(tparams, tcfg, "native")
    with pytest.raises(ValueError, match="unpacked"):
        _engine(tcfg, packed, tengine.SpecConfig(draft="int8_wire"), wire="native")


# ------------------------------------------------- the exactness matrix


@pytest.mark.parametrize("draft", ["nnz", "int8_wire"])
@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_spec_matches_plain_and_reference(granite, wire, kv, draft):
    spec_match(*granite, wire, kv, draft)


# ------------------------------------------ the reference file's cases


def test_spec_mixed_lengths_and_arrivals(granite):
    _, tcfg, _, tparams = granite
    prompts = _mixed(tcfg.vocab, (9, 5, 12), seed=3)
    arrivals = [0, 2, 5]
    plain = _engine(tcfg, tparams, max_batch=3).generate_requests(prompts, 10, arrivals=arrivals)
    eng = _engine(tcfg, tparams, tengine.SpecConfig(), max_batch=3)
    out = eng.generate_requests(prompts, 10, arrivals=arrivals)
    for i, (a, b) in enumerate(zip(out, plain)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert eng.paged_compiles == 3 and eng.decode_run_calls > 0


def test_spec_identical_draft_accepts_everything(granite):
    """An int8-wire target with the int8_wire draft: the draft is the
    target, so every proposal verifies (pins the window's indexing)."""
    _, tcfg, _, tparams = granite
    eng = _engine(tcfg, tparams, tengine.SpecConfig(draft="int8_wire"))
    eng.generate(_prompts(tcfg.vocab), 12)
    stats = eng.spec_stats()
    assert stats["proposed"] > 0 and stats["acceptance_rate"] == 1.0


def test_spec_k1_matches_plain_and_proposes_nothing(granite):
    _, tcfg, _, tparams = granite
    prompts = _prompts(tcfg.vocab)
    plain = _engine(tcfg, tparams, decode_block=1).generate(prompts, 8)
    eng = _engine(tcfg, tparams, tengine.SpecConfig(), decode_block=1)
    np.testing.assert_array_equal(eng.generate(prompts, 8), plain)
    stats = eng.spec_stats()
    assert stats["spec_runs"] > 0 and stats["proposed"] == 0 and stats["emitted"] > 0


def test_spec_rollback_leaks_no_pages(granite):
    """Pages of 2 slots with a low-acceptance draft: rounds overshoot page
    boundaries, so ``truncate_to`` really drops pages; afterwards every
    page but the null page is free."""
    _, tcfg, _, tparams = granite
    prompts = _prompts(tcfg.vocab)
    plain = _engine(tcfg, tparams, page_size=2, prefix_cache=False).generate(prompts, 12)
    eng = _engine(tcfg, tparams, tengine.SpecConfig(draft="nnz", draft_nnz=2), page_size=2,
                  prefix_cache=False)
    np.testing.assert_array_equal(eng.generate(prompts, 12), plain)
    assert eng.spec_stats()["accepted"] < eng.spec_stats()["proposed"]
    alloc = eng._cont["allocator"]
    assert alloc.n_free == eng.scfg.total_pages - 1


@pytest.mark.parametrize("block", [1, 16])
def test_spec_stop_inside_window(granite, block):
    _, tcfg, _, tparams = granite
    prompts = _prompts(tcfg.vocab)
    plain = _engine(tcfg, tparams, decode_block=block).generate(prompts, 12)
    stops = [int(plain[0][-9]), int(plain[1][-7])]
    ref = _engine(tcfg, tparams, decode_block=block).serve_requests(
        list(prompts), 12, stop_tokens=[stops] * 2)
    res = _engine(tcfg, tparams, tengine.SpecConfig(), decode_block=block).serve_requests(
        list(prompts), 12, stop_tokens=[stops] * 2)
    assert [r.finish_reason for r in res] == [r.finish_reason for r in ref]
    assert any(r.finish_reason == FINISH_STOP for r in res)
    for i, (a, b) in enumerate(zip(res, ref)):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=f"request {i}")
        if a.finish_reason == FINISH_STOP:
            assert int(a.tokens[-1]) in stops
            assert not any(int(t) in stops for t in a.tokens[len(prompts[i]):-1])


def test_spec_per_row_stop_frees_row(granite):
    _, tcfg, _, tparams = granite
    prompts = _mixed(tcfg.vocab, (8, 8, 8), seed=9)
    plain = _engine(tcfg, tparams).generate_requests(prompts, 12)
    stops = [[int(plain[0][len(prompts[0]) + 3])], [], []]
    ref = _engine(tcfg, tparams).serve_requests(prompts, 12, stop_tokens=stops)
    res = _engine(tcfg, tparams, tengine.SpecConfig()).serve_requests(prompts, 12,
                                                                      stop_tokens=stops)
    assert res[0].finish_reason == FINISH_STOP
    assert res[1].finish_reason == res[2].finish_reason == FINISH_LENGTH
    for i, (a, b) in enumerate(zip(res, ref)):
        assert a.finish_reason == b.finish_reason, f"request {i}"
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=f"request {i}")


def test_spec_verified_pages_adoptable_by_prefix_cache(granite):
    _, tcfg, _, tparams = granite
    prompts = _prompts(tcfg.vocab, s0=16)
    ref = _engine(tcfg, tparams)
    ref1, ref2 = ref.generate(prompts, 10), ref.generate(prompts, 10)
    eng = _engine(tcfg, tparams, tengine.SpecConfig())
    np.testing.assert_array_equal(eng.generate(prompts, 10), ref1)
    np.testing.assert_array_equal(eng.generate(prompts, 10), ref2)
    assert eng.prefix_stats()["page_hits"] > 0


def test_spec_sampled_equals_sampled_plain(granite):
    """Temperature 0.7, seed 11: the verify pass samples every window
    index with the position-keyed sampler solo decode uses."""
    _, tcfg, _, tparams = granite
    prompts = prompts_for(tcfg.vocab)
    samp = dict(temperature=0.7, seed=11)
    plain = _engine(tcfg, tparams, **samp).generate_requests(prompts, 10, arrivals=ARRIVALS)
    greedy = _engine(tcfg, tparams).generate_requests(prompts, 10, arrivals=ARRIVALS)
    for draft in ("nnz", "int8_wire"):
        eng = _engine(tcfg, tparams, tengine.SpecConfig(draft=draft), **samp)
        out = eng.generate_requests(prompts, 10, arrivals=ARRIVALS)
        for i, (a, b) in enumerate(zip(out, plain)):
            np.testing.assert_array_equal(a, b, err_msg=f"{draft} request {i}")
        assert eng.spec_stats()["spec_runs"] > 0
    assert any(not np.array_equal(a, b) for a, b in zip(plain, greedy))

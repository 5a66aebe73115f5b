"""Port parity, fault injection (``tests/test_faults.py``'s fault cases on
the port, on the CPU): the seeded injector (``serve/faults.py``) driving
the port's engine on granite-3-8b at ``_torch_parity.SMALL`` (f32, int8
wire).  Every healthy request stays byte-identical to the port's solo
stepped engine, and ``health()``'s counters equal the reference engine's
(``paged_attn="gather"``) for the same ``FaultConfig`` seed on the same
weights (the step-time keys aside): the injector draws the reference's
PRNG stream in the reference's order.

Covered: allocator faults preempting and recomputing exactly; the NaN
watchdog quarantining only the poisoned row; the injected fused-kernel
fault falling back to gather one way, with a logged warning, equal
tokens and a cache byte-identical to a fault-free switch (the eager
retry's argument, a copy-on-write in the faulted dispatch included); a
real error of #6 propagating with no fallback; invisible scribbles; the
three spec-with-fault cases; kill-point validation, ``SimulatedCrash``
propagating once, and every kill site reached.  The chaos fuzz is
``test_torch_chaos.py``."""

import logging

import numpy as np
import pytest
import torch

from _torch_parity import FUSED, reference_params, small_cfgs
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro_torch.kernels import ref as kref
from repro_torch.serve import engine as tengine
from repro_torch.serve import faults
from repro_torch.serve.scheduler import FINISH_LENGTH, FINISH_NUMERICAL

torch.set_num_threads(1)

INT8 = dict(pack_weights=True, wire_dtype="int8")
TIMING = ("step_p50_us", "step_p99_us", "slow_steps")


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = small_cfgs()
    return (jcfg, tcfg) + reference_params(jcfg, seed=0)


def mixed(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in lengths]


def stepped_reference(tcfg, tparams, prompts, n_tokens):
    """Each request alone through the port's stepped engine."""
    eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        max_seq=64, prefill_mode="stepped", **INT8), device="cpu")
    return [eng.generate(p[None], n_tokens)[0] for p in prompts]


def port_engine(tcfg, tparams, **kw):
    """The port's continuous engine, on the fused path unless ``kw``
    names another."""
    return tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        prefill_mode="continuous", **INT8, **dict(FUSED, **kw)), device="cpu")


def health_equal(teng, jeng):
    got = {k: v for k, v in teng.health().items() if k not in TIMING}
    want = {k: v for k, v in jeng.health().items() if k not in TIMING}
    assert got == want


def serve_both(granite, fkw, prompts, n_tokens, spec=False, **kw):
    """The port's and the reference's engine (same weights, config and
    ``FaultConfig``) serve ``prompts``; returns (port results, port engine)
    after checking the typed outcomes and ``health()`` agree."""
    jcfg, tcfg, params, tparams = granite
    teng = port_engine(tcfg, tparams, spec=tengine.SpecConfig() if spec else None, **kw)
    jeng = jengine.Engine(params, jcfg, jengine.ServeConfig(
        prefill_mode="continuous", paged_attn="gather",
        spec=jengine.SpecConfig() if spec else None, **INT8, **kw))
    teng.set_faults(faults.FaultConfig(**fkw))
    jeng.set_faults(jfaults.FaultConfig(**fkw))
    res = teng.serve_requests(prompts, n_tokens)
    want = jeng.serve_requests(prompts, n_tokens)
    assert [r.finish_reason for r in res] == [r.finish_reason for r in want]
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r.tokens, w.tokens)
    health_equal(teng, jeng)
    if spec:
        assert teng.spec_stats() == jeng.spec_stats()
    return res, teng


# -------------------------------------------------------- fault injection


def test_alloc_faults_preempt_and_recompute_exactly(granite):
    _, tcfg, _, tparams = granite
    prompts = mixed(tcfg.vocab, (9, 5, 12))
    res, eng = serve_both(granite, dict(seed=7, alloc_fail_p=0.2), prompts, 8,
                          max_seq=48, page_size=4, max_batch=3, prefill_chunk=4)
    health = eng.health()
    assert health["injected_alloc_faults"] > 0, "fault never fired"
    assert health["preemptions_fault"] == health["injected_alloc_faults"]
    assert all(r.finish_reason == FINISH_LENGTH for r in res)
    for r, want in zip(res, stepped_reference(tcfg, tparams, prompts, 8)):
        np.testing.assert_array_equal(r.tokens, want)


def test_nan_watchdog_quarantines_only_poisoned_row(granite):
    _, tcfg, _, tparams = granite
    prompts = mixed(tcfg.vocab, (9, 5, 12))
    res, eng = serve_both(granite, dict(seed=0, nan_rids=(2,)), prompts, 8,
                          max_seq=48, page_size=8, max_batch=3, prefill_chunk=4)
    assert res[1].finish_reason == FINISH_NUMERICAL
    assert res[0].finish_reason == res[2].finish_reason == FINISH_LENGTH
    assert eng.health()["quarantines"] == 1
    ref = stepped_reference(tcfg, tparams, prompts, 8)
    for i in (0, 2):
        np.testing.assert_array_equal(res[i].tokens, ref[i])


def test_scrub_scribbles_are_invisible(granite):
    _, tcfg, _, tparams = granite
    prompts = mixed(tcfg.vocab, (9, 5, 12))
    res, eng = serve_both(granite, dict(seed=1, scrub_corrupt_p=1.0), prompts, 8,
                          max_seq=48, page_size=4, max_batch=2, prefill_chunk=4)
    assert eng.health()["injected_scribbles"] > 0
    assert all(r.finish_reason == FINISH_LENGTH for r in res)
    for r, want in zip(res, stepped_reference(tcfg, tparams, prompts, 8)):
        np.testing.assert_array_equal(r.tokens, want)


# --------------------------------------------------- the gather fallback


FALLBACK = dict(max_seq=48, page_size=8, max_batch=2, prefill_chunk=4, paged_attn="fused")


def test_fused_failure_falls_back_to_gather(granite, caplog):
    """The injected fault fires inside the first dispatch; the engine logs,
    switches to gather for good and retries.  Tokens equal the solo
    stepped engine's and a gather engine's."""
    _, tcfg, _, tparams = granite
    prompts = mixed(tcfg.vocab, (9, 5))
    eng = port_engine(tcfg, tparams, **FALLBACK)
    eng.set_faults(faults.FaultConfig(seed=0, fail_fused=True))
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve.engine"):
        res = eng.serve_requests(prompts, 8)
    assert eng.fallbacks == 1 and eng.health()["injected_fused_faults"] == 1
    assert eng.cfg.sparsity.paged_attn == "gather"  # one way
    assert any("falling back" in r.getMessage().lower() for r in caplog.records)
    assert all(r.finish_reason == FINISH_LENGTH for r in res)
    gather = port_engine(tcfg, tparams, **dict(FALLBACK, paged_attn="gather"))
    for r, g, want in zip(res, gather.serve_requests(prompts, 8),
                          stepped_reference(tcfg, tparams, prompts, 8)):
        np.testing.assert_array_equal(r.tokens, g.tokens)
        np.testing.assert_array_equal(r.tokens, want)


@pytest.mark.parametrize("spec", [False, True])
def test_fallback_retry_leaves_the_cache_of_a_clean_switch(granite, spec):
    """The eager retry's argument, shown: a fused serve warms the prefix
    cache; the next serve re-sends a 16-token prompt whose first write
    lands in an adopted page, so its first dispatch copies that page
    (copy-on-write) and scrubs fresh ones before the fault fires in layer
    0.  Against an engine switched to gather between the serves without
    a fault, the tokens and every cache plane are byte-identical."""
    _, tcfg, _, tparams = granite
    first = mixed(tcfg.vocab, (16, 9), seed=4)
    second = [first[0], mixed(tcfg.vocab, (7,), seed=8)[0]]
    sp = tengine.SpecConfig() if spec else None
    faulted = port_engine(tcfg, tparams, spec=sp, **FALLBACK)
    clean = port_engine(tcfg, tparams, spec=sp, **FALLBACK)
    for eng in (faulted, clean):
        eng.generate_requests(first, 6)
    faulted.set_faults(faults.FaultConfig(seed=0, fail_fused=True))
    clean._fallback_to_gather(RuntimeError("switched by the test"))
    cow0 = faulted._cont["allocator"].cow_count
    got = faulted.generate_requests(second, 6)
    want = clean.generate_requests(second, 6)
    assert faulted.fallbacks == 1 and faulted._cont["allocator"].cow_count > cow0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for name, plane in faulted._cont["cache"].items():
        assert torch.equal(plane, clean._cont["cache"][name]), name


def test_real_kernel_error_propagates(granite, monkeypatch):
    """Only ``FusedKernelFault`` falls back: a RuntimeError of #6 (here its
    plain version) propagates, and the engine stays on the fused path."""
    _, tcfg, _, tparams = granite

    def broken(*a, **kw):
        raise RuntimeError("paged attention failed")

    monkeypatch.setattr(kref, "paged_attn_ref", broken)
    eng = port_engine(tcfg, tparams, **FALLBACK)
    with pytest.raises(RuntimeError, match="paged attention failed"):
        eng.serve_requests(mixed(tcfg.vocab, (9, 5)), 4)
    assert eng.fallbacks == 0 and eng.cfg.sparsity.paged_attn == "fused"


# ------------------------------------------- faults under spec decoding


def test_alloc_fault_mid_draft_preempts_only_victim(granite):
    _, tcfg, _, tparams = granite
    prompts = mixed(tcfg.vocab, (9, 5, 12))
    res, eng = serve_both(granite, dict(seed=7, alloc_fail_p=0.2), prompts, 8, spec=True,
                          max_seq=48, page_size=4, max_batch=3, prefill_chunk=4)
    health = eng.health()
    assert health["injected_alloc_faults"] > 0
    assert health["preemptions_fault"] == health["injected_alloc_faults"]
    assert all(r.finish_reason == FINISH_LENGTH for r in res)
    for r, want in zip(res, stepped_reference(tcfg, tparams, prompts, 8)):
        np.testing.assert_array_equal(r.tokens, want)


def test_nan_draft_quarantines_only_afflicted_row(granite):
    _, tcfg, _, tparams = granite
    prompts = mixed(tcfg.vocab, (9, 5, 12))
    res, eng = serve_both(granite, dict(seed=0, nan_draft_rids=(2,)), prompts, 8, spec=True,
                          max_seq=48, page_size=8, max_batch=3, prefill_chunk=4,
                          decode_block=8)
    assert res[1].finish_reason == FINISH_NUMERICAL
    assert res[0].finish_reason == res[2].finish_reason == FINISH_LENGTH
    assert eng.health()["injected_draft_nan_poisons"] == 1
    assert eng.health()["quarantines"] == 1
    ref = stepped_reference(tcfg, tparams, prompts, 8)
    for i in (0, 2):
        np.testing.assert_array_equal(res[i].tokens, ref[i])


def test_preempt_during_spec_run_replays_byte_identical(granite):
    _, tcfg, _, tparams = granite
    prompts = mixed(tcfg.vocab, (9, 5, 12, 7), seed=5)
    eng = port_engine(tcfg, tparams, spec=tengine.SpecConfig(), prefill_chunk=4, max_seq=24,
                      page_size=4, max_batch=3, max_pages=13, preempt_after=2)
    res = eng.serve_requests(prompts, 10)
    assert all(r.finish_reason == FINISH_LENGTH for r in res)
    assert eng.health()["preemptions"] > 0 and eng.spec_stats()["spec_runs"] > 0
    for i, (r, want) in enumerate(zip(res, stepped_reference(tcfg, tparams, prompts, 10))):
        np.testing.assert_array_equal(r.tokens, want, err_msg=f"request {i}")


# ------------------------------------------------------------ kill points


KILL = dict(prefill_chunk=4, max_seq=24, page_size=4, max_batch=2, max_pages=11)


def test_kill_point_config_validation():
    with pytest.raises(ValueError, match="kill_point"):
        faults.FaultConfig(kill_at=1, kill_point="bogus")
    with pytest.raises(ValueError, match="kill_at"):
        faults.FaultConfig(kill_at=0)
    for bad in (dict(alloc_fail_p=1.5), dict(scrub_corrupt_p=-0.1)):
        with pytest.raises(ValueError):
            faults.FaultConfig(**bad)
    assert faults.KILL_POINTS == jfaults.KILL_POINTS
    for site in faults.KILL_POINTS:
        faults.FaultConfig(kill_at=1, kill_point=site)


def test_simulated_crash_propagates_and_fires_once(granite):
    _, tcfg, _, tparams = granite
    eng = port_engine(tcfg, tparams, **KILL)
    eng.set_faults(faults.FaultConfig(seed=0, kill_at=2, kill_point="pre_commit"))
    with pytest.raises(faults.SimulatedCrash):
        eng.generate_requests(mixed(tcfg.vocab, (9, 5), seed=5), 6)
    inj = eng._injector
    assert inj.kills == 1 and eng.health()["injected_kills"] == 1
    inj.maybe_kill("pre_commit")  # the countdown is spent
    assert inj.kills == 1


@pytest.mark.parametrize("site", faults.KILL_POINTS)
def test_kill_site_is_reached(granite, site, tmp_path):
    _, tcfg, _, tparams = granite
    eng = port_engine(tcfg, tparams, snapshot_dir=str(tmp_path), snapshot_every=1, **KILL)
    eng.set_faults(faults.FaultConfig(seed=0, kill_at=1, kill_point=site))
    with pytest.raises(faults.SimulatedCrash, match=site):
        eng.generate_requests(mixed(tcfg.vocab, (9, 5), seed=5), 6)

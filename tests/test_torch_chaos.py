"""Port parity, the chaos fuzz (``tests/test_faults.py``'s
``test_chaos_fuzz_zero_exceptions_healthy_rows_exact`` on the port, on
the CPU): 200 seeds of combined faults — allocator failures (p 0.05), a
NaN-poisoned request, free-page scribbles — over a 2x-oversubscribed
pool with aging preemption, on one reused engine (granite-3-8b at
``_torch_parity.SMALL``, f32, dense weights and the gather read, as the
reference's fuzz serves on the CPU); then 50 seeds of the same storm
with draft NaNs on a spec engine, and the injected fused-kernel fault
once.  Every seed finishes with no engine exception, every request
typed, every healthy request byte-identical to the solo stepped engine.
For the first 20 seeds of each storm the reference engine serves beside
the port with the same ``FaultConfig``: outcomes, tokens and ``health()``
counters (the step-time keys aside) equal."""

import numpy as np
import pytest
import torch

from _torch_parity import reference_params, small_cfgs
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro_torch.serve import engine as tengine
from repro_torch.serve import faults
from repro_torch.serve.scheduler import FINISH_LENGTH, FINISH_NUMERICAL

torch.set_num_threads(1)

TIMING = ("step_p50_us", "step_p99_us", "slow_steps")
# 2x oversubscription: ~4 pages a request x 6 requests = 25 with the null
# page; the pool holds half
POOL = dict(prefill_mode="continuous", max_seq=48, page_size=4, max_batch=3, max_pages=13,
            prefill_chunk=4, preempt_after=3, paged_attn="gather")
N_TOK = 8
N_PAIRED = 20  # seeds served by the reference beside the port


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small_cfgs()
    params, tparams = reference_params(jcfg, seed=0)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, tcfg.vocab, (s,)).astype(np.int32) for s in (9, 5, 12, 7, 10, 6)]
    solo = tengine.Engine(tparams, tcfg, tengine.ServeConfig(max_seq=64, prefill_mode="stepped"),
                          device="cpu")
    ref = [solo.generate(p[None], N_TOK)[0] for p in prompts]
    return jcfg, tcfg, params, tparams, prompts, ref


FIRED = ("injected_alloc_faults", "injected_nan_poisons", "injected_draft_nan_poisons",
         "injected_scribbles")


def storm(setup, n_seeds, spec, fault_kw):
    """Serve ``n_seeds`` storms (a fresh injector each); returns the port
    engine and the faults fired over all seeds."""
    jcfg, tcfg, params, tparams, prompts, ref = setup
    teng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        spec=tengine.SpecConfig() if spec else None, **POOL), device="cpu")
    jeng = jengine.Engine(params, jcfg, jengine.ServeConfig(
        spec=jengine.SpecConfig() if spec else None, **POOL))
    fired = dict.fromkeys(FIRED, 0)
    for seed in range(n_seeds):
        victim = teng._rid + 1 + (seed % len(prompts))
        kw = fault_kw(seed, victim)
        teng.set_faults(faults.FaultConfig(**kw))
        res = teng.serve_requests(prompts, N_TOK)  # must never raise
        for i, r in enumerate(res):
            assert r.finish_reason in (FINISH_LENGTH, FINISH_NUMERICAL), (seed, i, r)
            if r.finish_reason == FINISH_LENGTH:
                np.testing.assert_array_equal(r.tokens, ref[i], err_msg=f"seed {seed} req {i}")
        for key in FIRED:
            fired[key] += teng.health()[key]
        if seed < N_PAIRED:
            jeng.set_faults(jfaults.FaultConfig(**kw))
            want = jeng.serve_requests(prompts, N_TOK)
            assert [r.finish_reason for r in res] == [r.finish_reason for r in want], seed
            for r, w in zip(res, want):
                np.testing.assert_array_equal(r.tokens, w.tokens)
            got_h = {k: v for k, v in teng.health().items() if k not in TIMING}
            want_h = {k: v for k, v in jeng.health().items() if k not in TIMING}
            assert got_h == want_h, seed
    return teng, fired


def test_chaos_fuzz_zero_exceptions_healthy_rows_exact(setup):
    eng, fired = storm(setup, 200, False, lambda seed, victim: dict(
        seed=seed, alloc_fail_p=0.05, nan_rids=(victim,), scrub_corrupt_p=0.1))
    assert min(fired[k] for k in ("injected_alloc_faults", "injected_nan_poisons",
                                  "injected_scribbles")) > 0, fired
    h = eng.health()
    assert h["preemptions_fault"] > 0 and h["quarantines"] > 0


def test_chaos_fuzz_spec_engine(setup):
    """Draft+verify rounds, rejection rollback and draft-NaN quarantine
    under allocator failures and scribbles."""
    eng, fired = storm(setup, 50, True, lambda seed, victim: dict(
        seed=seed, alloc_fail_p=0.05, scrub_corrupt_p=0.1, nan_draft_rids=(victim,)))
    assert min(fired[k] for k in ("injected_alloc_faults", "injected_draft_nan_poisons",
                                  "injected_scribbles")) > 0, fired
    assert eng.spec_stats()["spec_runs"] > 0


def test_chaos_fused_fault_once(setup):
    _, tcfg, _, tparams, prompts, ref = setup
    eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(**dict(POOL, paged_attn="fused")),
                         device="cpu")
    eng.set_faults(faults.FaultConfig(seed=0, fail_fused=True))
    res = eng.serve_requests(prompts, N_TOK)
    assert eng.fallbacks == 1
    for r, want in zip(res, ref):
        assert r.finish_reason == FINISH_LENGTH
        np.testing.assert_array_equal(r.tokens, want)

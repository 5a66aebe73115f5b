"""Port parity, the rest of the engine's settings against the live
reference engine on the same converted weights (``_torch_parity.SMALL``,
f32): serving unpacked (dense) weights under ``awdbb`` (DAP's dense form
before a plain matmul) and under ``dense`` sparsity; the int8 wire
without packing refused as in the reference; ``paged_attn="gather"``
token-equal to ``"fused"`` and to the reference; ``serve_requests``'
typed outcomes (``tests/test_faults.py``'s case, without its fault
injection); and ``on_token`` streaming (mirroring
``tests/test_serve.py:830-904``).  Tokens are compared for equality on
these pinned cases."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (
    ARRIVALS,
    FUSED,
    N_NEW,
    PACKED,
    SERVE,
    prompts_for,
    reference_params,
    small_cfgs,
)
from repro.core.sparsity import DENSE as JDENSE
from repro.serve import engine as jengine
from repro_torch.core.sparsity import DENSE as TDENSE
from repro_torch.kernels import ops
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

_WEIGHTS = {}


def weights(arch="granite_3_8b", sparsity="awdbb"):
    key = (arch, sparsity)
    if key not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(arch)
        if sparsity == "dense":
            jcfg = dataclasses.replace(jcfg, sparsity=JDENSE)
            tcfg = dataclasses.replace(tcfg, sparsity=TDENSE)
        _WEIGHTS[key] = (jcfg, tcfg) + reference_params(jcfg, seed=0)
    return _WEIGHTS[key]


def both(key, **kw):
    """The reference's engine and the port's on ``kw``; the port's on the
    fused path unless ``kw`` names another."""
    jcfg, tcfg, params, tparams = weights(*key)
    jeng = jengine.Engine(params, jcfg, jengine.ServeConfig(**kw))
    teng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(**dict(FUSED, **kw)), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("mode", ["continuous", "batched"])
@pytest.mark.parametrize("sparsity", ["awdbb", "dense"])
def test_unpacked_weights_match_reference(sparsity, mode):
    jeng, teng = both(("granite_3_8b", sparsity), **SERVE, prefill_mode=mode, kv_dtype="int8")
    assert all("w" in lin for lin in teng.params["layers"][0]["attn"].values())
    prompts = prompts_for(teng.cfg.vocab)
    ops.reset_counters()
    if mode == "continuous":
        want = jeng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
        got = teng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    else:
        batch = np.stack([p[:5] for p in prompts])
        want, got = [jeng.generate(batch, N_NEW)], [teng.generate(batch, N_NEW)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"request {i}")
    counts = ops.counters()
    # no packed matmul; DAP's dense form prunes every linear's input
    # under awdbb (the head's aside), none under dense sparsity
    assert all(counts[k].plain == 0 for k in counts if k.startswith("dbb_matmul"))
    assert (counts["dap_prune"].plain > 0) == (sparsity == "awdbb")


def test_int8_wire_without_packing_raises():
    """The reference refuses to serve full precision while the caller
    believes the int8 wire is active; so does the port."""
    for key, kw in (((("granite_3_8b", "awdbb")), dict(pack_weights=False)),
                    ((("granite_3_8b", "dense")), dict(pack_weights=True))):
        jcfg, tcfg, params, tparams = weights(*key)
        with pytest.raises(ValueError, match="requires pack_weights=True"):
            jengine.Engine(params, jcfg, jengine.ServeConfig(wire_dtype="int8", **kw))
        with pytest.raises(ValueError, match="requires pack_weights=True"):
            tengine.Engine(tparams, tcfg, tengine.ServeConfig(wire_dtype="int8", **kw),
                           device="cpu")


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_gather_equals_fused_and_reference(arch, kv):
    """``paged_attn="gather"`` (``paged_read`` + ``mha`` /
    ``_mla_absorbed``) serves the fused kernel's tokens and the
    reference's gather path's, sampled."""
    kw = dict(SERVE, **PACKED, wire_dtype="int8", kv_dtype=kv, temperature=0.7, seed=11)
    jeng, teng = both((arch, "awdbb"), **kw, paged_attn="gather")
    prompts = prompts_for(teng.cfg.vocab)
    ops.reset_counters()
    got = teng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    attn = "paged_attn_latent" if arch == "minicpm3_4b" else "paged_attn"
    assert ops.counters()[attn].plain == 0
    fused = both((arch, "awdbb"), **kw, paged_attn="fused")[1].generate_requests(
        prompts, N_NEW, arrivals=ARRIVALS)
    want = jeng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], fused[i], err_msg=f"request {i} gather != fused")
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i} vs reference")


def test_serve_requests_typed_outcomes_match_reference():
    """Oversized, deadline and cancelled requests come back typed, with
    the reference's reasons, counts and tokens; the completed one equals
    its ``generate_requests`` tokens."""
    kw = dict(SERVE, **PACKED, wire_dtype="int8")
    jeng, teng = both(("granite_3_8b", "awdbb"), **kw)
    prompts = prompts_for(teng.cfg.vocab)
    big = np.zeros(40, np.int32)
    args = dict(deadlines=[None, None, 4, None], cancel_at=[None, None, None, 2])
    want = jeng.serve_requests([prompts[0], big, prompts[1], prompts[2]], 6, **args)
    got = teng.serve_requests([prompts[0], big, prompts[1], prompts[2]], 6, **args)
    assert [r.finish_reason for r in got] == [
        "length", "rejected_too_large", "deadline_exceeded", "cancelled"]
    for g, w in zip(got, want):
        assert (g.finish_reason, g.n_generated, g.ok) == (w.finish_reason, w.n_generated, w.ok)
        np.testing.assert_array_equal(g.tokens, w.tokens)
    np.testing.assert_array_equal(got[1].tokens, big)
    assert got[1].time_to_first_token == 0.0 and got[0].time_to_first_token > 0
    alone = tengine.Engine(teng.params, teng.cfg, teng.scfg, device="cpu").generate_requests(
        prompts[:1], 6)
    np.testing.assert_array_equal(got[0].tokens, alone[0])


# ------------------------------------------------------------- streaming


def _prefix_workload(vocab, ps=8, seed=11):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (2 * ps,)).astype(np.int32)
    tails = [rng.integers(0, vocab, (t,)).astype(np.int32) for t in (3, 6, 1)]
    return [np.concatenate([prefix, t]) for t in tails]


STREAM = dict(prefill_mode="continuous", pack_weights=True, max_seq=48, page_size=8,
              max_batch=2, prefill_chunk=4, **FUSED)


def _collect(store, rid, toks, start):
    buf = store.setdefault(rid, [])
    assert start == len(buf), (rid, start, len(buf))
    buf.extend(int(t) for t in toks)


def _port(**kw):
    _, tcfg, _, tparams = weights()
    return tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw), device="cpu")


def test_streaming_matches_final_output():
    """In order, gapless, byte-equal to the final tokens; ``None`` holes
    in a per-request list stream nothing."""
    eng = _port(temperature=0.8, seed=5, **STREAM)
    streamed = {}

    def cb(rid, toks, start):
        _collect(streamed, rid, toks, start)

    prompts = _prefix_workload(eng.cfg.vocab)
    res = eng.serve_requests(prompts, 8, on_token=[cb, None, cb])
    assert sorted(streamed) == sorted([res[0].rid, res[2].rid])
    for r in (res[0], res[2]):
        assert streamed[r.rid] == r.tokens[len(r.tokens) - r.n_generated:].tolist()


def test_streaming_survives_preempt_and_recompute():
    """A preempted request streams only past what it already delivered."""
    eng = _port(prefill_mode="continuous", pack_weights=True, prefill_chunk=4, max_seq=24,
                page_size=4, max_batch=3, max_pages=13, preempt_after=2, **FUSED)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.cfg.vocab, (s,)).astype(np.int32) for s in (9, 5, 12, 7)]
    streamed = {}
    res = eng.serve_requests(prompts, 10, on_token=lambda rid, t, s: _collect(streamed, rid, t, s))
    assert sum(r.preemptions for r in res) > 0, "pool never forced a preempt"
    for r in res:
        assert streamed.get(r.rid, []) == r.tokens[len(r.tokens) - r.n_generated:].tolist()


def test_streaming_stops_at_stop_token():
    """The stream ends at the stop token: nothing past it leaks."""
    prompts = _prefix_workload(64)
    ref = _port(**STREAM).generate_requests(prompts, 8)
    gen0 = ref[0][len(prompts[0]):].tolist()
    stop = gen0[3]
    streamed = {}
    res = _port(**STREAM).serve_requests(
        prompts, 8, stop_tokens=[[stop], [], []],
        on_token=lambda rid, t, s: _collect(streamed, rid, t, s))
    assert res[0].finish_reason == "stop"
    assert streamed[res[0].rid] == gen0[: gen0.index(stop) + 1]


def test_streaming_rejects_non_callable():
    eng = _port(**STREAM)
    with pytest.raises(ValueError, match="on_token"):
        eng.generate_requests(_prefix_workload(eng.cfg.vocab), 4, on_token=42)

"""The port's sampled-serving invariants, byte for byte, inside the port
(mirroring ``tests/test_sampling.py:194-290``): continuous serving
(decode runs) == each request's solo stepped run under the same seed,
for GQA and MLA, both weight wires (packed) and both KV dtypes;
co-batched sampled rows == their solo runs; ``decode_block=1`` ==
``16``; a preempted-then-readmitted sampled request == its stepped run;
and the streamed tokens of a preempted request equal its output."""

import numpy as np
import pytest
import torch

from _torch_parity import FUSED, reference_params, small_cfgs
from repro_torch.core.sampling import SamplingParams
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

CONT = dict(prefill_mode="continuous", pack_weights=True, max_seq=32, page_size=8,
            max_batch=2, prefill_chunk=4, **FUSED)
_WEIGHTS = {}


def weights(arch):
    if arch not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(arch)
        _WEIGHTS[arch] = (tcfg, reference_params(jcfg, seed=0)[1])
    return _WEIGHTS[arch]


def _prompts(vocab, lengths=(9, 5, 12), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in lengths]


def _engine(arch, **kw):
    tcfg, tparams = weights(arch)
    return tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw), device="cpu")


def _stepped(arch, prompts, n, max_seq=64, **skw):
    skw = {k: v for k, v in skw.items() if k not in CONT or k == "pack_weights"}
    eng = _engine(arch, max_seq=max_seq, prefill_mode="stepped", **skw)
    return [eng.generate(p[None], n)[0] for p in prompts]


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_continuous_sampled_matches_stepped(arch, wire, kv):
    skw = dict(temperature=0.7, seed=11, wire_dtype=wire, kv_dtype=kv)
    tcfg, _ = weights(arch)
    prompts = _prompts(tcfg.vocab)
    eng = _engine(arch, **CONT, **skw)
    outs = eng.generate_requests(prompts, 6)
    assert eng.decode_run_calls > 0
    ref = _stepped(arch, prompts, 6, pack_weights=True, **skw)
    for i, (got, want) in enumerate(zip(outs, ref)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
    greedy = _stepped(arch, prompts, 6, pack_weights=True, wire_dtype=wire, kv_dtype=kv)
    assert any(not np.array_equal(a, g) for a, g in zip(outs, greedy))


def test_sampled_tokens_batch_invariant():
    tcfg, _ = weights("granite_3_8b")
    prompts = _prompts(tcfg.vocab)
    skw = dict(temperature=0.7, seed=7, prefix_cache=False, wire_dtype="int8")
    outs = _engine("granite_3_8b", **CONT, **skw).generate_requests(prompts, 6,
                                                                   arrivals=[0, 2, 1])
    for i, p in enumerate(prompts):
        solo = _engine("granite_3_8b", **CONT, **skw).generate_requests([p], 6)[0]
        np.testing.assert_array_equal(outs[i], solo, err_msg=f"request {i}")


def test_sampled_invariant_to_decode_block():
    tcfg, _ = weights("granite_3_8b")
    prompts = _prompts(tcfg.vocab)
    skw = dict(temperature=0.9, top_k=16, top_p=0.95, seed=3)
    outs = [_engine("granite_3_8b", **dict(CONT, decode_block=blk), **skw
                    ).generate_requests(prompts, 8) for blk in (16, 1)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


PREEMPT = dict(prefill_mode="continuous", pack_weights=True, prefill_chunk=4, max_seq=24,
               page_size=4, max_batch=3, max_pages=13, preempt_after=2, **FUSED)


@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_preempt_replay_byte_identical_with_sampling(arch):
    tcfg, _ = weights(arch)
    skw = dict(temperature=0.7, seed=9)
    prompts = _prompts(tcfg.vocab, (9, 5, 12, 7), seed=5)
    streamed = {}

    def collect(rid, toks, start):
        buf = streamed.setdefault(rid, [])
        assert start == len(buf), (rid, start, len(buf))
        buf.extend(toks)

    res = _engine(arch, **PREEMPT, **skw).serve_requests(prompts, 10, on_token=collect)
    assert all(r.finish_reason == "length" for r in res)
    assert sum(r.preemptions for r in res) > 0, "pool pressure never preempted"
    ref = _stepped(arch, prompts, 10, pack_weights=True, **skw)
    for i, (r, want) in enumerate(zip(res, ref)):
        np.testing.assert_array_equal(r.tokens, want, err_msg=f"request {i}")
        assert streamed[r.rid] == r.tokens[len(prompts[i]):].tolist()


def test_per_request_sampling_overrides_config():
    """A greedy request co-batched with a sampled one keeps its greedy
    tokens; the sampled one equals its solo run."""
    tcfg, _ = weights("granite_3_8b")
    prompts = _prompts(tcfg.vocab)
    outs = _engine("granite_3_8b", **CONT).generate_requests(
        prompts, 6, arrivals=[0, 3, 1],
        sampling=[None, SamplingParams(temperature=0.7, seed=4), None])
    greedy = _stepped("granite_3_8b", prompts, 6, pack_weights=True)
    np.testing.assert_array_equal(outs[0], greedy[0])
    np.testing.assert_array_equal(outs[2], greedy[2])
    solo = _engine("granite_3_8b", **CONT, temperature=0.7, seed=4,
                   prefix_cache=False).generate_requests([prompts[1]], 6)[0]
    np.testing.assert_array_equal(outs[1], solo)

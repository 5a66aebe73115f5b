"""Port parity, sampled continuous serving: the port's engine (on the
CPU) against the live reference engine (``paged_attn="gather"``) on the
same converted weights, at ``temperature=0.7, seed=11`` and with top-k
and top-p, in the setting of ``tests/test_torch_engine.py``: prompts of
lengths 9, 5 and 12, arrivals [0, 3, 1], ``max_batch=2``, ``page_size=8``,
``prefill_chunk=4``; granite-3-8b (GQA) and minicpm3-4b (MLA) at
``_torch_parity.SMALL`` (f32), both weight wires packed and both KV
dtypes.  Sampled tokens are compared for equality on these pinned cases:
keys are jax's bit for bit (``tests/test_torch_sampling.py``), so only a
near-tie of ``gumbel + logits`` could part them.  The served tokens also
differ from greedy on each arch, so sampling really ran."""

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
from repro.serve import engine as jengine
from repro_torch.core.sampling import SamplingParams
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ARCHS = ("granite_3_8b", "minicpm3_4b")
_WEIGHTS = {}


def weights(arch):
    if arch not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(arch)
        _WEIGHTS[arch] = (jcfg, tcfg) + reference_params(jcfg, seed=0)
    return _WEIGHTS[arch]


def serve_both(arch, wire, kv, **samp):
    jcfg, tcfg, params, tparams = weights(arch)
    prompts = prompts_for(jcfg.vocab)
    kw = dict(SERVE, **PACKED, wire_dtype=wire, kv_dtype=kv, **samp)
    want = jengine.Engine(params, jcfg, jengine.ServeConfig(paged_attn="gather", **kw)
                          ).generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    teng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw, **FUSED), device="cpu")
    got = teng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    return got, want, teng


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_serving_matches_reference(arch, wire, kv):
    got, want, teng = serve_both(arch, wire, kv, temperature=0.7, seed=11)
    assert teng.decode_run_calls > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_top_k_top_p_serving_matches_reference():
    got, want, _ = serve_both("granite_3_8b", "int8", "int8",
                              temperature=0.9, top_k=16, top_p=0.95, seed=3)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_per_request_sampling_matches_reference():
    """Per-request ``SamplingParams``: a greedy, a sampled and a default
    request co-batched, port against reference."""
    jcfg, tcfg, params, tparams = weights("granite_3_8b")
    from repro.core.sampling import SamplingParams as JSamplingParams

    prompts = prompts_for(jcfg.vocab)
    kw = dict(SERVE, **PACKED, wire_dtype="int8")
    want = jengine.Engine(params, jcfg, jengine.ServeConfig(paged_attn="gather", **kw)
                          ).generate_requests(prompts, N_NEW, arrivals=ARRIVALS, sampling=[
                              None, JSamplingParams(temperature=0.7, seed=4), None])
    got = tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw, **FUSED), device="cpu"
                         ).generate_requests(prompts, N_NEW, arrivals=ARRIVALS, sampling=[
                             None, SamplingParams(temperature=0.7, seed=4), None])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_sampling_diverges_from_greedy(arch):
    """Served at ``temperature=0.7`` the tokens are not the greedy ones."""
    jcfg, tcfg, _, tparams = weights(arch)
    prompts = prompts_for(jcfg.vocab)

    def serve(**samp):
        return tengine.Engine(tparams, tcfg, tengine.ServeConfig(
            **SERVE, **PACKED, **FUSED, wire_dtype="int8", **samp), device="cpu"
        ).generate_requests(prompts, N_NEW, arrivals=ARRIVALS)

    sampled, greedy = serve(temperature=0.7, seed=11), serve()
    assert any(not np.array_equal(a, b) for a, b in zip(sampled, greedy))

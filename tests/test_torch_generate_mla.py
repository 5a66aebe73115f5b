"""Port parity, one-shot and stepped serving of minicpm3-4b (MLA: the
materialized prefill, the absorbed ring decode, the latent ring that
quantizes only k): ``Engine.generate`` in both modes against the
reference's, both wires and KV dtypes, greedy and sampled, at
``_torch_parity.SMALL``; and, within the port, batched == stepped under
int8 KV (prefill attends over the latent's round trip, mirroring
``tests/test_serve.py``'s ``test_int8_kv_batched_prefill_matches_stepped``)."""

import numpy as np
import pytest
import torch

from _torch_parity import (
    GEN_MAX_SEQ,
    GEN_NEW,
    gen_prompts,
    generate_match,
    reference_params,
    small_cfgs,
)
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs("minicpm3_4b")
    return (jcfg, tcfg) + reference_params(jcfg, seed=0)


@pytest.mark.parametrize("mode", ["batched", "stepped"])
@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_generate_matches_reference(weights, wire, kv, mode):
    samp = dict(temperature=0.8, top_k=32, seed=21) if wire != kv else {}
    generate_match(*weights, wire, kv, mode, **samp)


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_batched_equals_stepped(weights, kv):
    _, tcfg, _, tparams = weights
    prompts = gen_prompts(tcfg.vocab)
    outs = [tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        max_seq=GEN_MAX_SEQ, prefill_mode=mode, kv_dtype=kv, temperature=0.7, seed=9),
        device="cpu").generate(prompts, GEN_NEW) for mode in ("batched", "stepped")]
    np.testing.assert_array_equal(outs[0], outs[1])

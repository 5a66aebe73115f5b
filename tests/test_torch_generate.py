"""Port parity, one-shot and stepped serving: ``Engine.generate`` with
``prefill_mode="batched"`` and ``"stepped"`` over the ring cache against
the reference's, for granite-3-8b (GQA) and qwen2-vl-72b (M-RoPE, QKV
bias) at ``_torch_parity.SMALL`` on packed weights, both wires and both
KV dtypes, greedy and sampled (``temperature=0.8, top_k=32, seed=21``).
Tokens are compared for equality on these pinned cases (logits of the
same steps are held at 1e-4 in ``tests/test_torch_ring.py``).  Within the
port, byte for byte: batched == stepped == continuous, and one-shot
batched prefill is batch-invariant on both wires (mirroring
``tests/test_serve.py``)."""

import numpy as np
import pytest
import torch

from _torch_parity import (
    FUSED,
    GEN_MAX_SEQ,
    GEN_NEW,
    gen_prompts,
    generate_match,
    reference_params,
    small_cfgs,
)
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

_WEIGHTS = {}


def weights(arch):
    if arch not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(arch)
        _WEIGHTS[arch] = (jcfg, tcfg) + reference_params(jcfg, seed=0, bias_seed=3)
    return _WEIGHTS[arch]


@pytest.mark.parametrize("mode", ["batched", "stepped"])
@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("wire", ["native", "int8"])
@pytest.mark.parametrize("arch", ["granite_3_8b", "qwen2_vl_72b"])
def test_generate_matches_reference(arch, wire, kv, mode):
    samp = dict(temperature=0.8, top_k=32, seed=21) if wire == kv else {}
    generate_match(*weights(arch), wire, kv, mode, **samp)


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_batched_stepped_continuous_agree(wire):
    """The three modes give the same bytes, greedy and sampled: the same
    sampler keyed on the same fed-stream positions."""
    _, tcfg, _, tparams = weights("granite_3_8b")
    prompts = gen_prompts(tcfg.vocab, b=3)
    for samp in ({}, dict(temperature=0.8, top_k=32, seed=21)):
        outs = {}
        for mode in ("batched", "stepped", "continuous", "auto"):
            scfg = tengine.ServeConfig(max_seq=GEN_MAX_SEQ, prefill_mode=mode, pack_weights=True,
                                       wire_dtype=wire, page_size=8, max_batch=3,
                                       prefill_chunk=4, **FUSED, **samp)
            outs[mode] = tengine.Engine(tparams, tcfg, scfg, device="cpu").generate(
                prompts, GEN_NEW)
        assert outs["batched"].shape == (3, 8 + GEN_NEW)
        for mode in ("stepped", "continuous", "auto"):
            np.testing.assert_array_equal(outs[mode], outs["batched"], err_msg=mode)


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_batched_prefill_batch_invariance(wire):
    """A prompt's one-shot tokens do not depend on the prompts batched
    with it (the int8 wire's per-row activation scales, and every row's
    sums its own)."""
    _, tcfg, _, tparams = weights("granite_3_8b")
    a = gen_prompts(tcfg.vocab, b=1, seed=7)
    oth = gen_prompts(tcfg.vocab, b=3, seed=100)
    for samp in ({}, dict(temperature=0.8, seed=5)):
        scfg = tengine.ServeConfig(max_seq=32, prefill_mode="batched", pack_weights=True,
                                   wire_dtype=wire, **samp)
        solo = tengine.Engine(tparams, tcfg, scfg, device="cpu").generate(a, GEN_NEW)[0]
        co = tengine.Engine(tparams, tcfg, scfg, device="cpu").generate(
            np.concatenate([a, oth]), GEN_NEW)[0]
        np.testing.assert_array_equal(solo, co)


def test_unknown_prefill_mode_raises():
    _, tcfg, _, tparams = weights("granite_3_8b")
    eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(prefill_mode="ring"), device="cpu")
    with pytest.raises(ValueError, match="unknown prefill_mode"):
        eng.generate(gen_prompts(tcfg.vocab), 2)

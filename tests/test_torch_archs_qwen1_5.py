"""Port parity, qwen1.5-110b (dense GQA with QKV bias; d_ff 49152 at
full width): the configuration and the continuous engine, held against
``repro`` on converted weights at 2 layers and the ``SMALL`` widths in
f32, with the same seeded non-zero biases on both sides
(``_torch_parity.nonzero_biases``: both inits draw them as zeros).

Tolerances, as for the other dense archs: engine logits atol 1e-4,
greedy tokens equal on the pinned seed.
"""

import numpy as np
import pytest
import torch

from _torch_parity import check_config_fields, engines_match, reference_params, small_cfgs
from repro_torch import configs as tconfigs

torch.set_num_threads(1)

ARCH = "qwen1_5_110b"
BIAS_SEED = 13


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs(ARCH)
    return (jcfg, tcfg) + reference_params(jcfg, bias_seed=BIAS_SEED)


@pytest.mark.parametrize("smoke", [False, True])
def test_qwen1_5_config_matches_reference(smoke):
    """Every field, ``qkv_bias`` included."""
    check_config_fields(ARCH, smoke)
    cfg = tconfigs.get_config(ARCH, smoke=smoke)
    assert cfg.family == "dense" and cfg.qkv_bias and cfg.mlp_act == "swiglu"
    if not smoke:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
            80, 8192, 64, 8, 49152, 152064)


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("native", "int8"),
                                           ("int8", "native"), ("int8", "int8")])
def test_qwen1_5_engine_matches_reference(weights, wire, kv_dtype):
    """Served continuously on either wire and KV dtype with non-zero QKV
    biases: greedy tokens equal to the reference's continuous engine,
    replay logits within 1e-4; six packed linears a layer through #3 or
    #4, the biased Q/K/V among them."""
    jcfg, tcfg, params, tparams = weights
    assert any(np.abs(tparams["layers"][0]["attn"][n]["b"].numpy()).max() > 0.1
               for n in ("wq", "wk", "wv"))
    counts = engines_match(jcfg, tcfg, params, tparams, wire, kv_dtype)
    n_l = tcfg.n_layers
    passes = counts["paged_attn"][1] // n_l
    aw, dense = (("dbb_matmul_aw_int8", "dbb_matmul_int8") if wire == "int8"
                 else ("dbb_matmul_aw", "dbb_matmul"))
    assert passes > 0 and counts[aw][1] == 6 * n_l * passes
    assert counts[dense][1] == (n_l + 1) * passes

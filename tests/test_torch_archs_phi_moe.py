"""Port parity, phi3.5-moe-42b-a6.6b (MoE: 16 experts top-2 at full
width; the smoke 4 experts top-2 at capacity factor 1.5): the
configuration and the continuous engine, held against ``repro`` on
converted weights at 2 layers and the ``SMALL`` widths in f32.

Tolerances, as for granite-moe (``test_torch_moe.py``): engine logits
atol 1e-4, greedy tokens equal on the pinned seed, compared at identical
batch shapes (expert capacity couples a step's tokens).
"""

import pytest
import torch

from _torch_parity import check_config_fields, engines_match, reference_params, small_cfgs
from repro_torch import configs as tconfigs

torch.set_num_threads(1)

ARCH = "phi3_5_moe_42b_a6_6b"


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs(ARCH)
    return (jcfg, tcfg) + reference_params(jcfg)


@pytest.mark.parametrize("smoke", [False, True])
def test_phi3_5_moe_config_matches_reference(smoke):
    """Every field, ``MoEConfig`` included."""
    check_config_fields(ARCH, smoke)
    cfg = tconfigs.get_config(ARCH, smoke=smoke)
    m = cfg.moe
    assert cfg.family == "moe" and not cfg.qkv_bias
    assert (m.n_experts, m.top_k, m.capacity_factor) == ((4, 2, 1.5) if smoke else (16, 2, 1.25))
    if not smoke:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
            32, 4096, 32, 8, 6400, 32064)


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("native", "int8"),
                                           ("int8", "native"), ("int8", "int8")])
def test_phi3_5_moe_engine_matches_reference(weights, wire, kv_dtype):
    """Served continuously on either wire and KV dtype: greedy tokens
    equal to the reference's continuous engine, replay logits within
    1e-4; the attention's three packed linears through #3 or #4 (the
    experts stay dense), wo and the head through #2 or #1, and the MoE
    input DAP-pruned by #5."""
    jcfg, tcfg, params, tparams = weights
    counts = engines_match(jcfg, tcfg, params, tparams, wire, kv_dtype)
    n_l = tcfg.n_layers
    passes = counts["paged_attn"][1] // n_l
    aw, dense = (("dbb_matmul_aw_int8", "dbb_matmul_int8") if wire == "int8"
                 else ("dbb_matmul_aw", "dbb_matmul"))
    assert passes > 0 and counts[aw][1] == 3 * n_l * passes
    assert counts[dense][1] == (n_l + 1) * passes
    assert counts["dap_prune"][1] == (2 if wire == "native" else 1) * n_l * passes

"""Port parity, the dense and MoE archs the reference serves
continuously beside granite, minicpm3, granite-moe and qwen2-vl, one
file an arch: here starcoder2-15b (gelu MLP, QKV bias, a sliding window,
12 query heads a KV head at full width); phi3.5-moe-42b-a6.6b and
qwen1.5-110b in ``test_torch_archs_phi_moe.py`` and
``test_torch_archs_qwen1_5.py``.  Held against ``repro`` on converted
weights at 2 layers and the ``SMALL`` widths in f32, with the same
seeded non-zero biases on both sides (``_torch_parity.nonzero_biases``:
both inits draw them as zeros).

The smoke window (32) never bites in the pinned prompts (9, 5 and 12
tokens plus 6 new), so both sides serve it with ``sliding_window=6``:
every request's later tokens attend past it.

Tolerances, as for the other dense archs: paged step and engine logits
atol 1e-4, greedy tokens equal on the pinned seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    check_config_fields,
    effective,
    engines_match,
    invariants_byte_exact,
    reference_params,
    small_cfgs,
    to_np,
)
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

ARCH = "starcoder2_15b"
BIAS_SEED = 12
WINDOW = 6  # the window of the CPU gates: it bites in the pinned prompts


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs(ARCH, sliding_window=WINDOW)
    return (jcfg, tcfg) + reference_params(jcfg, bias_seed=BIAS_SEED)


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("smoke", [False, True])
def test_starcoder2_config_matches_reference(smoke):
    """Every field, the window and the gelu MLP included."""
    check_config_fields(ARCH, smoke)
    cfg = tconfigs.get_config(ARCH, smoke=smoke)
    assert cfg.family == "dense" and cfg.mlp_act == "gelu" and cfg.qkv_bias
    assert cfg.sliding_window == (32 if smoke else 4096)
    if not smoke:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
            40, 6144, 48, 4, 24576, 49152)
        assert cfg.n_heads // cfg.n_kv_heads == 12


# -------------------------------------------------------- the window bites


def test_starcoder2_window_bites_in_paged_step(weights):
    """A 12-token prefill chunk, then a decode token, on starcoder2 with
    window 6 (native wire, int8 KV): logits within 1e-4 of the
    reference's, and the window moves them (full attention differs)."""
    jcfg0, tcfg0, params, tparams = weights
    toks = np.random.default_rng(4).integers(0, jcfg0.vocab, (2, 12)).astype(np.int32)
    pos = np.stack([np.arange(12), np.r_[np.arange(9), [-1] * 3]]).astype(np.int32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    steps = [(toks, pos), (toks[:, :1], np.array([[12], [9]], np.int32))]
    last = {}
    for window in (WINDOW, None):
        jcfg, tcfg = effective(dataclasses.replace(jcfg0, sliding_window=window),
                               dataclasses.replace(tcfg0, sliding_window=window),
                               "int8", "native")
        jp = jengine.pack_params_for_serving(params, jcfg, "native")
        tp = tengine.pack_params_for_serving(tparams, tcfg, "native")
        jcache = jpc.make_paged_cache(jcfg, 5, 8)
        tcache = tpc.make_paged_cache(tcfg, 5, 8, "cpu")
        for t, p in steps:
            want, jcache = jlm.paged_step(jp, jcache, jnp.asarray(t), jnp.asarray(p),
                                          jnp.asarray(tables), jcfg)
            got, tcache = tlm.paged_step(tp, tcache, torch.from_numpy(t), torch.from_numpy(p),
                                         torch.from_numpy(tables), tcfg)
            valid = p >= 0
            np.testing.assert_allclose(to_np(got)[valid], np.array(want)[valid], atol=1e-4,
                                       rtol=0, err_msg=f"window {window}")
        last[window] = to_np(got)
    assert np.abs(last[WINDOW] - last[None]).max() > 1e-2


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("native", "int8"),
                                           ("int8", "native"), ("int8", "int8")])
def test_starcoder2_engine_matches_reference(weights, wire, kv_dtype):
    """Served continuously on either wire and KV dtype with non-zero
    biases and the window biting: greedy tokens equal to the reference's
    continuous engine, replay logits within 1e-4.  The gelu MLP packs
    ``up``'s input alone: five packed linears a layer (wq, wk, wv, up,
    down) through #3 or #4, up with the gelu epilogue."""
    jcfg, tcfg, params, tparams = weights
    counts = engines_match(jcfg, tcfg, params, tparams, wire, kv_dtype)
    n_l = tcfg.n_layers
    passes = counts["paged_attn"][1] // n_l
    aw, dense = (("dbb_matmul_aw_int8", "dbb_matmul_int8") if wire == "int8"
                 else ("dbb_matmul_aw", "dbb_matmul"))
    assert passes > 0 and counts[aw][1] == 5 * n_l * passes
    assert counts[dense][1] == (n_l + 1) * passes  # wo and lm_head


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_starcoder2_invariants_byte_exact(weights, wire):
    """The port's invariants byte for byte on starcoder2 with the window
    biting (the solo serves and the 20-token prefix-reuse prompt run past
    it): continuous == solo, ``decode_block`` 1 == 16, prefix reuse."""
    _, tcfg, _, tparams = weights
    counts, _ = invariants_byte_exact(tcfg, tparams, wire, "int8")
    assert counts["paged_attn"][1] > 0

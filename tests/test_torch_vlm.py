"""Port parity, the VLM backbone (qwen2-vl-72b): the configuration,
M-RoPE, the paged step and the continuous engine, each held against
``repro`` on the same numpy inputs or converted weights, at 2 layers and
the ``SMALL`` widths in f32 with ``d_model`` 128 (the smoke's M-RoPE
sections (8, 4, 4) need head_dim 32, as in the reference's own test).

The arch is the first served one with QKV biases, and both inits draw
them as zeros: every weight tree here gets the same seeded non-zero
biases on both sides (``_torch_parity.nonzero_biases``).

Tolerances, with their reasons:
  * M-RoPE's section select: bit for bit against the reference's one-hot
    sum on the same per-stream tables (the sum adds exact zeros);
  * ``mrope_cos_sin`` end to end: atol 2e-6 — ATen and XLA round ``pow``
    (one inverse frequency at dh 128) and ``cos``/``sin`` differently in
    the last ulp, and at position 4e4 an ulp of an inverse frequency is
    1.6e-6 of phase;
  * paged step and engine logits: atol 1e-4, as for the other archs;
    greedy tokens equal on the pinned seed.
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
    PACKED,
    reference_params,
    small_cfgs,
    to_np,
)
from repro.models import lm as jlm
from repro.models import rope as jrope
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models import rope as trope
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

ARCH = "qwen2_vl_72b"
BIAS_SEED = 11
# (head dim, theta, sections): the full config's and the smoke's
MROPE_SHAPES = [(128, 1_000_000.0, (16, 24, 24)), (32, 10_000.0, (8, 4, 4))]


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs(ARCH)
    params, tparams = reference_params(jcfg, bias_seed=BIAS_SEED)
    return jcfg, tcfg, params, tparams


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("smoke", [False, True])
def test_qwen2_vl_config_matches_reference(smoke):
    """Every field, ``m_rope_sections`` and ``qkv_bias`` included."""
    check_config_fields(ARCH, smoke)
    cfg = tconfigs.get_config(ARCH, smoke=smoke)
    assert cfg.family == "vlm" and cfg.qkv_bias
    assert sum(cfg.m_rope_sections) == cfg.head_dim() // 2
    if not smoke:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
            80, 8192, 64, 8, 29568, 152064)
        assert cfg.m_rope_sections == (16, 24, 24) and cfg.padded_vocab == 152064


# ------------------------------------------------------------------ M-RoPE


def _streams(seed, b=3, s=17):
    """Three unequal seeded position streams ``[3, B, S]`` up to 4e4,
    padding positions (-1) included."""
    rng = np.random.default_rng(seed)
    pos3 = rng.integers(0, 40_000, (3, b, s)).astype(np.int32)
    pos3[:, 1, 11:] = -1
    pos3[2, 0, :3] = -1
    return pos3


@pytest.mark.parametrize("dh,theta,sections", MROPE_SHAPES, ids=["full", "smoke"])
def test_mrope_select_bit_exact(monkeypatch, dh, theta, sections):
    """On the same per-stream cos/sin tables the port's section select is
    the reference's one-hot sum bit for bit, on unequal streams."""
    pos3 = _streams(0)
    want_c, want_s = jrope.mrope_cos_sin(jnp.asarray(pos3), dh, theta, sections)
    tables = jrope.rope_cos_sin(jnp.asarray(pos3), dh, theta)
    monkeypatch.setattr(trope, "rope_cos_sin", lambda *a: tuple(
        torch.from_numpy(np.array(t)) for t in tables))
    got_c, got_s = trope.mrope_cos_sin(torch.from_numpy(pos3), dh, theta, sections)
    assert got_c.shape == (3, 17, dh // 2) and got_c.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got_c), np.array(want_c))
    np.testing.assert_array_equal(to_np(got_s), np.array(want_s))


@pytest.mark.parametrize("dh,theta,sections", MROPE_SHAPES, ids=["full", "smoke"])
def test_mrope_vs_reference(dh, theta, sections):
    """``mrope_cos_sin`` end to end on unequal streams: within the last
    ulp of the two frameworks' ``pow`` and ``cos``/``sin``, and each
    section from its own stream."""
    pos3 = _streams(1)
    want = jrope.mrope_cos_sin(jnp.asarray(pos3), dh, theta, sections)
    got = trope.mrope_cos_sin(torch.from_numpy(pos3), dh, theta, sections)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.array(w), atol=2e-6, rtol=0)
    cos_all, _ = trope.rope_cos_sin(torch.from_numpy(pos3), dh, theta)
    lo = 0
    for i, n in enumerate(sections):
        assert torch.equal(got[0][..., lo:lo + n], cos_all[i, ..., lo:lo + n])
        lo += n


@pytest.mark.parametrize("dh,theta,sections", MROPE_SHAPES, ids=["full", "smoke"])
def test_mrope_equal_streams_is_rope(dh, theta, sections):
    """Text tokens: three equal streams give standard RoPE bit for bit,
    in the port and in the reference."""
    pos = _streams(2)[0]
    pos3 = np.broadcast_to(pos[None], (3,) + pos.shape)
    got = trope.mrope_cos_sin(torch.from_numpy(pos).expand(3, *pos.shape), dh, theta, sections)
    for g, r in zip(got, trope.rope_cos_sin(torch.from_numpy(pos), dh, theta)):
        assert torch.equal(g, r)
    want = jrope.mrope_cos_sin(jnp.asarray(pos3), dh, theta, sections)
    for w, r in zip(want, jrope.rope_cos_sin(jnp.asarray(pos), dh, theta)):
        np.testing.assert_array_equal(np.array(w), np.array(r))


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="must sum to dh // 2 = 16"):
        trope.mrope_cos_sin(torch.zeros((3, 1, 2), dtype=torch.int32), 32, 1e4, (8, 4, 2))


# ----------------------------------------------------------------- packing


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_pack_by_columns_is_one_pack(monkeypatch, wire):
    """A linear packed a slice of output columns at a time (as qwen2-vl's
    152064-column head is, to bound the packers' temporaries) has exactly
    the bytes of one pack, a ragged last slice included."""
    from repro_torch.models import common

    _, tcfg = small_cfgs(ARCH)
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(64, 200)).astype(np.float32))
    whole = common.pack_linear_params({"w": w}, tcfg.sparsity, wire)
    monkeypatch.setattr(common, "_PACK_ELEMS", 64 * 48)  # slices of 48 columns
    sliced = common.pack_linear_params({"w": w}, tcfg.sparsity, wire)
    assert sliced.keys() == whole.keys()
    for name in whole:
        assert torch.equal(sliced[name], whole[name]), name


# -------------------------------------------------------------- paged step


def _zero_biases(tree):
    if isinstance(tree, dict):
        return {k: torch.zeros_like(v) if k == "b" else _zero_biases(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zero_biases(v) for v in tree]
    return tree


@pytest.mark.parametrize("wire,kv_dtype", [("int8", "native"), ("int8", "int8"),
                                           ("native", "native")])
def test_paged_step_vs_reference(weights, wire, kv_dtype):
    """Two steps of ``lm.paged_step`` (a mixed prefill with a padding
    tail, then one decode token a row) on converted weights with
    non-zero QKV biases: logits within 1e-4 of the reference's on the
    valid rows, and the biases move them (zeroed, the logits differ)."""
    jcfg0, tcfg0, params, tparams = weights
    jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype, wire)
    jp = jengine.pack_params_for_serving(params, jcfg, wire)
    tp = tengine.pack_params_for_serving(tparams, tcfg, wire)
    tables = np.array([[3, 0], [6, 0]], np.int32)
    steps = [
        (np.array([[5, 9, 2, 33, 7, 1], [60, 4, 18, 0, 0, 0]], np.int32),
         np.array([[0, 1, 2, 3, 4, 5], [0, 1, 2, -1, -1, -1]], np.int32)),
        (np.array([[11], [12]], np.int32), np.array([[6], [3]], np.int32)),
    ]
    jcache = jpc.make_paged_cache(jcfg, 9, 8)
    tcache = tpc.make_paged_cache(tcfg, 9, 8, "cpu")
    for toks, pos in steps:
        want, jcache = jlm.paged_step(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                                      jnp.asarray(tables), jcfg)
        got, tcache = tlm.paged_step(tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
                                     torch.from_numpy(tables), tcfg)
        valid = pos >= 0
        np.testing.assert_allclose(to_np(got)[valid], np.array(want)[valid], atol=1e-4, rtol=0)
    zeroed = tengine.pack_params_for_serving(_zero_biases(tparams), tcfg, wire)
    toks, pos = steps[0]
    base, _ = tlm.paged_step(zeroed, tpc.make_paged_cache(tcfg, 9, 8, "cpu"),
                             torch.from_numpy(toks), torch.from_numpy(pos),
                             torch.from_numpy(tables), tcfg)
    first, _ = tlm.paged_step(tp, tpc.make_paged_cache(tcfg, 9, 8, "cpu"),
                              torch.from_numpy(toks), torch.from_numpy(pos),
                              torch.from_numpy(tables), tcfg)
    assert (first - base).abs().max().item() > 1e-2


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("native", "int8"),
                                           ("int8", "native"), ("int8", "int8")])
def test_vlm_engine_matches_reference(weights, wire, kv_dtype):
    """qwen2-vl served continuously on either wire and KV dtype with
    non-zero QKV biases: greedy tokens equal to the reference's
    continuous engine (M-RoPE over three equal streams), replay logits
    within 1e-4; the biased Q/K/V through #3 or #4's epilogue."""
    jcfg, tcfg, params, tparams = weights
    counts = engines_match(jcfg, tcfg, params, tparams, wire, kv_dtype)
    aw = "dbb_matmul_aw_int8" if wire == "int8" else "dbb_matmul_aw"
    n_l = tcfg.n_layers
    passes = counts["paged_attn"][1] // n_l
    assert counts[aw][1] == 6 * n_l * passes  # wq, wk, wv, gate, up, down


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_vlm_invariants_byte_exact(weights, wire):
    """The port's invariants byte for byte on qwen2-vl with non-zero
    biases: continuous == solo, ``decode_block`` 1 == 16, prefix reuse."""
    _, tcfg, _, tparams = weights
    counts, _ = invariants_byte_exact(tcfg, tparams, wire, "int8")
    assert counts["paged_attn"][1] > 0


def test_vlm_family_is_served_and_others_raise(weights):
    """``vlm`` is admitted by the model and the engine; ``encdec`` raises,
    pointing to ``models/encdec.py``, which drives it."""
    _, tcfg, _, tparams = weights
    tengine.Engine(tparams, tcfg, tengine.ServeConfig(**PACKED), device="cpu")
    with pytest.raises(NotImplementedError, match="repro_torch.models.encdec"):
        tlm.init_params(dataclasses.replace(tcfg, family="encdec"), torch.Generator(), "cpu")

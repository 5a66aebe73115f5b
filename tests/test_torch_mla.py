"""Port parity, MLA (minicpm3-4b): kernel #6's latent mode, the paged
latent cache, ``mla_forward``'s paged branch, ``paged_step`` and the
continuous engine, each held against ``repro`` on the same numpy inputs
or converted weights, at 2 layers and the ``SMALL`` widths in f32.

Tolerances, with their reasons:
  * latent attention (#6): atol/rtol 1e-5 — the reference's own
    kernel-vs-oracle bound (``tests/test_paged_attn.py``); the sums run
    in another order;
  * ``mla_forward`` outputs and step logits: atol 1e-4 — the port's
    matmuls and absorb einsums multiply in float64 and round once, XLA
    sums in f32, and a rounding difference can move an int8 code (see
    ``test_torch_model.py``);
  * parameter trees: bit for bit; engine: greedy tokens equal on the
    pinned seed, logits within 1e-4, the port's own invariants byte-exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    effective,
    engines_match,
    invariants_byte_exact,
    leaves,
    reference_params,
    small_cfgs,
    to_np,
)
from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro.kernels.paged_attn import paged_attn_fused
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc
from test_paged_attn import make_paged_state

torch.set_num_threads(1)

ARCH = "minicpm3_4b"
N_PAGES, PS = 9, 8


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ------------------------------------------------- #6 latent mode


def _latent_inputs(seed, s, int8, lora=24, rope_d=8, h=4):
    cache, pos_tbl, tables = make_paged_state(seed, n_tokens=(7, 11), ps=4,
                                              kvd=lora + rope_d)
    if int8:  # MLA quantizes only the latent k plane
        qk, sk = jquant.quantize_rows(cache["k"])
        cache = {"k": qk, "k_scale": sk, "v": cache["v"]}
    rng = np.random.default_rng(seed + 1)
    q = jnp.asarray(rng.normal(size=(2, s, h, lora + rope_d)).astype(np.float32))
    q_pos = jnp.asarray(np.stack([np.arange(7 - s, 7), np.arange(11 - s, 11)]).astype(np.int32))
    return cache, pos_tbl, tables, q, q_pos, lora, 1.0 / math.sqrt(lora + rope_d)


@pytest.mark.parametrize("int8", [False, True], ids=["native_kv", "int8_kv"])
@pytest.mark.parametrize("s", [1, 3], ids=["decode", "chunk"])
def test_latent_attn_plain_vs_oracle_and_kernel(int8, s):
    """Kernel #6's latent plain version (``kv_heads=1``, v the latent
    prefix of the k page, an explicit softmax scale) vs the reference's
    oracle and its Pallas kernel in interpret mode."""
    cache, pos_tbl, tables, q, q_pos, lora, scale = _latent_inputs(4 + s, s, int8)
    kw = dict(kv_heads=1, softmax_scale=scale, k_scale=cache.get("k_scale"), latent_dv=lora)
    ops.reset_counters()
    got = ops.paged_attention(
        _t(q), _t(cache["k"]), _t(cache["v"]), _t(pos_tbl), _t(tables), _t(q_pos),
        kv_heads=1, softmax_scale=scale,
        k_scale=_t(cache["k_scale"]) if int8 else None, latent_dv=lora,
    )
    c = ops.counters()["paged_attn_latent"]
    assert (c.launches, c.plain) == (0, 1) and ops.counters()["paged_attn"].plain == 0
    assert tuple(got.shape) == (2, s, 4, lora)
    want_ref = jref.paged_attn_ref(q, cache["k"], None, pos_tbl, tables, q_pos, **kw)
    want_k = paged_attn_fused(q, cache["k"], None, pos_tbl, tables, q_pos, interpret=True, **kw)
    for want in (want_ref, want_k):
        np.testing.assert_allclose(to_np(got), np.array(want), atol=1e-5, rtol=1e-5)


def test_latent_attn_plain_vs_absorbed_gather():
    """The latent plain version vs the reference's gather path: the latent
    window gathered (``paged_read``) and attended with a full softmax at
    scale ``1/sqrt(Dk)``-independent ``softmax_scale``."""
    cache, pos_tbl, tables, q, q_pos, lora, _ = _latent_inputs(9, 2, True)
    scale = 0.37  # neither 1/sqrt(Dk) nor 1/sqrt(lora)
    lat, _, pos_win = jattn.paged_read(cache, pos_tbl, tables, dtype=jnp.float32)
    logits = jnp.einsum("bshd,btd->bhst", q, lat) * scale
    logits = logits + jattn._mask_bias(q_pos, pos_win, None)[:, None]
    want = jnp.einsum("bhst,btl->bshl", jax.nn.softmax(logits, axis=-1), lat[..., :lora])
    got = tref.paged_attn_ref(
        _t(q), _t(cache["k"]), None, _t(pos_tbl), _t(tables), _t(q_pos), kv_heads=1,
        softmax_scale=scale, k_scale=_t(cache["k_scale"]), latent_dv=lora,
    )
    np.testing.assert_allclose(to_np(got), np.array(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_make_paged_cache_mla_layout(kv_dtype):
    """The latent k plane is ``kv_lora + rope`` wide, v a 1-wide dummy, and
    only k is int8 (with its scale plane) under the int8 KV wire."""
    jcfg, tcfg = small_cfgs(ARCH)
    jcfg, tcfg = effective(jcfg, tcfg, kv_dtype, "native")
    want = jpc.make_paged_cache(jcfg, N_PAGES, PS)
    got = tpc.make_paged_cache(tcfg, N_PAGES, PS, "cpu")
    assert list(got) == list(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype), name
        np.testing.assert_array_equal(to_np(got[name]), np.array(want[name]), err_msg=name)


# ------------------------------------------------------------ params


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs(ARCH)
    params, tparams = reference_params(jcfg, seed=0)
    packed = {
        wire: (jengine.pack_params_for_serving(params, jcfg, wire),
               tengine.pack_params_for_serving(tparams, tcfg, wire))
        for wire in ("native", "int8")
    }
    return jcfg, tcfg, params, tparams, packed


def test_mla_tree_crosses_bit_exact(weights):
    """An MLA parameter tree, raw and packed on either wire, crosses
    ``params_from_numpy`` bit for bit, and the port packs the raw tree
    to exactly the reference's bytes; ``kv_up`` stays dense."""
    _, _, params, tparams, packed = weights
    raw = dict(leaves(params_from_numpy(jax.tree_util.tree_map(np.asarray, params))))
    for name, leaf in leaves(jax.tree_util.tree_map(np.asarray, params)):
        if name.startswith("/layers/"):
            for i in range(leaf.shape[0]):
                t = raw["/layers/" + str(i) + "/" + name[len("/layers/"):]]
                np.testing.assert_array_equal(to_np(t), leaf[i], err_msg=name)
    for wire, (jp, tp) in packed.items():
        want = dict(leaves(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))))
        got = dict(leaves(tp))
        assert got.keys() == want.keys(), wire
        assert "/layers/0/attn/kv_up/w" in got and "/layers/0/attn/q_up/w_vals" in got
        for name in want:
            assert got[name].dtype == want[name].dtype, (wire, name)
            np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]),
                                          err_msg=f"{wire} {name}")


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_init_params_mla_shapes_and_packing(wire):
    """``init_params`` draws MLA layers with the reference's parameter
    shapes and packs them on either wire as drawn, ``kv_up`` dense."""
    _, tcfg = small_cfgs(ARCH)
    packed = tlm.init_params(tcfg, torch.Generator().manual_seed(3), "cpu", wire_dtype=wire)
    dense = tlm.init_params(tcfg, torch.Generator().manual_seed(3), "cpu", wire_dtype=None)
    after = dict(leaves(tengine.pack_params_for_serving(dense, tcfg, wire)))
    got = dict(leaves(packed))
    assert got.keys() == after.keys()
    for name in got:
        assert torch.equal(got[name], after[name]), name
    jcfg, _ = small_cfgs(ARCH)
    jshapes = jax.eval_shape(lambda: jlm.init_lm(jcfg, jax.random.PRNGKey(0))[0])
    dense_leaves = dict(leaves(dense))
    for name, leaf in leaves(jshapes):
        if name.startswith("/layers/"):
            assert tuple(dense_leaves["/layers/0/" + name[len("/layers/"):]].shape) == \
                leaf.shape[1:], name
        else:
            assert tuple(dense_leaves[name].shape) == leaf.shape, name


# ------------------------------------------------- forward and step


def _mixed_batch():
    """Two rows: a 6-token prefill chunk and a 3-token one (padded -1)."""
    positions = np.array([[0, 1, 2, 3, 4, 5], [0, 1, 2, -1, -1, -1]], np.int32)
    tokens = np.array([[5, 9, 2, 33, 7, 1], [60, 4, 18, 0, 0, 0]], np.int32)
    tables = np.array([[3, 0], [6, 0]], np.int32)
    return tokens, positions, tables


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("native", "int8"),
                                           ("int8", "int8")])
def test_mla_forward_paged_vs_reference(weights, wire, kv_dtype):
    """``mla_forward``'s paged branch (layer 0) vs the reference's: the
    output and the latent written into the k pages."""
    jcfg0, tcfg0, _, _, packed = weights
    jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype, wire)
    jp, tp = packed[wire]
    _, positions, tables = _mixed_batch()
    x = np.random.default_rng(1).normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    jcache = jpc.make_paged_cache(jcfg, N_PAGES, PS)
    jlayer = {k: v[0] for k, v in jcache.items() if k != "pos"}
    jlayer["pos"] = jattn.paged_update_pos(jcache["pos"], jnp.asarray(positions),
                                           jnp.asarray(tables))
    want, new_kv = jattn.mla_forward(
        jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"]), jnp.asarray(x), jcfg,
        jnp.asarray(positions), cache_layer=jlayer, page_tables=jnp.asarray(tables),
    )
    tcache = tpc.make_paged_cache(tcfg, N_PAGES, PS, "cpu")
    tattn.paged_update_pos(tcache["pos"], torch.from_numpy(positions), torch.from_numpy(tables))
    tlayer = {k: v[0] for k, v in tcache.items() if k != "pos"}
    tlayer["pos"] = tcache["pos"]
    ops.reset_counters()
    got = tattn.mla_forward(
        tp["layers"][0]["attn"], torch.from_numpy(x), tcfg, torch.from_numpy(positions),
        cache_layer=tlayer, page_tables=torch.from_numpy(tables),
    )
    assert ops.counters()["paged_attn_latent"].plain == 1
    valid = positions >= 0
    np.testing.assert_allclose(to_np(got)[valid], np.array(want)[valid], atol=1e-4, rtol=0)
    k_got = tpc.make_paged_cache(tcfg, N_PAGES, PS, "cpu")["k"][0]  # untouched pages
    assert not torch.equal(tlayer["k"], k_got)  # written in place
    if kv_dtype == "native":
        np.testing.assert_allclose(to_np(tlayer["k"]), np.array(new_kv["k"]), atol=1e-5)
    else:
        got_lat = to_np(tlayer["k"]).astype(np.float32) * to_np(tlayer["k_scale"])[..., None]
        want_lat = np.array(new_kv["k"]).astype(np.float32) * np.array(new_kv["k_scale"])[..., None]
        np.testing.assert_allclose(got_lat, want_lat, atol=1e-4)
    assert tuple(tlayer["v"].shape[-1:]) == (1,) and not tlayer["v"].any()


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("int8", "int8")])
def test_mla_paged_step_vs_reference(weights, wire, kv_dtype):
    """Two paged steps (a mixed prefill step, then a decode step) through
    the whole model: logits within 1e-4, slot tables equal."""
    jcfg0, tcfg0, _, _, packed = weights
    jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype, wire)
    jp, tp = packed[wire]
    tokens, positions, tables = _mixed_batch()
    jcache = jpc.make_paged_cache(jcfg, N_PAGES, PS)
    tcache = tpc.make_paged_cache(tcfg, N_PAGES, PS, "cpu")
    steps = [(tokens, positions), (np.array([[11], [12]], np.int32),
                                   np.array([[6], [3]], np.int32))]
    jstep = jax.jit(lambda p, c, t, pos_, tab: jlm.paged_step(p, c, t, pos_, tab, jcfg))
    for toks, pos in steps:
        want, jcache = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables))
        got, tcache = tlm.paged_step(tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
                                     torch.from_numpy(tables), tcfg)
        assert got.shape == want.shape
        valid = pos >= 0
        np.testing.assert_allclose(to_np(got)[valid], np.array(want)[valid], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(to_np(tcache["pos"]), np.array(jcache["pos"]))


# ------------------------------------------------------------ engine


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("native", "int8"),
                                           ("int8", "native"), ("int8", "int8")])
def test_mla_engine_matches_reference(weights, wire, kv_dtype):
    """minicpm3 served continuously on either wire and KV dtype: tokens
    equal to the reference's continuous engine, logits within 1e-4; every
    packed linear through #1/#4 (native) or #2/#3 (int8), every
    attention through #6's latent mode and every DAP through #5: the
    dense-input linears' (q_up, wo) and the packed inputs, in the wire's
    forms."""
    jcfg, tcfg, params, tparams, _ = weights
    counts = engines_match(jcfg, tcfg, params, tparams, wire, kv_dtype)
    mm = {"native": {"dbb_matmul", "dbb_matmul_aw", "dap_prune", "dap_pack"},
          "int8": {"dbb_matmul_int8", "dbb_matmul_aw_int8", "dap_prune_int8",
                   "dap_pack_int8"}}[wire]
    assert {k for k, (_, plain) in counts.items() if plain > 0} == mm | {"paged_attn_latent"}


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_mla_native_wire_invariants_byte_exact(weights, kv_dtype):
    _, tcfg, _, tparams, _ = weights
    counts, _ = invariants_byte_exact(tcfg, tparams, "native", kv_dtype)
    assert {k for k, (_, plain) in counts.items() if plain > 0} == {
        "dbb_matmul", "dbb_matmul_aw", "paged_attn_latent", "dap_prune", "dap_pack"}


def test_minicpm3_full_config_kernel_shapes():
    """The full-width shapes the smoke holds the kernels at: q_down
    2560->768, q_up 768->3840, kv_down 2560->288, wo 2560->2560, the
    latent page 288 wide with a 256-wide v prefix."""
    cfg = tconfigs.get_config(ARCH)
    m = cfg.mla
    assert cfg.padded_vocab == 73472 and cfg.n_layers == 62
    assert (m.q_lora_rank, cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)) == (768, 3840)
    assert cfg.kv_dim() == 288 and m.kv_lora_rank == 256
    assert cfg.n_heads * m.v_head_dim == 2560

"""Port parity, model: packed parameters, one decoder block and the paged
model step, held against ``repro`` on the same converted weights.

Tolerances: packed bytes are integer work, compared bit for bit.  Block
outputs and step logits are compared at atol 1e-4: XLA and ATen round
rsqrt, pow, sin/cos and sigmoid differently in the last ulp, and a 1-ulp
f32 difference can move one per-row int8 activation rounding by a code,
which moves the outputs by far more than an ulp — but stays within 1e-4
on these pinned seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import effective, leaves, reference_params, small_cfgs, to_np
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

N_PAGES, PS = 9, 8


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small_cfgs()
    params, tparams = reference_params(jcfg, seed=0)
    # eager, as the reference Engine packs: under jit XLA folds the
    # scale's amax / 127 into amax * (1 / 127), one ulp off in places
    jpacked = jengine.pack_params_for_serving(params, jcfg, "int8")
    tpacked = tengine.pack_params_for_serving(tparams, tcfg, "int8")
    return jcfg, tcfg, jpacked, tpacked


def test_packed_params_bit_exact(setup):
    """The port packs the converted raw weights to exactly the bytes the
    reference packs (values, bitmasks, per-channel scales)."""
    _, _, jpacked, tpacked = setup
    want = dict(leaves(params_from_numpy(jax.tree_util.tree_map(np.asarray, jpacked))))
    got = dict(leaves(tpacked))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]), err_msg=name)


def test_init_params_packs_as_drawn():
    """``init_params(wire_dtype="int8")`` packs each layer as it is drawn,
    byte-identical to packing the whole dense draw afterwards, with the
    reference's parameter shapes."""
    _, tcfg = small_cfgs()
    packed = tlm.init_params(tcfg, torch.Generator().manual_seed(3), "cpu", wire_dtype="int8")
    dense = tlm.init_params(tcfg, torch.Generator().manual_seed(3), "cpu", wire_dtype=None)
    after = dict(leaves(tengine.pack_params_for_serving(dense, tcfg, "int8")))
    got = dict(leaves(packed))
    assert got.keys() == after.keys()
    for name in got:
        assert torch.equal(got[name], after[name]), name
    jcfg, _ = small_cfgs()
    jshapes = jax.eval_shape(lambda: jlm.init_lm(jcfg, jax.random.PRNGKey(0))[0])
    dense_leaves = dict(leaves(dense))
    assert len(dense_leaves) == len(jax.tree_util.tree_leaves(jshapes)) + (
        tcfg.n_layers - 1
    ) * len(jax.tree_util.tree_leaves(jshapes["layers"]))
    for name, leaf in leaves(jshapes):
        if name.startswith("/layers/"):
            got = dense_leaves["/layers/0/" + name[len("/layers/"):]]
            assert tuple(got.shape) == leaf.shape[1:], name
        else:
            assert tuple(dense_leaves[name].shape) == leaf.shape, name


def _mixed_batch():
    """Two rows: a 6-token prefill chunk and a 3-token one (padded -1)."""
    positions = np.array([[0, 1, 2, 3, 4, 5], [0, 1, 2, -1, -1, -1]], np.int32)
    tokens = np.array([[5, 9, 2, 33, 7, 1], [60, 4, 18, 0, 0, 0]], np.int32)
    tables = np.array([[3, 0], [6, 0]], np.int32)
    return tokens, positions, tables


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_decoder_block_vs_reference(setup, kv_dtype):
    jcfg0, tcfg0, jpacked, tpacked = setup
    jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype)
    tokens, positions, tables = _mixed_batch()
    x = np.random.default_rng(1).normal(size=(2, 6, jcfg.d_model)).astype(np.float32)

    jcache = jpc.make_paged_cache(jcfg, N_PAGES, PS)
    pos = jattn.paged_update_pos(jcache["pos"], jnp.asarray(positions), jnp.asarray(tables))
    jlayer = {k: v[0] for k, v in jcache.items() if k != "pos"}
    jlayer["pos"] = pos
    cos_sin = jlm._rope_cs(jcfg, jnp.asarray(positions))
    want, _, _ = jax.jit(
        lambda p, x_, pos_, c, t, cs: jblocks.decoder_block(
            p, x_, jcfg, pos_, cache_layer=c, page_tables=t, rope_cs=cs
        )
    )(_layer0(jpacked["layers"]), jnp.asarray(x), jnp.asarray(positions), jlayer,
      jnp.asarray(tables), cos_sin)

    tcache = tpc.make_paged_cache(tcfg, N_PAGES, PS, "cpu")
    tpos, ttab = torch.from_numpy(positions), torch.from_numpy(tables)
    tattn.paged_update_pos(tcache["pos"], tpos, ttab)
    tlayer = {k: v[0] for k, v in tcache.items() if k != "pos"}
    tlayer["pos"] = tcache["pos"]
    got = tblocks.decoder_block(
        tpacked["layers"][0], torch.from_numpy(x), tcfg, tpos,
        cache_layer=tlayer, page_tables=ttab,
    )
    valid = positions >= 0
    np.testing.assert_allclose(to_np(got)[valid], np.array(want)[valid], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_paged_step_logits_vs_reference(setup, kv_dtype):
    """Two steps of ``lm.paged_step``: a mixed prefill, then one decode
    token per row, logits vs the reference on the valid rows."""
    jcfg0, tcfg0, jpacked, tpacked = setup
    jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype)
    tokens, positions, tables = _mixed_batch()
    jcache = jpc.make_paged_cache(jcfg, N_PAGES, PS)
    tcache = tpc.make_paged_cache(tcfg, N_PAGES, PS, "cpu")
    scrub = np.array([3, 6], np.int32)
    steps = [
        (tokens, positions, scrub),
        (np.array([[11], [12]], np.int32), np.array([[6], [3]], np.int32), None),
    ]
    jstep = jax.jit(
        lambda p, c, t, pos_, tab, scr: jlm.paged_step(p, c, t, pos_, tab, jcfg, scrub_pages=scr)
    )
    for toks, pos, scr in steps:
        want, jcache = jstep(
            jpacked, jcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables),
            None if scr is None else jnp.asarray(scr),
        )
        got, tcache = tlm.paged_step(
            tpacked, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(tables), tcfg,
            scrub_pages=None if scr is None else torch.from_numpy(scr),
        )
        assert got.shape == want.shape
        valid = pos >= 0
        np.testing.assert_allclose(to_np(got)[valid], np.array(want)[valid], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(to_np(tcache["pos"]), np.array(jcache["pos"]))


def test_unported_family_raises():
    _, tcfg = small_cfgs()
    with pytest.raises(NotImplementedError, match="family 'encdec' is not served"):
        tlm.init_params(dataclasses.replace(tcfg, family="encdec"), torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="family 'audio' is not ported"):
        tlm.init_params(dataclasses.replace(tcfg, family="audio"), torch.Generator(), "cpu")

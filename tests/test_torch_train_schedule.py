"""The W-DBB schedule, the weight-decay rule and gradient compression of
the port against the JAX reference on the CPU, on the reference's
stacked-leaf rules.

The reference decides on its stacked ``[L, ...]`` leaves: with ``L % 8
== 0`` its per-layer vectors (norm scales, biases, mamba2's ``A_log``,
``D``, ``dt_bias``, ``conv_b``) are W-DBB-masked *along the layer axis*;
every per-layer leaf is weight-decayed (rank >= 2 stacked), ``final_norm``
is not; and one compression scale covers all L layers of a leaf.  So the
configs here have 8 layers, and their leaves are redrawn from a seeded
normal (the inits draw many equal values: ones, zeros, ``log(1..H)``).
Masks, pruned weights and compressed gradients are bit for bit (the
compression eager on both sides: no jit folds the reference's division by
127); the optimizer's update within 1e-6 (f32 sums in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbb as jdbb
from repro.core import schedule as jschedule
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.core import dbb as tdbb
from repro_torch.core import schedule as tschedule
from repro_torch.core import tree
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt

from _torch_parity import small_cfgs, to_np
from _torch_train import assert_trees_close, np_tree, port_tree, reference_init

SPARE = ("embed", "router", "norm", "ln")


def _jpred(path, w):
    names = "/".join(str(getattr(k, "key", k)) for k in path)
    return not any(s in names for s in SPARE)


def _tpred(path, w):
    return not any(s in path for s in SPARE)


def _random_tree(jtree, seed):
    """Every float leaf redrawn from a seeded normal, ties kept at a few
    places (small integers in a tenth of the elements)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            return a
        x = rng.normal(size=a.shape)
        ties = rng.random(a.shape) < 0.1
        x[ties] = np.round(x[ties])
        return x.astype(a.dtype)

    return jax.tree_util.tree_map(draw, np_tree(jtree))


def _eight_layer(arch):
    jcfg, tcfg = small_cfgs(arch, n_layers=8)
    params, _ = reference_init(jcfg, bias_seed=11)
    np_params = _random_tree(params, 3)
    return jcfg, tcfg, np_params


ARCHS = ["mamba2_130m", "starcoder2_15b"]


def test_schedule_matches_reference():
    js = jschedule.WDBBSchedule(jdbb.DBBConfig(4, 8), begin_step=2, end_step=10, update_every=3)
    ts = tschedule.WDBBSchedule(tdbb.DBBConfig(4, 8), begin_step=2, end_step=10, update_every=3)
    for step in range(14):
        assert ts.cfg_at(step) == tdbb.DBBConfig(js.cfg_at(step).nnz, 8), step
        assert ts.should_update(step) == js.should_update(step), step
        np.testing.assert_allclose(float(ts.nnz_at(step)), float(js.nnz_at(step)), rtol=1e-7,
                                   err_msg=str(step))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("nnz", [4, 6])
@pytest.mark.parametrize("predicate", ["trainer", "none"])
def test_wdbb_masks_on_eight_layers(arch, nnz, predicate):
    """Masks and pruned weights bit for bit; without a predicate the
    per-layer vectors are masked along the layer axis (the rule bites)."""
    jcfg, tcfg, np_params = _eight_layer(arch)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = port_tree(np_params)
    cfg_j, cfg_t = jdbb.DBBConfig(nnz, 8), tdbb.DBBConfig(nnz, 8)
    jpred, tpred = (_jpred, _tpred) if predicate == "trainer" else (None, None)
    jm = jschedule.wdbb_masks(jp, cfg_j, predicate=jpred)
    tm = tschedule.wdbb_masks(tp, cfg_t, predicate=tpred)
    assert_trees_close(tm, jm, atol=0, rtol=0, what="masks")
    assert_trees_close(tschedule.prune_weights(tp, cfg_t, predicate=tpred),
                       jschedule.prune_weights(jp, cfg_j, predicate=jpred), atol=0, rtol=0,
                       what="pruned")
    assert_trees_close(tschedule.apply_masks(tp, tm), jschedule.apply_masks(jp, jm), atol=0,
                       rtol=0, what="applied")
    layer_vectors = [g for g in tree.groups(tm) if g.stacked and g.pieces[0].ndim == 1]
    dropped = [g.path for g in layer_vectors if not all(bool(m.all()) for m in g.pieces)]
    if predicate == "none":
        assert dropped, "no per-layer vector was masked along the layer axis"
    else:  # the trainer's predicate spares the norms, not the biases and SSM vectors
        assert all(not any(s in "/".join(p) for s in SPARE) for p in dropped)


def test_layer_axis_rule_needs_eight_layers():
    """With 2 layers (L % 8 != 0) the per-layer vectors are not eligible,
    on both sides."""
    jcfg, tcfg = small_cfgs("mamba2_130m")
    params, _ = reference_init(jcfg)
    np_params = _random_tree(params, 4)
    jm = jschedule.wdbb_masks(jax.tree_util.tree_map(jnp.asarray, np_params), jdbb.DBBConfig(4, 8))
    tm = tschedule.wdbb_masks(port_tree(np_params), tdbb.DBBConfig(4, 8))
    assert_trees_close(tm, jm, atol=0, rtol=0, what="masks")
    for g in tree.groups(tm):
        if g.stacked and g.pieces[0].ndim == 1:
            assert all(bool(m.all()) for m in g.pieces), g.path


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_on_stacked_rank(arch):
    """Zero gradients: AdamW moves a param by its decay alone.  Every
    per-layer leaf (norms included: ``[L, d]`` stacked) is decayed,
    ``final_norm`` is not; the update equals the reference's within 1e-6."""
    jcfg, tcfg, np_params = _eight_layer(arch)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = port_tree(np_params)
    jcfg_o = jopt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tcfg_o = topt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 1e-2).astype(a.dtype),
                                   np_params)
    jnew, jstate, jmet = jopt.update(jcfg_o, jax.tree_util.tree_map(jnp.asarray, grads),
                                     jopt.init(jp), jp)
    tnew, tstate, tmet = topt.update(tcfg_o, port_tree(grads), topt.init(tp), tp)
    assert_trees_close(tnew, jnew, atol=1e-6, rtol=0, what="params")
    assert_trees_close(tstate.mu, jstate.mu, atol=1e-8, rtol=0, what="mu")
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    assert float(tmet["lr"]) == float(jmet["lr"])
    zero = tree.tree_map(torch.zeros_like, tp)
    moved, _, _ = topt.update(tcfg_o, zero, topt.init(tp), tp)
    ln = moved["layers"][3]["ln"] if arch == "mamba2_130m" else moved["layers"][3]["ln1"]
    ln0 = tp["layers"][3]["ln"] if arch == "mamba2_130m" else tp["layers"][3]["ln1"]
    assert not torch.equal(ln["scale"], ln0["scale"]), "a per-layer norm was not decayed"
    assert torch.equal(moved["final_norm"]["scale"], tp["final_norm"]["scale"])


@pytest.mark.parametrize("arch", ARCHS)
def test_compress_tree_bit_exact(arch):
    """One scale per stacked leaf, shared by the port's per-layer pieces:
    codes, scales, residuals and the decompressed tree bit for bit with
    the reference called eagerly."""
    jcfg, tcfg, np_params = _eight_layer(arch)
    rng = np.random.default_rng(9)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * rng.uniform(0.1, 10)).astype(a.dtype), np_params)
    res = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32),
                                 np_params)
    jq, jr = jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, grads),
                                 jax.tree_util.tree_map(jnp.asarray, res))
    tq, tr = tcomp.compress_tree(port_tree(grads), port_tree(res))
    assert_trees_close(tr, jr, atol=0, rtol=0, what="residuals")
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    jcodes = jax.tree_util.tree_map(lambda qs: np.asarray(qs[0]), jq, is_leaf=is_pair)
    assert_trees_close(tree.tree_map(lambda qs: qs[0], tq), jcodes, atol=0, rtol=0, what="codes")
    jscale = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda qs: float(qs[1]), jq, is_leaf=is_pair))
    for g, s in zip(tree.groups(tree.tree_map(lambda qs: qs[1], tq)), jscale):
        assert all(float(x) == s for x in g.pieces), g.path
        assert all(x is g.pieces[0] for x in g.pieces), g.path  # one scale tensor a group
    assert_trees_close(tcomp.decompress_tree(tq), jcomp.decompress_tree(jq), atol=0, rtol=0,
                       what="decompressed")
    q, s = tcomp.quantize(torch.tensor([0.0, -2.54, 1.0]))
    jq1, js1 = jcomp.quantize(jnp.asarray([0.0, -2.54, 1.0]))
    assert to_np(q).tolist() == np.asarray(jq1).tolist() and float(s) == float(js1)
    assert torch.equal(tcomp.dequantize(q, s), torch.from_numpy(np.array(
        jcomp.dequantize(jq1, js1))))


def test_init_residuals_and_opt_state_shapes():
    jcfg, tcfg = small_cfgs("granite_3_8b")
    _, tp = reference_init(jcfg)
    r = tcomp.init_residuals(tp)
    st = topt.init(tp)
    for p, a, b, c in zip(tree.leaves(tp), tree.leaves(r), tree.leaves(st.mu), tree.leaves(st.nu)):
        assert a.shape == b.shape == c.shape == p.shape
        assert a.dtype == b.dtype == c.dtype == torch.float32
        assert not (a.any() or b.any() or c.any())
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    cfg = dataclasses.replace(tcfg, remat="dots")
    assert cfg.remat == "dots"

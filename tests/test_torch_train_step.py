"""The port's training step against the JAX reference on the CPU.

* The straight-through DAP gradient (``core/dap.DAPSTE``) against
  ``jax.vjp`` of ``repro.core.dap.dap``, bit for bit, forward and
  backward, on blocks holding exact zeros, -0.0, ties, a NaN and
  infinities (a block with fewer than NNZ non-zeros selects its
  lowest-index zeros; a NaN block selects nothing).
* ``loss_fn`` on the reference's own cases (``tests/test_train_loss.py``):
  a padded vocabulary, -1 labels, the VLM prefix, the MoE aux loss.
* Gradients of ``loss_fn`` and one ``train_step`` with W-DBB masks, and
  one with error-feedback residuals: grads, moments, params, grad_norm,
  lr and the metrics.

Tolerances (f32, converted weights, seeded numpy batches): loss and
metrics within 1e-5 relative (XLA and ATen sum in other orders);
gradients and moments within 1e-4 of each leaf's largest magnitude
(``mu`` is 0.1 g, ``nu`` 0.05 g^2 after one step); params within 1e-4
absolute at lr 1e-3: AdamW's first step divides each moment by its own
root, so an element whose gradient is within a few eps (1e-8) of zero
moves by up to lr times a rounding difference (3.2e-5 observed).  The
masks are bit for bit.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import dbb as jdbb
from repro.core import schedule as jschedule
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.core import dbb as tdbb
from repro_torch.core import schedule as tschedule
from repro_torch.core import tree
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

from _torch_parity import small_cfgs, to_np
from _torch_train import (
    assert_trees_close,
    batch_for,
    check_step,
    jbatch,
    np_tree,
    port_grads,
    port_tree,
    reference_init,
    scaled_close,
    tbatch,
)

# the modules: ``core.dap`` is the function, as in the reference
tdap = importlib.import_module("repro_torch.core.dap")
jdap = importlib.import_module("repro.core.dap")

# ``repro.core`` re-exports the function ``dap``, which shadows its module

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _ste_input(dtype, seed=0):
    """[6, 64] with the hard blocks planted in row 0 and small-integer ties
    with sprinkled zeros in rows 1-2."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    nan, inf = np.float32("nan"), np.float32("inf")
    x[0, 0:8] = [3.0, -3.0, 0.0, -0.0, 0.0, -3.0, 1.0, 0.0]  # 4 non-zeros, ties
    x[0, 8:16] = 0.0  # all zeros: the first NNZ zeros selected
    x[0, 16:24] = [0, 0, 0, -0.0, 0, 0, 5, 0]  # one non-zero
    x[0, 24:32] = [1.0, nan, 2.0, 0, 0, 0, 0, 0]  # NaN: nothing selected
    x[0, 32:40] = 2.0  # all tied
    x[0, 40:48] = -0.0
    x[0, 48:56] = [inf, -inf, 1.0, 0.0, -inf, 2.0, 0.0, inf]
    x[1:3] = rng.integers(-2, 3, size=(2, 64)).astype(np.float32)
    x[3, ::2] = 0.0
    x[4, 1::3] = -0.0
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.uint32)


def _torch_from(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _numpy_of(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("nnz", [1, 2, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ste_matches_reference_vjp(nnz, dtype):
    x = _ste_input(dtype)
    g = np.random.default_rng(1).normal(size=x.shape).astype(x.dtype)
    want_y, vjp = jax.vjp(lambda a: jdap.dap(a, nnz, 8), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = _torch_from(x).requires_grad_(True)
    y = tdap.apply_dap(xt, tdap.DAPSpec(nnz=nnz))
    y.backward(_torch_from(g))
    np.testing.assert_array_equal(_bits(_numpy_of(y)), _bits(want_y))
    np.testing.assert_array_equal(_bits(_numpy_of(xt.grad)), _bits(want_g))
    # the derived selection is the reference's cascade, zeros and NaN blocks included
    sel = tdap.selection_mask(xt.detach(), y.detach(), nnz, 8)
    np.testing.assert_array_equal(
        to_np(sel), np.asarray(jdbb.topk_block_mask(jnp.asarray(x), jdbb.DBBConfig(nnz, 8))))


def test_ste_dense_bypass_and_no_grad_path():
    """NNZ == BZ is the identity with the identity gradient; without a
    gradient the forward is ``ops.dap_prune`` alone, the same bits."""
    x = torch.from_numpy(_ste_input("float32")).requires_grad_(True)
    assert tdap.apply_dap(x, tdap.DAPSpec(nnz=8)) is x
    with torch.no_grad():
        a = tdap.apply_dap(x, tdap.DAPSpec(nnz=4))
    b = tdap.apply_dap(x, tdap.DAPSpec(nnz=4))
    assert b.requires_grad and not a.requires_grad
    assert torch.equal(a.view(torch.int32), b.detach().view(torch.int32))


# ------------------------------------------------------------------ loss_fn


def _loss_pair(jcfg, tcfg, params, tparams, batch):
    jl, jm = jts.loss_fn(params, jbatch(batch), jcfg)
    with torch.no_grad():
        tl, tm = tts.loss_fn(tparams, tbatch(batch), tcfg)
    return float(jl), {k: float(v) for k, v in jm.items()}, float(tl), {
        k: float(v) for k, v in tm.items()}


def test_loss_vocab_padding_masked():
    """vocab 500 padded to 512: the port's loss equals the reference's, and
    huge padded-column logits leave it unchanged."""
    jcfg, tcfg = small_cfgs("granite_3_8b", vocab=500)
    assert tcfg.padded_vocab == 512
    params, tparams = reference_init(jcfg)
    batch = batch_for(jcfg, s=16)
    jl, _, tl, _ = _loss_pair(jcfg, tcfg, params, tparams, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    tparams["lm_head"]["w"][:, tcfg.vocab:] = 100.0
    with torch.no_grad():
        tl2, _ = tts.loss_fn(tparams, tbatch(batch), tcfg)
    np.testing.assert_allclose(float(tl2), tl, rtol=1e-5)


def test_loss_negative_labels_ignored():
    jcfg, tcfg = small_cfgs("granite_3_8b")
    params, tparams = reference_init(jcfg)
    batch = batch_for(jcfg)
    batch["labels"][:, 8:] = -1
    jl, jm, tl, tm = _loss_pair(jcfg, tcfg, params, tparams, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in ("ce", "acc"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7)
    batch["labels"][:] = -1
    _, _, tl_none, _ = _loss_pair(jcfg, tcfg, params, tparams, batch)
    assert tl_none == 0.0  # only the (zero) aux remains


def test_loss_vlm_prefix_carries_no_loss():
    jcfg, tcfg = small_cfgs("qwen2_vl_72b")
    params, tparams = reference_init(jcfg)
    batch = batch_for(jcfg)  # 8 patch embeddings, three equal M-RoPE streams
    jl, jm, tl, tm = _loss_pair(jcfg, tcfg, params, tparams, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tm["acc"], jm["acc"], rtol=1e-5)


def test_loss_moe_aux():
    jcfg, tcfg = small_cfgs("granite_moe_1b_a400m")
    params, tparams = reference_init(jcfg)
    batch = batch_for(jcfg)
    jl, jm, tl, tm = _loss_pair(jcfg, tcfg, params, tparams, batch)
    assert tm["aux"] > 0
    np.testing.assert_allclose(tm["aux"], jm["aux"], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tl, tm["ce"] + tm["aux"], rtol=1e-6)


# ------------------------------------------------------------- the step


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_moe_1b_a400m"])
def test_grads_match_reference(arch):
    jcfg, tcfg = small_cfgs(arch)
    params, tparams = reference_init(jcfg)
    batch = batch_for(jcfg)
    (_, _), jg = jax.value_and_grad(jts.loss_fn, has_aux=True)(params, jbatch(batch), jcfg)
    scaled_close(port_grads(tcfg, tparams, batch), jg, 1e-4, "grads")


def _reference_step(jcfg, params, batch, **kw):
    fn = jax.jit(functools.partial(jts.train_step, cfg=jcfg, opt_cfg=jopt.OptimizerConfig(**OPT)))
    return fn(params, jopt.init(params), jbatch(batch), **kw)


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_moe_1b_a400m", "starcoder2_15b"])
def test_train_step_with_masks(arch):
    """Masks at 4/8 under the trainer's predicate, the same on both sides
    bit for bit; masked-off params stay exactly zero after the step."""
    jcfg, tcfg = small_cfgs(arch)
    params, tparams = reference_init(jcfg, bias_seed=5)
    batch = batch_for(jcfg)
    spare = ("embed", "router", "norm", "ln")
    jmasks = jschedule.wdbb_masks(
        params, jdbb.DBBConfig(4, 8),
        predicate=lambda path, w: not any(
            s in "/".join(str(getattr(k, "key", k)) for k in path) for s in spare))
    tmasks = tschedule.wdbb_masks(tparams, tdbb.DBBConfig(4, 8),
                                  predicate=lambda path, w: not any(s in path for s in spare))
    assert_trees_close(tmasks, jmasks, atol=0, rtol=0, what="masks")
    jout = _reference_step(jcfg, params, batch, masks=jmasks)
    tout = tts.train_step(tparams, topt.init(tparams), tbatch(batch), cfg=tcfg,
                          opt_cfg=topt.OptimizerConfig(**OPT), masks=tmasks)
    check_step(jout, tout, jcfg)
    for p, m in zip(tree.leaves(tout[0]), tree.leaves(tmasks)):
        assert not bool(torch.any(p[~m] != 0))


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_moe_1b_a400m"])
def test_train_step_with_residuals(arch):
    """Error-feedback compression from non-zero residuals.  A new residual
    is ``g + r - dequant(quant(g + r))``: it carries the gradients'
    rounding differences, so it is held within 1e-4 of its leaf's largest
    ``|g + r|`` (the scale quantization works at; on this seed no element
    sits on a rounding boundary of the int8 grid, where it would move by a
    whole scale)."""
    jcfg, tcfg = small_cfgs(arch)
    params, tparams = reference_init(jcfg)
    batch = batch_for(jcfg)
    rng = np.random.default_rng(7)
    res = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-3,
                                 np_tree(params))
    fn = jax.jit(functools.partial(jts.train_step, cfg=jcfg,
                                   opt_cfg=jopt.OptimizerConfig(**OPT)))
    jout = fn(params, jopt.init(params), jbatch(batch),
              residuals=jax.tree_util.tree_map(jnp.asarray, res))
    tres = port_tree(res)
    tout = tts.train_step(tparams, topt.init(tparams), tbatch(batch), cfg=tcfg,
                          opt_cfg=topt.OptimizerConfig(**OPT), residuals=tres)
    assert len(jout) == len(tout) == 4
    check_step(jout, tout, jcfg)
    grads = port_grads(tcfg, tparams, batch)
    want = port_tree(jout[3])
    for g, r, got, w in zip(tree.groups(grads), tree.groups(tres), tree.groups(tout[3]),
                            tree.groups(want)):
        scale = max(float((a + b).abs().max()) for a, b in zip(g.pieces, r.pieces))
        for x, y, path in zip(got.pieces, w.pieces, g.piece_paths()):
            np.testing.assert_allclose(to_np(x), to_np(y), atol=1e-4 * scale, rtol=0,
                                       err_msg=f"residuals/{path}")


def test_make_train_step_is_the_step():
    jcfg, tcfg = small_cfgs("granite_3_8b")
    _, tparams = reference_init(jcfg)
    batch = tbatch(batch_for(jcfg))
    ocfg = topt.OptimizerConfig(**OPT)
    a = tts.make_train_step(tcfg, ocfg)(tparams, topt.init(tparams), batch)
    b = tts.train_step(tparams, topt.init(tparams), batch, cfg=tcfg, opt_cfg=ocfg)
    for x, y in zip(tree.leaves(a[0]), tree.leaves(b[0])):
        assert torch.equal(x, y)
    assert tcomp.init_residuals(tparams)["embed"]["w"].dtype == torch.float32


def test_second_step_from_converted_state():
    """The reference's state after one step (params, ``OptState`` and
    masks) converted to the port (``convert.opt_state_from_numpy``,
    ``params_from_numpy``): the port's second step equals the reference's
    second step to the tolerances above (lr past warmup, a bias
    correction of step 2)."""
    from repro_torch.convert import opt_state_from_numpy

    jcfg, tcfg = small_cfgs("granite_moe_1b_a400m")
    params, _ = reference_init(jcfg)
    b1, b2 = batch_for(jcfg, seed=1), batch_for(jcfg, seed=2)
    jmasks = jschedule.wdbb_masks(params, jdbb.DBBConfig(6, 8))
    fn = jax.jit(functools.partial(jts.train_step, cfg=jcfg, opt_cfg=jopt.OptimizerConfig(**OPT)))
    p1, s1, _ = fn(params, jopt.init(params), jbatch(b1), masks=jmasks)
    p2, s2, m2 = fn(p1, s1, jbatch(b2), masks=jmasks)
    ts1 = opt_state_from_numpy(np.asarray(s1.step), np_tree(s1.mu), np_tree(s1.nu))
    assert int(ts1.step) == 1 and ts1.step.dtype == torch.int32
    tp2, ts2, tm2 = tts.train_step(port_tree(p1), ts1, tbatch(b2), cfg=tcfg,
                                   opt_cfg=topt.OptimizerConfig(**OPT), masks=port_tree(jmasks))
    assert int(ts2.step) == 2
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm2[k]), float(m2[k]), rtol=1e-5, err_msg=k)
    scaled_close(ts2.mu, s2.mu, 1e-4, "mu")
    scaled_close(ts2.nu, s2.nu, 2e-4, "nu")
    assert_trees_close(tp2, p2, atol=1e-4, rtol=0, what="params")

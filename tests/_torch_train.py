"""Shared set-up of the port's training tests: reference trees (numpy
leaves) in the port's layout, leaf-by-leaf comparisons with stated
tolerances, seeded batches, and the DAP selections of a forward pass on
both sides (to name a site whose Top-NNZ selection differs)."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import dbb as jdbb
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.convert import params_from_numpy
from repro_torch.core import tree
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

from _torch_parity import leaves, nonzero_biases, small_cfgs, to_np

# the module: ``repro_torch.core.dap`` is the function, as in the reference
tdap = importlib.import_module("repro_torch.core.dap")


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def port_tree(jtree):
    """A reference tree (jax or numpy leaves) in the port's layout, on the CPU."""
    return params_from_numpy(np_tree(jtree), "cpu")


def assert_trees_close(got, want_ref, *, atol, rtol, what):
    """Every leaf of the port tree ``got`` against the reference tree
    ``want_ref`` (converted), path by path; ``atol=rtol=0`` is bit for bit
    (NaN equal to NaN)."""
    want = port_tree(want_ref)
    got_l, want_l = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l], what
    for (path, g), (_, w) in zip(got_l, want_l):
        g, w = to_np(g), to_np(w)
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}{path}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}"
        if atol == 0 and rtol == 0:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}{path}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=atol,
                                       rtol=rtol, err_msg=f"{what}{path}")


def reference_init(jcfg, seed=0, bias_seed=None):
    """The reference's seeded params (``init_encdec`` for whisper), with
    non-zero biases when ``bias_seed`` is given: ``(jax tree, port tree)``."""
    init = jencdec.init_encdec if jcfg.family == "encdec" else jlm.init_lm
    params, _ = init(jcfg, jax.random.PRNGKey(seed))
    np_params = np_tree(params)
    if bias_seed is not None:
        np_params = nonzero_biases(np_params, bias_seed)
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return params, params_from_numpy(np_params, "cpu")


def batch_for(cfg, b=2, s=16, seed=1):
    """A seeded numpy batch for ``cfg``: tokens and labels (a few labels
    -1), plus whisper's frames, or the VLM's 8 patch embeddings and its
    three equal M-RoPE streams."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(b, 8, cfg.d_model)).astype(np.float32)
        batch["pos3"] = np.broadcast_to(np.arange(s + 8, dtype=np.int32), (3, b, s + 8)).copy()
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def reference_selections(monkeypatch, params, batch, jcfg):
    """The Top-NNZ selection of every DAP call of the reference's forward
    on ``batch``, in call order: the forward runs unrolled and eagerly
    (``scan_layers=False``, no remat), so each call sees its values."""
    seen = []
    orig = jcommon.apply_dap

    def spy(a, spec):
        if spec is not None and not spec.is_dense:
            seen.append(np.asarray(jdbb.topk_block_mask(a, spec.cfg)))
        return orig(a, spec)

    monkeypatch.setattr(jcommon, "apply_dap", spy)
    monkeypatch.setattr(jmoe, "apply_dap", spy)
    cfg = dataclasses.replace(jcfg, scan_layers=False, remat="none")
    b = jbatch(batch)
    if cfg.family == "encdec":
        jencdec.forward(params, b["frames"], b["tokens"], cfg)
    else:
        kw = {k: b[k] for k in ("patch_embeds", "pos3") if k in b}
        jlm.forward(params, b["tokens"], cfg, **kw)
    monkeypatch.setattr(jcommon, "apply_dap", orig)
    monkeypatch.setattr(jmoe, "apply_dap", orig)
    return seen


def port_selections(monkeypatch, params, batch, tcfg):
    """The port's Top-NNZ selection at every DAP call of its forward, in
    call order (``dap.selection_mask`` of each call's input and output)."""
    seen = []
    orig = tdap.apply_dap

    def spy(a, spec):
        out = orig(a, spec)
        if spec is not None and not spec.is_dense:
            seen.append(to_np(tdap.selection_mask(a, out, spec.nnz, spec.bz)))
        return out

    monkeypatch.setattr(tcommon, "apply_dap", spy)
    monkeypatch.setattr(tmoe, "apply_dap", spy)
    b = tbatch(batch)
    with torch.no_grad():
        if tcfg.family == "encdec":
            tencdec.forward(params, b["frames"], b["tokens"], tcfg)
        else:
            kw = {k: b[k] for k in ("patch_embeds", "pos3") if k in b}
            tlm.forward(params, b["tokens"], tcfg, **kw)
    monkeypatch.setattr(tcommon, "apply_dap", orig)
    monkeypatch.setattr(tmoe, "apply_dap", orig)
    return seen


def assert_same_selections(got, want, what):
    """Site by site, the same Top-NNZ selection; a differing site fails by
    its call index and the number of blocks it keeps differently."""
    assert len(got) == len(want), f"{what}: {len(got)} DAP calls vs the reference's {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{what}: DAP call {i} shape {g.shape} vs {w.shape}"
        diff = int(np.sum(g != w))
        assert diff == 0, f"{what}: DAP call {i} selects {diff} elements differently"


def scaled_close(got, want_ref, rel, what):
    """Every leaf within ``rel`` of its reference leaf's largest magnitude."""
    want = port_tree(want_ref)
    for g, w in zip(tree.groups(got), tree.groups(want)):
        for gp, wp, path in zip(g.pieces, w.pieces, g.piece_paths()):
            gn, wn = to_np(gp).astype(np.float64), to_np(wp).astype(np.float64)
            scale = max(np.abs(wn).max(), 1e-30)
            np.testing.assert_allclose(gn, wn, atol=rel * scale, rtol=0, err_msg=f"{what}/{path}")


def port_grads(tcfg, tparams, batch):
    """The port's gradients of ``loss_fn`` by autograd (numpy batch)."""
    flat = tree.leaves(tparams)
    req = [p.detach().requires_grad_(True) for p in flat]
    loss, _ = tts.loss_fn(tree.unflatten(tparams, req), tbatch(batch), tcfg)
    return tree.unflatten(tparams, list(torch.autograd.grad(loss, req)))


def check_step(jout, tout, jcfg):
    """One step of both sides (``(params, state, metrics[, residuals])``):
    metrics within 1e-5 relative, mu within 1e-4 and nu within 2e-4 of
    each leaf's largest, params within 1e-4 absolute."""
    (jp, js, jm), (tp, ts_, tm) = jout[:3], tout[:3]
    assert int(ts_.step) == int(js.step) == 1
    for k in ("loss", "ce", "aux", "acc", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    scaled_close(ts_.mu, js.mu, 1e-4, "mu")
    scaled_close(ts_.nu, js.nu, 2e-4, "nu")
    assert_trees_close(tp, jp, atol=1e-4, rtol=0, what="params")


STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def arch_step_matches(monkeypatch, arch):
    """One ``train_step`` of ``arch``'s small config against the reference
    (the checks of ``test_torch_train_archs.py``'s docstring)."""
    jcfg, tcfg = small_cfgs(arch)
    params, tparams = reference_init(jcfg, bias_seed=2)
    batch = batch_for(jcfg)
    assert_same_selections(port_selections(monkeypatch, tparams, batch, tcfg),
                           reference_selections(monkeypatch, params, batch, jcfg), arch)
    with torch.no_grad():
        tb = tbatch(batch)
        if tcfg.family == "encdec":
            logits, aux = tencdec.forward(tparams, tb["frames"], tb["tokens"], tcfg, with_aux=True)
        else:
            kw = {k: tb[k] for k in ("patch_embeds", "pos3") if k in tb}
            logits, aux = tlm.forward(tparams, tb["tokens"], tcfg, with_aux=True, **kw)
    assert logits.shape[-1] == tcfg.padded_vocab and bool(torch.isfinite(logits).all())
    assert aux.dtype == torch.float32 and aux.ndim == 0
    fn = jax.jit(functools.partial(jts.train_step, cfg=jcfg, opt_cfg=jopt.OptimizerConfig(**STEP_OPT)))
    jout = fn(params, jopt.init(params), jbatch(batch))
    tout = tts.train_step(tparams, topt.init(tparams), tbatch(batch), cfg=tcfg,
                          opt_cfg=topt.OptimizerConfig(**STEP_OPT))
    check_step(jout, tout, jcfg)

"""The reference's public names that the port gained last, each held
against ``repro`` on the same numpy inputs: ``core.dbb``'s
``PackedDBB``/``pack``/``unpack``/``expand_bitmask_int8``, ``core.dap.dap``
(forward and straight-through gradient), ``SparsityConfig.w_cfg`` and
``WDBB_4_8``, ``core.__init__``'s names, ``kernels.ref.pack_act_for_kernel``
with ``ops.pack_act``/``ops.quantize_act``, ``models.common.silu``,
``paged_cache.cache_nbytes`` (ring and paged caches, on real and ``meta``
tensors) and ``PageAllocator.n_slots``, and ``Scheduler.cancel``.

Tolerances: the packing, the masks, the byte counts and the scheduler
are integer work or one f32 op a value, compared bit for bit; DAP's
forward and its gradient (the kept elements times the upstream gradient,
one f32 multiply) bit for bit too; ``silu``, whose transcendental
kernels differ between XLA and ATen, within rtol/atol 1e-6 (as
``tests/test_torch_core.py`` holds the epilogue's).
"""

import dataclasses
import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import configs as jconfigs
from repro.core import dbb as jdbb
from repro.core import sparsity as jsparsity
from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.serve import paged_cache as jpaged
from repro.serve import scheduler as jsched
import repro_torch.core as tcore
from repro_torch import configs as tconfigs
from repro_torch.core import dbb as tdbb
from repro_torch.core import sparsity as tsparsity
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve import scheduler as tsched

# the modules: ``core.dap`` is the function, as in the reference
jdap = importlib.import_module("repro.core.dap")
tdap = importlib.import_module("repro_torch.core.dap")

torch.set_num_threads(1)

BITS = {np.dtype(np.float32): np.int32, np.dtype(np.int8): np.int8,
        np.dtype(np.uint8): np.uint8}


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    view = BITS.get(got.dtype, got.dtype)
    np.testing.assert_array_equal(got.view(view), want.view(view))


def _hard_input(shape, seed):
    """Small integers (magnitude ties everywhere, zeros of both signs),
    with a NaN block, an all -0.0 block and +-inf planted."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=shape).astype(np.float32)
    x[x == 0] = np.where(rng.random((x == 0).sum()) < 0.5, 0.0, -0.0)
    flat = x.reshape(-1, shape[-1])
    flat[0, :8] = [3.0, -3.0, 0.0, -0.0, np.nan, -3.0, 2.0, 1.0]
    flat[1, :8] = -0.0
    flat[2, 8:16] = [np.inf, -np.inf, 1.0, -np.inf, 2.0, np.inf, 0.5, -1.0]
    return x


# ------------------------------------------------------------ core.dbb


@pytest.mark.parametrize("assume_pruned", [False, True])
@pytest.mark.parametrize("nnz", [1, 2, 4, 5, 8])
def test_pack_unpack_bit_exact(nnz, assume_pruned):
    """``pack`` (values, int8 positions, ``k``), its ``bitmask`` and
    ``compression_ratio``, and ``unpack``, bit for bit the reference's,
    over ties, -0.0, a NaN block and infinities; an already pruned tensor
    round-trips exactly."""
    cfg_j, cfg_t = jdbb.DBBConfig(nnz, 8), tdbb.DBBConfig(nnz, 8)
    x = _hard_input((3, 5, 32), nnz)
    if assume_pruned:
        x = np.array(jdbb.prune(jnp.asarray(x), cfg_j))
    pj = jdbb.pack(jnp.asarray(x), cfg_j, assume_pruned=assume_pruned)
    pt = tdbb.pack(torch.from_numpy(x), cfg_t, assume_pruned=assume_pruned)
    assert isinstance(pt, tcore.PackedDBB) and pt.k == pj.k == 32
    _same_bits(pt.values.numpy(), pj.values)
    _same_bits(pt.indices.numpy(), pj.indices)
    _same_bits(pt.bitmask.numpy(), pj.bitmask)
    assert pt.compression_ratio() == pj.compression_ratio()
    _same_bits(tdbb.unpack(pt).numpy(), jdbb.unpack(pj))
    # nnz distinct positions a block
    idx = pt.indices.numpy().reshape(-1, nnz)
    assert all(len(set(row)) == nnz for row in idx.tolist())
    if assume_pruned:
        clean = np.isfinite(x).reshape(-1, 4, 8).all(-1).reshape(3, 5, 4)
        back = tdbb.unpack(pt).numpy().reshape(3, 5, 4, 8)
        np.testing.assert_array_equal(back[clean], x.reshape(3, 5, 4, 8)[clean])


@pytest.mark.parametrize("scale_axis", [None, (-2, -1)])
def test_expand_bitmask_int8_bit_exact(scale_axis):
    """``expand_bitmask_int8`` on the reference's own int8 wire (per
    tensor and per row), into f32 and bf16, bit for bit."""
    x = np.random.default_rng(3).normal(size=(6, 64)).astype(np.float32)
    x[0, :8] = [0.5, -0.5, 0.0, -0.0, 0.5, -0.5, 1.0, 1.0]
    q, mask, scale = jdbb.pack_bitmask_int8(jnp.asarray(x), jdbb.DBBConfig(4, 8),
                                            scale_axis=scale_axis)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jdbb.expand_bitmask_int8(q, mask, scale, jdbb.DBBConfig(4, 8),
                                        scale_axis=scale_axis, dtype=jd)
        got = tdbb.expand_bitmask_int8(torch.from_numpy(np.array(q)),
                                       torch.from_numpy(np.array(mask)),
                                       torch.from_numpy(np.array(scale)), tdbb.DBBConfig(4, 8),
                                       scale_axis=scale_axis, dtype=td)
        _same_bits(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------ core.dap


@pytest.mark.parametrize("nnz", [1, 2, 4, 5])
def test_dap_forward_and_ste_gradient_bit_exact(nnz):
    """``dap(a, nnz)`` and its gradient against ``jax.grad`` of the
    reference's ``custom_vjp``: the gradient passes through the selected
    elements only, zeros of the selection included (-0.0 blocks, ties to
    the lower index)."""
    a = _hard_input((4, 24), 10 + nnz)
    a[np.isnan(a) | np.isinf(a)] = 1.0  # a finite loss
    c = np.random.default_rng(nnz).normal(size=a.shape).astype(np.float32)

    def jloss(x):
        return jnp.sum(jdap.dap(x, nnz, 8) * jnp.asarray(c))

    _same_bits(tdap.dap(torch.from_numpy(a), nnz, 8).numpy(), jdap.dap(jnp.asarray(a), nnz, 8))
    want = jax.grad(jloss)(jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    (got,) = torch.autograd.grad((tdap.dap(at, nnz, 8) * torch.from_numpy(c)).sum(), at)
    _same_bits(got.numpy(), want)


def test_dap_identity_at_dense_and_apply_dap():
    a = torch.from_numpy(_hard_input((3, 16), 0))
    assert tdap.dap(a, 8, 8) is a
    spec = tdap.DAPSpec(4, 8)
    _same_bits(tdap.apply_dap(a, spec).numpy(), tdap.dap(a, 4, 8).numpy())
    assert tdap.apply_dap(a, None) is a


# ------------------------------------------------ sparsity and core API


def test_w_cfg_and_wdbb_4_8():
    for mode in ("dense", "wdbb", "awdbb"):
        want = jsparsity.SparsityConfig(mode=mode, w_nnz=3).w_cfg
        got = tsparsity.SparsityConfig(mode=mode, w_nnz=3).w_cfg
        assert (got is None and want is None) or (got.nnz, got.bz) == (want.nnz, want.bz)
    for name in ("DENSE", "WDBB_4_8", "AWDBB_4_8"):
        j, t = getattr(jsparsity, name), getattr(tsparsity, name)
        assert (t.mode, t.w_nnz, t.a_nnz, t.bz) == (j.mode, j.w_nnz, j.a_nnz, j.bz)


def test_core_exports_the_reference_names():
    """``repro_torch.core`` exports every public name of ``repro.core``,
    each the object of its submodule."""
    want = {n for n in vars(jcore) if not n.startswith("_")} - {
        "dbb", "dap", "quant", "schedule", "sparsity", "sampling", "tree", "prng"}
    for name in sorted(want):
        assert hasattr(tcore, name), name
    assert tcore.dap is tdap.dap and tcore.pack is tdbb.pack and tcore.WDBB_4_8 is tsparsity.WDBB_4_8


FRESH_IMPORTS = """
import importlib, pkgutil, sys
import repro_torch
for name in sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")):
    for loaded in [n for n in sys.modules if n.startswith("repro_torch.")]:
        del sys.modules[loaded]
    importlib.import_module(name)
import repro_torch.core
assert callable(repro_torch.core.dap) and repro_torch.core.PackedDBB
"""


def test_fresh_imports_have_no_cycle():
    """``core.dap`` reaches ``kernels.ops``, whose modules import
    ``core``: every module of the package may be the first one imported
    (each imported after every other ``repro_torch`` module is dropped,
    in one interpreter)."""
    subprocess.run([sys.executable, "-c", FRESH_IMPORTS], check=True, timeout=120)


# ------------------------------------------------------- kernels and models


def test_pack_act_and_quantize_act():
    x = _hard_input((5, 32), 7)
    x[~np.isfinite(x)] = 2.0
    cfg_j, cfg_t = jdbb.DBBConfig(4, 8), tdbb.DBBConfig(4, 8)
    for got, want in zip(tops.pack_act(torch.from_numpy(x), cfg_t), jops.pack_act(jnp.asarray(x), cfg_j)):
        _same_bits(got.numpy(), want)
    assert tops.pack_act is tref.pack_act_for_kernel
    for per_row in (False, True):
        got = tops.quantize_act(torch.from_numpy(x), per_row=per_row)
        want = jops.quantize_act(jnp.asarray(x), per_row=per_row)
        for g, w in zip(got, want):
            _same_bits(g.numpy(), want=w)


def test_silu_matches_reference():
    x = np.linspace(-12, 12, 257, dtype=np.float32)
    got = tcommon.silu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcommon.silu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- paged_cache


def _cfg_pair(arch, kv_dtype, smoke=True):
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    tcfg = tconfigs.get_config(arch, smoke=smoke)
    return (dataclasses.replace(jcfg, sparsity=dataclasses.replace(jcfg.sparsity, kv_dtype=kv_dtype)),
            dataclasses.replace(tcfg, sparsity=dataclasses.replace(tcfg.sparsity, kv_dtype=kv_dtype)))


@pytest.mark.parametrize("arch,kv_dtype", [
    ("granite_3_8b", "native"), ("granite_3_8b", "int8"), ("minicpm3_4b", "native"),
    ("minicpm3_4b", "int8"), ("hymba_1_5b", "int8"), ("mamba2_130m", "native")])
def test_cache_nbytes_ring_and_paged(arch, kv_dtype):
    """The ring cache's and the paged pools' bytes equal the reference's
    (GQA, MLA latent, int8 KV with its scale planes, hybrid and SSM
    state), on real tensors and on ``meta`` ones."""
    jcfg, tcfg = _cfg_pair(arch, kv_dtype)
    want = jpaged.cache_nbytes(jlm.make_cache(jcfg, 3, 40))
    assert want > 0
    for device in ("cpu", "meta"):
        assert tpaged.cache_nbytes(tlm.make_cache(tcfg, 3, 40, device)) == want
    if jcfg.family in ("ssm", "hybrid"):  # the reference pages attention-only caches
        return
    want = jpaged.cache_nbytes(jpaged.make_paged_cache(jcfg, 9, 8))
    for device in ("cpu", "meta"):
        assert tpaged.cache_nbytes(tpaged.make_paged_cache(tcfg, 9, 8, device)) == want


@pytest.mark.parametrize("arch,kv_dtype", [("granite_3_8b", "int8"), ("minicpm3_4b", "native")])
def test_cache_nbytes_full_size_without_allocating(arch, kv_dtype):
    """A full-size cache measured on ``meta`` tensors equals the
    reference's ``jax.eval_shape`` count (tens of GB; nothing allocated)."""
    jcfg, tcfg = _cfg_pair(arch, kv_dtype, smoke=False)
    want = jpaged.cache_nbytes(jax.eval_shape(lambda: jlm.make_cache(jcfg, 64, 32768)))
    assert want > 10 ** 9
    assert tpaged.cache_nbytes(tlm.make_cache(tcfg, 64, 32768, "meta")) == want
    want = jpaged.cache_nbytes(jax.eval_shape(lambda: jpaged.make_paged_cache(jcfg, 4096, 16)))
    assert tpaged.cache_nbytes(tpaged.make_paged_cache(tcfg, 4096, 16, "meta")) == want


def test_n_slots_matches_reference():
    """``n_slots`` (the pages' logical capacity) after the same script of
    ensures, a truncate and a free on both allocators."""
    ja, ta = jpaged.PageAllocator(16, 4), tpaged.PageAllocator(16, 4)
    script = [("ensure", 1, 5), ("ensure", 2, 1), ("ensure", 1, 9), ("truncate_to", 1, 4),
              ("ensure", 3, 12), ("free", 2, None), ("ensure", 2, 3)]
    for op, rid, n in script:
        for a in (ja, ta):
            if op == "ensure" and rid not in a.live():
                a.alloc(rid)
            getattr(a, op)(*((rid,) if n is None else (rid, n)))
        for rid in ja.live():
            assert ta.n_slots(rid) == ja.n_slots(rid)
    assert set(ta.live()) == set(ja.live())


# ------------------------------------------------------------ scheduler


def _drive(mod, cancels):
    """A scheduler script: five requests (two arrive later), fake sampled
    tokens, ``cancel(rid)`` at set iterations; returns the cancels' return
    values, each request's (finish reason, tokens) and the stats."""
    s = mod.Scheduler(max_batch=2, page_size=4, n_pages=24, max_pages_per_req=8,
                      prefill_chunk=4, decode_block=3)
    reqs = [mod.Request(rid=i, prompt=np.arange(3 + 2 * i, dtype=np.int32) % 50,
                        max_new_tokens=6, arrival=(0, 0, 0, 4, 6)[i]) for i in range(5)]
    for r in reqs:
        s.add(r)
    said = []
    for _ in range(80):
        for rid in cancels.get(s.iteration, ()):
            said.append((s.iteration, rid, s.cancel(rid)))
        if not s.has_work():
            break
        plan = s.plan()
        if plan is None:
            s.tick()
        elif isinstance(plan, mod.DecodeRun):
            s.commit_run(plan, np.full((2, plan.n_steps), s.iteration % 50, np.int32))
        else:
            s.commit(plan, np.full((2,), 7 + s.iteration % 40, np.int32))
    return said, [(r.finish_reason, list(r.out)) for r in reqs], s.stats()


def test_cancel_matches_reference():
    """``cancel`` marks a running, a queued and a pending (not yet
    arrived) request, each finishing ``cancelled`` at the next reap;
    an unknown rid and a finished one return False, and a cancelled one
    again False once reaped; outcomes, tokens and counters equal the
    reference scheduler's on the same script."""
    cancels = {2: (0, 2, 4, 99), 5: (0,), 12: (1,)}
    got, want = _drive(tsched, cancels), _drive(jsched, cancels)
    assert got == want
    said, outcomes, stats = got
    assert [s[2] for s in said] == [True, True, True, False, False, False]
    assert [o[0] for o in outcomes].count("cancelled") == 3
    assert stats["finished_cancelled"] == 3

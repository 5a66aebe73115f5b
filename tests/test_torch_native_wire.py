"""Port parity, native DBB wire: the plain versions of kernels #1 and #4
(``repro_torch/kernels/ref.py`` — what a CPU tensor runs, and what
``chip_smoke.py`` holds the CUDA kernels against on the card) vs the
reference's jnp oracles and its Pallas kernels in interpret mode; the
native-wire packers; and granite-3-8b served on the native wire by the
port's engine vs the reference's continuous engine (gather path).

Tolerances, with their reasons:
  * packers (``pack_weight``, ``dap_pack``, ``expand_bitmask``) and
    packed parameter trees: bit for bit — selection and copies only;
  * matmuls #1 and #4 in f32: rtol/atol 1e-5 — the plain versions
    multiply in float64 and round once, the reference sums in f32 in
    its own order;
  * engine: greedy tokens equal on the pinned seed, logits within atol
    1e-4 at every position that chose a token (see
    ``test_torch_model.py``); the port's own invariants byte-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    engines_match,
    invariants_byte_exact,
    leaves,
    reference_params,
    small_cfgs,
    to_np,
)
from repro.core import dbb as jdbb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import engine as jengine
from repro_torch.convert import params_from_numpy
from repro_torch.core import dbb as tdbb
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(to_np(got), np.array(want), rtol=tol, atol=tol)


def _operands(m, k, n, seed, nnz_w=4, nnz_a=4):
    """Native-wire operands from the reference's packers."""
    x = jnp.asarray(_rand((m, k), seed))
    w = jnp.asarray(_rand((k, n), seed + 1) / np.sqrt(k))
    b = jnp.asarray(_rand((n,), seed + 2))
    wv, wm = jops.pack_weight(w, jdbb.DBBConfig(nnz_w, 8))
    xv, xm = jops.dap_pack(x, nnz_a, 8)
    return dict(x=x, b=b, wv=wv, wm=wm, xv=xv, xm=xm)


SHAPES = [(16, 64, 128), (5, 40, 24), (3, 128, 288), (1, 256, 36)]


# ---------------------------------------------------------------- packers


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nnz", [1, 4, 8])
def test_pack_weight_and_expand_bit_exact(dtype, nnz):
    """``ops.pack_weight`` (the native wire's weight packer),
    ``ops.dap_pack`` and ``dbb.expand_bitmask`` give the reference's bytes,
    in f32 and in bf16."""
    cfg_j, cfg_t = jdbb.DBBConfig(nnz, 8), tdbb.DBBConfig(nnz, 8)
    w = jnp.asarray(_rand((48, 20), nnz)).astype(dtype)
    w = w.at[3, :8].set(0.0)  # zeros take no slot
    wv_j, wm_j = jops.pack_weight(w, cfg_j)
    wv_t, wm_t = ops.pack_weight(_t(w.astype(jnp.float32)).to(_tdtype(dtype)), cfg_t)
    np.testing.assert_array_equal(to_np(wv_t.float()), np.array(wv_j.astype(jnp.float32)))
    np.testing.assert_array_equal(to_np(wm_t), np.array(wm_j))
    x = jnp.asarray(_rand((3, 5, 32), nnz + 10)).astype(dtype)
    xv_j, xm_j = jops.dap_pack(x, nnz, 8)
    xv_t, xm_t = ops.dap_pack(_t(x.astype(jnp.float32)).to(_tdtype(dtype)), nnz, 8)
    np.testing.assert_array_equal(to_np(xv_t.float()), np.array(xv_j.astype(jnp.float32)))
    np.testing.assert_array_equal(to_np(xm_t), np.array(xm_j))
    back_j = jdbb.expand_bitmask(xv_j, xm_j, cfg_j)
    back_t = tdbb.expand_bitmask(xv_t, xm_t, cfg_t)
    np.testing.assert_array_equal(to_np(back_t.float()), np.array(back_j.astype(jnp.float32)))


def _tdtype(dtype):
    return torch.float32 if dtype is np.float32 else torch.bfloat16


# ---------------------------------------------------------------- matmuls


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("bias_act", [(False, None), (True, None), (False, "silu"),
                                      (True, "gelu")])
def test_dbb_matmul_plain_vs_oracle(m, k, n, bias_act):
    """Kernel #1's plain version vs ``ref.dbb_matmul_ref``."""
    has_bias, act = bias_act
    o = _operands(m, k, n, 10 * m + k)
    cfg_j, cfg_t = jdbb.DBBConfig(4, 8), tdbb.DBBConfig(4, 8)
    b = o["b"] if has_bias else None
    want = jref.dbb_matmul_ref(o["x"], o["wv"], o["wm"], cfg_j, bias=b, act=act)
    got = tref.dbb_matmul_ref(
        _t(o["x"]), _t(o["wv"]), _t(o["wm"]), cfg_t,
        bias=None if b is None else _t(b), act=act,
    )
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("nnz_a,act", [(4, None), (2, "silu"), (8, None)])
def test_dbb_matmul_aw_plain_vs_oracle(m, k, n, nnz_a, act):
    """Kernel #4's plain version vs ``ref.dbb_matmul_aw_ref``."""
    o = _operands(m, k, n, 10 * m + k + 1, nnz_a=nnz_a)
    cfg_a_j, cfg_w_j = jdbb.DBBConfig(nnz_a, 8), jdbb.DBBConfig(4, 8)
    cfg_a_t, cfg_w_t = tdbb.DBBConfig(nnz_a, 8), tdbb.DBBConfig(4, 8)
    want = jref.dbb_matmul_aw_ref(o["xv"], o["xm"], o["wv"], o["wm"], cfg_a_j, cfg_w_j, act=act)
    got = tref.dbb_matmul_aw_ref(
        _t(o["xv"]), _t(o["xm"]), _t(o["wv"]), _t(o["wm"]), cfg_a_t, cfg_w_t, act=act,
    )
    _close(got, want)


@pytest.mark.parametrize("kernel", ["w", "aw"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_native_plain_vs_interpret_kernel(kernel, act):
    """The plain versions vs the reference's Pallas kernels #1 and #4 run
    in interpret mode, as ``tests/test_kernels.py`` runs them."""
    o = _operands(16, 64, 128, 3)
    cfg_j, cfg_t = jdbb.DBBConfig(4, 8), tdbb.DBBConfig(4, 8)
    tiles = dict(tm=16, tk=64, tn=128)
    ops.reset_counters()
    if kernel == "w":
        want = jops.dbb_matmul(o["x"], o["wv"], o["wm"], cfg_j, impl="interpret",
                               bias=o["b"], act=act, **tiles)
        got = ops.dbb_matmul(_t(o["x"]), _t(o["wv"]), _t(o["wm"]), cfg_t, bias=_t(o["b"]),
                             act=act)
    else:
        want = jops.dbb_matmul_aw(o["xv"], o["xm"], o["wv"], o["wm"], cfg_j, cfg_j,
                                  impl="interpret", act=act, **tiles)
        got = ops.dbb_matmul_aw(_t(o["xv"]), _t(o["xm"]), _t(o["wv"]), _t(o["wm"]),
                                cfg_t, cfg_t, act=act)
    _close(got, want)
    name = "dbb_matmul" if kernel == "w" else "dbb_matmul_aw"
    assert (ops.counters()[name].launches, ops.counters()[name].plain) == (0, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_native_plain_rows_independent_of_m(dtype):
    """A row's output of the plain versions is bitwise the same alone as in
    a batch of 64 (the property the CUDA kernels keep on the card)."""
    cfg = tdbb.DBBConfig(4, 8)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 512), generator=gen).to(dtype)
    wv, wm = ops.pack_weight(torch.randn((512, 96), generator=gen).to(dtype), cfg)
    xv, xm = ops.dap_pack(x, 4, 8)
    full_w = ops.dbb_matmul(x, wv, wm, cfg, act="silu")
    full_aw = ops.dbb_matmul_aw(xv, xm, wv, wm, cfg, cfg)
    for r in (0, 37, 63):
        assert torch.equal(ops.dbb_matmul(x[r:r + 1], wv, wm, cfg, act="silu")[0], full_w[r])
        assert torch.equal(ops.dbb_matmul_aw(xv[r:r + 1], xm[r:r + 1], wv, wm, cfg, cfg)[0],
                           full_aw[r])


# ---------------------------------------------------------- params, engine


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs()
    params, tparams = reference_params(jcfg, seed=0)
    return jcfg, tcfg, params, tparams


def test_native_packed_params_bit_exact(weights):
    """The port packs the converted raw weights on the native wire to
    exactly the reference's bytes, and the reference's packed tree
    crosses ``params_from_numpy`` bit for bit."""
    jcfg, tcfg, params, tparams = weights
    jpacked = jengine.pack_params_for_serving(params, jcfg, "native")
    want = dict(leaves(params_from_numpy(jax.tree_util.tree_map(np.asarray, jpacked))))
    got = dict(leaves(tengine.pack_params_for_serving(tparams, tcfg, "native")))
    assert got.keys() == want.keys()
    assert not any(name.endswith("w_scale") for name in got)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]), err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_granite_native_wire_engine_matches_reference(weights, kv_dtype):
    """granite-3-8b on the native wire: every packed linear takes #1 or
    #4 (their plain versions here), every attention #6 in GQA mode and
    every DAP #5 (wo's input pruned, the packed inputs packed)."""
    jcfg, tcfg, params, tparams = weights
    counts = engines_match(jcfg, tcfg, params, tparams, "native", kv_dtype)
    used = {k for k, (_, plain) in counts.items() if plain > 0}
    assert used == {"dbb_matmul", "dbb_matmul_aw", "paged_attn", "dap_prune", "dap_pack"}


def test_granite_native_wire_invariants_byte_exact(weights):
    _, tcfg, _, tparams = weights
    counts, _ = invariants_byte_exact(tcfg, tparams, "native", "int8")
    assert {k for k, (_, plain) in counts.items() if plain > 0} == {
        "dbb_matmul", "dbb_matmul_aw", "paged_attn", "dap_prune", "dap_pack"}


def test_init_params_native_packs_as_drawn():
    """``init_params(wire_dtype="native")`` packs each linear as it is
    drawn, byte-identical to packing the dense draw afterwards."""
    _, tcfg = small_cfgs()
    packed = tlm.init_params(tcfg, torch.Generator().manual_seed(3), "cpu", wire_dtype="native")
    dense = tlm.init_params(tcfg, torch.Generator().manual_seed(3), "cpu", wire_dtype=None)
    after = dict(leaves(tengine.pack_params_for_serving(dense, tcfg, "native")))
    got = dict(leaves(packed))
    assert got.keys() == after.keys()
    for name in got:
        assert torch.equal(got[name], after[name]), name

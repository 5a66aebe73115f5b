"""Port parity, wire-format core: quantization, the DBB top-k cascade and
packers, the activation/weight int8 packers and the epilogue, each held
against its ``repro`` counterpart on the same numpy inputs.

Tolerances: everything here is integer work or an identical f32 op
sequence, so it is compared bit for bit — except the ``silu`` and
``gelu`` epilogues, whose transcendental kernels differ between XLA and
ATen (rtol/atol 1e-6).  Also here: the guard that the port imports
nothing of JAX, and the configuration field check."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import check_config_fields
from repro import configs as jconfigs
from repro.core import dbb as jdbb
from repro.core import quant as jquant
from repro.kernels import epilogue as jepi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import configs as tconfigs
from repro_torch.core import dbb as tdbb
from repro_torch.core import quant as tquant
from repro_torch.kernels import epilogue as tepi
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.array(x)  # a writable copy (torch.from_numpy needs one)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _with_ties(shape, seed):
    """Small-integer values: many exact magnitude ties inside a block
    (and zeros), so the low-index tie-break is exercised."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, size=shape).astype(np.float32)


# ------------------------------------------------------------------ quant


@pytest.mark.parametrize("axis", [None, -1, 0, (1, 2)])
def test_quantize_bit_exact(axis):
    x = _rand((6, 5, 8), 0, 3.0)
    x[1] = 0.0  # an all-zero slice gets scale 1.0
    x[2, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # exact .5 ties round to even
    qj, sj = jquant.quantize(jnp.asarray(x), axis=axis)
    qt, st = tquant.quantize(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(qt.numpy(), _np(qj))
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    back_j = jquant.dequantize(qj, sj, axis=axis)
    back_t = tquant.dequantize(qt, st, axis=axis)
    np.testing.assert_array_equal(back_t.numpy(), _np(back_j))


def test_quantize_rows_bit_exact():
    x = _rand((3, 7, 32), 1, 2.0)
    x[0, 3] = 0.0
    qj, sj = jquant.quantize_rows(jnp.asarray(x))
    qt, st = tquant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), _np(qj))
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    np.testing.assert_array_equal(
        tquant.dequantize_rows(qt, st).numpy(), _np(jquant.dequantize_rows(qj, sj))
    )


# -------------------------------------------------------------------- DBB


@pytest.mark.parametrize("nnz", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_block_mask_with_ties(nnz, dtype):
    x = _with_ties((5, 64), nnz)
    cfg_j, cfg_t = jdbb.DBBConfig(nnz, 8), tdbb.DBBConfig(nnz, 8)
    mj = jdbb.topk_block_mask(jnp.asarray(x).astype(dtype), cfg_j)
    mt = tdbb.topk_block_mask(torch.from_numpy(x).to(getattr(torch, dtype)), cfg_t)
    np.testing.assert_array_equal(mt.numpy(), _np(mj))


@pytest.mark.parametrize("nnz", [1, 3, 4])
@pytest.mark.parametrize("data", ["normal", "ties"])
def test_pack_bitmask_bit_exact(nnz, data):
    x = _rand((4, 3, 48), 2) if data == "normal" else _with_ties((4, 3, 48), 3)
    cfg_j, cfg_t = jdbb.DBBConfig(nnz, 8), tdbb.DBBConfig(nnz, 8)
    vj, mj = jdbb.pack_bitmask(jnp.asarray(x), cfg_j)
    vt, mt = tdbb.pack_bitmask(torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(vt.numpy(), _np(vj))
    np.testing.assert_array_equal(mt.numpy(), _np(mj))
    assert mt.dtype == torch.uint8
    for axis in (None, (-2, -1)):
        qj, mj8, sj = jdbb.pack_bitmask_int8(jnp.asarray(x), cfg_j, scale_axis=axis)
        qt, mt8, st = tdbb.pack_bitmask_int8(torch.from_numpy(x), cfg_t, scale_axis=axis)
        np.testing.assert_array_equal(qt.numpy(), _np(qj))
        np.testing.assert_array_equal(mt8.numpy(), _np(mj8))
        np.testing.assert_array_equal(st.numpy(), _np(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_weight_int8_bit_exact(dtype):
    w = _rand((64, 40), 4)
    wj = jnp.asarray(w).astype(dtype)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    for got, want in zip(
        tref.pack_weight_int8(wt, tdbb.DBBConfig(4, 8)),
        jref.pack_weight_int8(wj, jdbb.DBBConfig(4, 8)),
    ):
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("act_scale", ["per_tensor", "per_row"])
def test_dap_pack_int8_bit_exact(act_scale):
    x = _rand((2, 3, 64), 5)
    got = tops.dap_pack_int8(torch.from_numpy(x), 4, 8, act_scale=act_scale)
    want = jops.dap_pack_int8(jnp.asarray(x), 4, 8, act_scale=act_scale)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_decode_bit_exact():
    cfg_j, cfg_t = jdbb.DBBConfig(4, 8), tdbb.DBBConfig(4, 8)
    wv, wm, _ = jref.pack_weight_int8(jnp.asarray(_rand((64, 24), 6)), cfg_j)
    got = tref.decode_w(torch.from_numpy(_np(wv)), torch.from_numpy(_np(wm)), cfg_t)
    np.testing.assert_array_equal(got.numpy(), _np(jref.decode_w(wv, wm, cfg_j)))
    xv, xm, _ = jops.dap_pack_int8(jnp.asarray(_rand((3, 64), 7)), 4)
    got = tref.decode_a(torch.from_numpy(_np(xv)), torch.from_numpy(_np(xm)), cfg_t)
    np.testing.assert_array_equal(got.numpy(), _np(jref.decode_a(xv, xm, cfg_j)))


# ---------------------------------------------------------------- epilogue


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_dequant_epilogue(act):
    rng = np.random.default_rng(8)
    acc = rng.integers(-40000, 40000, size=(8, 16)).astype(np.int32)
    scale = (rng.random((8, 16)) * 1e-4).astype(np.float32)
    bias = _rand((16,), 9)
    want = _np(jepi.apply_dequant_epilogue(jnp.asarray(acc), jnp.asarray(scale), jnp.asarray(bias), act))
    got = tepi.apply_dequant_epilogue(
        torch.from_numpy(acc), torch.from_numpy(scale), torch.from_numpy(bias), act
    ).numpy()
    if act in (None, "relu"):
        np.testing.assert_array_equal(got, want)
    else:  # XLA and ATen compute sigmoid/tanh differently
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ guards


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """The port and chip_smoke.py import torch and numpy, never jax and
    nothing of the reference package."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


@pytest.mark.parametrize("smoke", [False, True])
def test_granite_config_matches_reference(smoke):
    check_config_fields("granite_3_8b", smoke)


@pytest.mark.parametrize("smoke", [False, True])
def test_minicpm3_config_matches_reference(smoke):
    """MLA: the ranks of ``MLAConfig`` and the latent ``kv_dim`` too."""
    check_config_fields("minicpm3_4b", smoke)
    assert tconfigs.get_config("minicpm3_4b").kv_dim() == 256 + 32


def test_unported_architecture_raises():
    """Every arch of the reference is registered; a name the reference
    does not have raises."""
    assert set(tconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    with pytest.raises(NotImplementedError, match="not ported"):
        tconfigs.get_config("llama_3_8b")

"""Port parity, DAP's packed and int8 forms (kernel #5's other outputs):
``ops.dap_pack``, ``ops.dap_pack_int8`` and ``ops.dap_prune_int8`` on CPU
tensors (their plain versions in ``kernels/ref.py``) against the
reference's ``repro.kernels.ops.dap_pack``, ``dap_pack_int8`` and
``quant.quantize(ops.dap_prune(x)[0], axis=-1)`` on the same numpy
inputs, in float32 and bfloat16, NNZ 1-5 and 8, with the hard rows of
``test_torch_dap_prune.py`` (a NaN block, ties, zeros of both signs,
+-inf).  Then the int8 wire's dense-input linear, which now takes the
int8 dense form, against the reference's ``linear``; the CPU dispatch;
and the launch plan of the per-row forms.

Tolerances: none.  DAP is selection and int8 quantization is integer
work after IEEE divisions, so values, masks, codes and scales are matched
bit for bit, and the linear's ``act=None`` output too (the same f32
multiply sequence after an int32 sum).  A row holding +-inf has scale
inf: its finite values quantize to 0, and a kept infinity's quotient is
NaN, which both frameworks cast to int8 0.  The CUDA kernel is held
against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.sparsity import SparsityConfig as TSparsity
from repro_torch.kernels import dap_prune, ops
from repro_torch.models import common as tcommon
from test_torch_dap_prune import DTYPES, _both, _inputs

torch.set_num_threads(1)

NNZS = [1, 2, 3, 4, 5, 8]
# (K, call site) of every DAP width on the three served paths
MAIN_WIDTHS = [(768, "minicpm3 q_up"), (1024, "granite-moe"), (2560, "minicpm3"),
               (4096, "granite-3-8b"), (6400, "minicpm3 down"), (12800, "granite-3-8b down")]


def _np(t) -> np.ndarray:
    """Bit patterns of a torch or jax array, as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        if t.dtype == torch.float32:
            return t.view(torch.int32).numpy()
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _isnan(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return torch.isnan(t.float()).numpy() if t.is_floating_point() else np.zeros(t.shape, bool)
    a = np.asarray(t)
    return np.isnan(a.astype(np.float32)) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" \
        else np.zeros(a.shape, bool)


def _equal(got, want, what):
    """Bit for bit, but a NaN matches any NaN: NNZ = 8 passes a NaN
    through, and ATen's vectorized bf16 path on the CPU writes its own
    NaN pattern (0xFFFF) where XLA keeps the input's."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    nan_g, nan_w = _isnan(got), _isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w, err_msg=f"{what}: NaN positions")
    np.testing.assert_array_equal(np.where(nan_g, 0, g), np.where(nan_w, 0, w), err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz", NNZS)
def test_dap_pack_plain_bit_exact_vs_reference(dtype, nnz):
    xj, xt = _both(_inputs(40 + nnz, m=8, k=128), dtype)
    ops.reset_counters()
    vals, mask = ops.dap_pack(xt, nnz, 8)
    assert (dap_prune.DAP_PACK.launches, dap_prune.DAP_PACK.plain) == (0, 1)
    want_v, want_m = jops.dap_pack(xj, nnz, 8)
    assert vals.dtype == xt.dtype and mask.dtype == torch.uint8
    _equal(vals, want_v, "vals")
    _equal(mask, want_m, "mask")
    # no zero of either sign takes a slot or a bit: row 2's first blocks
    # hold one non-zero (1.5) and none
    assert mask[2, :2].tolist() == [1 << 3, 0]
    assert not _np(vals[2, 1]).any() and _np(vals[2, 0, 1:]).tolist() == [0] * (nnz - 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz", NNZS)
def test_dap_pack_int8_per_row_bit_exact_vs_reference(dtype, nnz):
    xj, xt = _both(_inputs(50 + nnz, m=8, k=128), dtype)
    ops.reset_counters()
    q, mask, scale = ops.dap_pack_int8(xt, nnz, 8, act_scale="per_row")
    assert (dap_prune.DAP_PACK_INT8.launches, dap_prune.DAP_PACK_INT8.plain) == (0, 1)
    want_q, want_m, want_s = jops.dap_pack_int8(xj, nnz, 8, act_scale="per_row")
    assert q.dtype == torch.int8 and tuple(scale.shape) == (8,)
    _equal(q, want_q, "codes")
    _equal(mask, want_m, "mask")
    _equal(scale, want_s, "scale")
    if nnz < 8:
        assert math.isinf(scale[3].item()) and not q[3].any()  # the +-inf row
        assert scale[0].item() > 0 and not q[0, :2].any()  # NaN blocks keep nothing


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz", [1, 4, 8])
def test_dap_pack_int8_per_tensor_bit_exact_vs_reference(dtype, nnz):
    """Off the served paths (CUDA: the packed form, then the plain
    per-tensor quantization): one scalar scale, as the reference's."""
    xj, xt = _both(_inputs(60 + nnz, m=8, k=64, special=False), dtype)
    q, mask, scale = ops.dap_pack_int8(xt, nnz, 8)
    want_q, want_m, want_s = jops.dap_pack_int8(xj, nnz, 8)
    assert scale.ndim == 0
    _equal(q, want_q, "codes")
    _equal(mask, want_m, "mask")
    _equal(scale, want_s, "scale")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz", NNZS)
def test_dap_prune_int8_bit_exact_vs_reference(dtype, nnz):
    xj, xt = _both(_inputs(70 + nnz, m=8, k=128), dtype)
    ops.reset_counters()
    q, scale = ops.dap_prune_int8(xt, nnz, 8)
    assert (dap_prune.DAP_PRUNE_INT8.launches, dap_prune.DAP_PRUNE_INT8.plain) == (0, 1)
    assert dap_prune.DAP_PRUNE.plain == 0  # one form, not DAP and a separate quantize
    want_q, want_s = jquant.quantize(jops.dap_prune(xj, nnz, 8)[0], axis=-1)
    assert q.dtype == torch.int8 and tuple(q.shape) == (8, 128)
    _equal(q, want_q, "codes")
    _equal(scale, want_s, "scale")


@pytest.mark.parametrize("form", ["pack", "pack_int8", "prune_int8"])
def test_forms_any_leading_shape_and_rows_their_own(form):
    """``[..., K]`` is taken as 2-D rows and the shapes restored; a row's
    output does not depend on the rows beside it (the per-row scales
    included)."""
    x = torch.from_numpy(_inputs(80, m=12, k=64))
    fn = {"pack": lambda t: ops.dap_pack(t, 4, 8),
          "pack_int8": lambda t: ops.dap_pack_int8(t, 4, 8, act_scale="per_row"),
          "prune_int8": lambda t: ops.dap_prune_int8(t, 4, 8)}[form]
    flat = fn(x)
    shaped = fn(x.reshape(2, 3, 2, 64))
    for a, b in zip(flat, shaped):
        assert tuple(b.shape[:3]) == (2, 3, 2)
        _equal(b.reshape(a.shape), a, form)
    for i in (0, 3, 11):
        for a, b in zip(flat, fn(x[i:i + 1])):
            _equal(b[0], a[i], f"{form} row {i}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz", [3, 4])
def test_linear_int8_dense_input_with_dap_vs_reference(dtype, nnz):
    """The int8 wire's dense-input linear (wo) with DAP and per-row scales
    takes #5's int8 dense form, then #2 with that scale: equal to the
    reference's ``linear`` (DAP, then #2's own per-row quantization),
    bias included, bit for bit at ``act=None``."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(90 + nnz)
    k, n = 64, 48
    w = (rng.normal(size=(k, n)) / math.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    x = rng.normal(size=(2, 3, k)).astype(np.float32)
    x[0, 1, :8] = [2.0, -2.0, 2.0, 0.0, -0.0, 2.0, 1.0, -2.0]  # ties, zeros
    jsp = JSparsity(mode="awdbb", w_nnz=4, a_nnz=nnz, act_scale="per_row")
    tsp = TSparsity(mode="awdbb", w_nnz=4, a_nnz=nnz, act_scale="per_row")
    jp = jcommon.pack_linear_params({"w": jnp.asarray(w, jdt), "b": jnp.asarray(b, jdt)}, jsp,
                                    wire_dtype="int8")
    tp = {name: tensor_from_numpy(np.asarray(v)) for name, v in jp.items()}
    xj = jnp.asarray(x, jdt)
    xt = tensor_from_numpy(np.asarray(xj))
    want = jcommon.linear(jp, xj, sparsity=jsp)
    ops.reset_counters()
    got = tcommon.linear(tp, xt, sparsity=tsp)
    counts = {name: (c.launches, c.plain) for name, c in ops.counters().items()}
    assert counts["dap_prune_int8"] == (0, 1) and counts["dbb_matmul_int8"] == (0, 1)
    assert counts["dap_prune"] == (0, 0)
    assert got.dtype == tdt and tuple(got.shape) == (2, 3, n)
    _equal(got, want, "linear")


def test_cpu_dispatch_counts_plain_calls_only():
    """Every DAP form on a CPU tensor: its plain counter rises, no kernel
    launch is counted."""
    x = torch.from_numpy(_inputs(100, special=False))
    ops.reset_counters()
    ops.dap_prune(x, 4)
    ops.dap_pack(x, 4)
    ops.dap_pack_int8(x, 4, act_scale="per_row")
    ops.dap_pack_int8(x, 4)
    ops.dap_prune_int8(x, 4)
    got = {name: (c.launches, c.plain) for name, c in ops.counters().items()
           if name.startswith("dap")}
    assert got == {"dap_prune": (0, 1), "dap_pack": (0, 1), "dap_pack_int8": (0, 2),
                   "dap_prune_int8": (0, 1)}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The new forms' wrappers launch on CUDA tensors or raise."""
    for fn in (dap_prune.dap_pack_cuda, dap_prune.dap_pack_int8_cuda,
               dap_prune.dap_prune_int8_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(torch.zeros(4, 16), 4)
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            fn(torch.zeros(4, 16, dtype=torch.float16), 4)
        with pytest.raises(ValueError, match="K % 8"):
            fn(torch.zeros(4, 12), 4)
        with pytest.raises(ValueError, match="nnz"):
            fn(torch.zeros(4, 16), 9)
    assert dap_prune.DAP_PACK.launches == dap_prune.DAP_PACK_INT8.launches == 0
    assert dap_prune.DAP_PRUNE_INT8.launches == 0


@pytest.mark.parametrize("k", [8, 40] + [k for k, _ in MAIN_WIDTHS] + [29568, 32768, 49152])
@pytest.mark.parametrize("m", [1, 4, 32, 64, 67, 100, 512])
def test_row_plan(k, m):
    """The per-row forms' launch plan covers a row exactly: ``cluster``
    blocks of ``per_block`` 8-blocks each, ``threads`` (a multiple of 32,
    at most the kernel's 512) of up to ``per`` (1, 2, 4 or 8) 8-blocks.
    The rule takes the least power of 2 of blocks that holds the row (at
    most 512 x 8 8-blocks a block: 2 at qwen1.5-110b's K = 49152, at
    every M), then spreads the rows over the SMs, at least 32 8-blocks a
    block: on K = 4096, 8 blocks a row at M = 1 and 4, 4 at 32, 2 at 64,
    1 from 67."""
    nb = k // 8
    c, threads, per, per_block = dap_prune.row_plan(m, k)
    want = 1
    while want * dap_prune.ROW_MAX_THREADS * 8 < nb:
        want *= 2
    while want < 8 and 2 * want * m <= dap_prune.SMS and nb >= 64 * want:
        want *= 2
    assert c == want
    assert c >= -(-nb // (dap_prune.ROW_MAX_THREADS * 8))
    assert per in (1, 2, 4, 8) and threads % 32 == 0
    assert 32 <= threads <= dap_prune.ROW_MAX_THREADS
    assert c * per_block >= nb > (c - 1) * per_block
    assert per_block <= threads * per
    # no more threads, and no more 8-blocks a thread, than it takes
    assert threads - 32 < -(-per_block // per)
    assert per == 1 or -(-per_block // (per // 2)) > dap_prune.ROW_MAX_THREADS
    assert dap_prune.row_plan(m, 4096)[0] == {1: 8, 4: 8, 32: 4, 64: 2, 67: 1, 100: 1,
                                              512: 1}[m]
    if k == 49152:
        assert c == {1: 8, 4: 8, 32: 4, 64: 2, 67: 2, 100: 2, 512: 2}[m]


def test_row_plan_refuses_what_the_kernel_cannot_hold():
    """A row the plan spread over one block before now takes the least
    cluster that holds it; only a row of more than 8 blocks x 512 threads
    x 8 8-blocks raises, at every M."""
    k = 8 * 8 * 513  # 4104 8-blocks: more than 512 threads x 8 a block
    assert dap_prune.row_plan(4, k)[0] == 8  # the rule spreads it over a cluster
    assert dap_prune.row_plan(64, k)[0] == 2
    assert dap_prune.row_plan(100, k)[0] == 2  # one block cannot hold it
    too_long = 8 * (8 * 8 * dap_prune.ROW_MAX_THREADS + 1)
    for m in (1, 100):
        with pytest.raises(ValueError, match="8-blocks a block"):
            dap_prune.row_plan(m, too_long)


@pytest.mark.parametrize("arch,wire", [("granite_3_8b", "int8"), ("minicpm3_4b", "native"),
                                       ("granite_moe_1b_a400m", "native"),
                                       ("granite_moe_1b_a400m", "int8"),
                                       ("qwen2_vl_72b", "int8"), ("starcoder2_15b", "native"),
                                       ("starcoder2_15b", "int8"),
                                       ("phi3_5_moe_42b_a6_6b", "native"),
                                       ("qwen1_5_110b", "int8")])
def test_chip_smoke_expected_launches_per_pass(monkeypatch, arch, wire):
    """``chip_smoke.py``'s launches a forward pass, the count its main
    paths are held to on the card, equal a small CPU engine's plain calls
    a pass for every kernel and every DAP form (one call a call site)."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), n_layers=2)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
    # the card's "auto" runs the fused kernel (#6); the CPU's gathers, so
    # this stand-in names the fused path
    eng = Engine(params, cfg, ServeConfig(prefill_mode="continuous", pack_weights=True,
                                          max_seq=64, page_size=16, max_batch=2,
                                          prefill_chunk=8, wire_dtype=wire, kv_dtype=wire,
                                          paged_attn="fused"),
                 device="cpu")
    passes = []
    inner = lm.paged_step
    monkeypatch.setattr(lm, "paged_step", lambda *a, **kw: passes.append(1) or inner(*a, **kw))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 5, 12)]
    ops.reset_counters()
    eng.generate_requests(prompts, 3, arrivals=[0, 2, 1])
    expect = smoke.expected_launches(eng.cfg, wire)
    got = {name: c.plain for name, c in ops.counters().items()}
    assert got == {name: expect.get(name, 0) * len(passes) for name in got}
    assert all(c.launches == 0 for c in ops.counters().values())

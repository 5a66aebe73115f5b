"""Port parity, kernels: the plain versions of the three ported kernels
(``repro_torch/kernels/ref.py`` — what a CPU tensor runs, and what
``chip_smoke.py`` holds each CUDA kernel against on the card) vs the
reference's jnp oracles and its Pallas kernels in interpret mode, on the
same numpy inputs.

Tolerances, with their reasons:
  * int8 matmuls (#2, #3): int32 accumulators and ``act=None`` outputs
    bit-exact — integer work, then the same f32 multiply sequence;
    ``silu`` outputs at rtol/atol 1e-6 (XLA and ATen compute sigmoid
    differently).
  * paged attention (#6): atol/rtol 1e-5 in f32 — the reference's own
    kernel-vs-oracle bound (``tests/test_paged_attn.py``); the sums run
    in another order.
The CUDA kernels themselves need the card: ``test_torch_cuda.py``.
"""

import importlib.util
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbb as jdbb
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attn import paged_attn_fused
from repro_torch.core import dbb as tdbb
from repro_torch.kernels import dbb_matmul, ops, paged_attn
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from test_paged_attn import make_paged_state

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _operands(m, k, n, seed, per_row):
    """Int8 wire operands from the reference's packers."""
    cfg = jdbb.DBBConfig(4, 8)
    x = jnp.asarray(_rand((m, k), seed))
    w = jnp.asarray(_rand((k, n), seed + 1))
    b = jnp.asarray(_rand((n,), seed + 2))
    wv, wm, ws = jops.pack_weight_int8(w, cfg)
    xq, xs = jref.quantize_act_int8(x, per_row=per_row)
    xv, xm, xsp = jops.dap_pack_int8(x, 4, 8, act_scale="per_row" if per_row else "per_tensor")
    return cfg, dict(x=x, b=b, wv=wv, wm=wm, ws=ws, xq=xq, xs=xs, xv=xv, xm=xm, xsp=xsp)


def _check(got, want, act):
    if act is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


SHAPES = [(16, 64, 128), (5, 40, 24), (3, 128, 256)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "per_tensor"])
@pytest.mark.parametrize("bias_act", [(False, None), (True, None), (False, "silu")])
def test_dbb_matmul_int8_plain_vs_oracle(m, k, n, per_row, bias_act):
    """Kernel #2's plain version vs ``ref.dbb_matmul_int8_ref``."""
    has_bias, act = bias_act
    cfg, o = _operands(m, k, n, 10 * m + k, per_row)
    tcfg = tdbb.DBBConfig(4, 8)
    b = o["b"] if has_bias else None
    want = jref.dbb_matmul_int8_ref(o["xq"], o["xs"], o["wv"], o["wm"], o["ws"], cfg, bias=b, act=act)
    got = tref.dbb_matmul_int8_ref(
        _t(o["xq"]), _t(o["xs"]), _t(o["wv"]), _t(o["wm"]), _t(o["ws"]), tcfg,
        bias=None if b is None else _t(b), act=act,
    )
    _check(got.numpy(), np.array(want), act)
    # the int32 accumulator itself, bit for bit
    acc_j = jnp.dot(o["xq"], jref.decode_w(o["wv"], o["wm"], cfg), preferred_element_type=jnp.int32)
    acc_t = tref.int8_acc(_t(o["xq"]), tref.decode_w(_t(o["wv"]), _t(o["wm"]), tcfg))
    np.testing.assert_array_equal(acc_t.numpy(), np.array(acc_j))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "per_tensor"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_dbb_matmul_aw_int8_plain_vs_oracle(m, k, n, per_row, act):
    """Kernel #3's plain version vs ``ref.dbb_matmul_aw_int8_ref``."""
    cfg, o = _operands(m, k, n, 10 * m + k + 1, per_row)
    tcfg = tdbb.DBBConfig(4, 8)
    want = jref.dbb_matmul_aw_int8_ref(
        o["xv"], o["xm"], o["xsp"], o["wv"], o["wm"], o["ws"], cfg, cfg, act=act
    )
    got = tref.dbb_matmul_aw_int8_ref(
        _t(o["xv"]), _t(o["xm"]), _t(o["xsp"]), _t(o["wv"]), _t(o["wm"]), _t(o["ws"]),
        tcfg, tcfg, act=act,
    )
    _check(got.numpy(), np.array(want), act)
    acc_j = jnp.dot(
        jref.decode_a(o["xv"], o["xm"], cfg), jref.decode_w(o["wv"], o["wm"], cfg),
        preferred_element_type=jnp.int32,
    )
    acc_t = tref.int8_acc(
        tref.decode_a(_t(o["xv"]), _t(o["xm"]), tcfg), tref.decode_w(_t(o["wv"]), _t(o["wm"]), tcfg)
    )
    np.testing.assert_array_equal(acc_t.numpy(), np.array(acc_j))


@pytest.mark.parametrize("kernel", ["w", "aw"])
def test_int8_plain_vs_interpret_kernel(kernel):
    """The plain versions vs the reference's Pallas kernels run in
    interpret mode (as tests/test_kernels.py runs them), per-row scales,
    act=None: bit-exact."""
    cfg, o = _operands(16, 64, 128, 3, per_row=True)
    tcfg = tdbb.DBBConfig(4, 8)
    tiles = dict(tm=16, tk=64, tn=128)
    if kernel == "w":
        want = jops.dbb_matmul_int8(
            o["xq"], o["wv"], o["wm"], o["ws"], cfg, impl="interpret", x_scale=o["xs"], **tiles
        )
        got = ops.dbb_matmul_int8(
            _t(o["xq"]), _t(o["wv"]), _t(o["wm"]), _t(o["ws"]), tcfg, x_scale=_t(o["xs"])
        )
    else:
        want = jops.dbb_matmul_aw_int8(
            o["xv"], o["xm"], o["xsp"], o["wv"], o["wm"], o["ws"], cfg, cfg,
            impl="interpret", **tiles,
        )
        got = ops.dbb_matmul_aw_int8(
            _t(o["xv"]), _t(o["xm"]), _t(o["xsp"]), _t(o["wv"]), _t(o["wm"]), _t(o["ws"]),
            tcfg, tcfg,
        )
    np.testing.assert_array_equal(got.numpy(), np.array(want))


# ------------------------------------------------------- paged attention


def _attn_inputs(seed, s, int8, n_tokens=(10, 6)):
    kvh, dh = 2, 16
    cache, pos_tbl, tables = make_paged_state(seed, n_tokens=n_tokens, kvd=kvh * dh, int8=int8)
    rng = np.random.default_rng(seed + 100)
    b = len(n_tokens)
    q = jnp.asarray(rng.normal(size=(b, s, 2 * kvh, dh)).astype(np.float32))
    q_pos = jnp.asarray(np.stack([np.arange(t - s, t) for t in n_tokens]).astype(np.int32))
    return kvh, cache, pos_tbl, tables, q, q_pos


def _port_attn(kvh, cache, pos_tbl, tables, q, q_pos, window=None):
    return tref.paged_attn_ref(
        _t(q), _t(cache["k"]), _t(cache["v"]), _t(pos_tbl), _t(tables), _t(q_pos),
        kv_heads=kvh, window=window,
        k_scale=_t(cache["k_scale"]) if "k_scale" in cache else None,
        v_scale=_t(cache["v_scale"]) if "v_scale" in cache else None,
    ).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.array(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["native_kv", "int8_kv"])
@pytest.mark.parametrize("s", [1, 4], ids=["decode", "chunk"])
@pytest.mark.parametrize("window", [None, 3], ids=["full", "window3"])
def test_paged_attn_plain_vs_oracle_and_kernel(int8, s, window):
    """Kernel #6's plain version vs ``ref.paged_attn_ref`` and vs the
    interpret-mode Pallas kernel: decode and chunk, int8 and native KV,
    full attention and a sliding window."""
    kvh, cache, pos_tbl, tables, q, q_pos = _attn_inputs(11 + s, s, int8)
    kw = dict(kv_heads=kvh, window=window, k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    got = _port_attn(kvh, cache, pos_tbl, tables, q, q_pos, window)
    _close(got, jref.paged_attn_ref(q, cache["k"], cache["v"], pos_tbl, tables, q_pos, **kw))
    _close(got, paged_attn_fused(q, cache["k"], cache["v"], pos_tbl, tables, q_pos, interpret=True, **kw))


@pytest.mark.parametrize("int8", [False, True], ids=["native_kv", "int8_kv"])
def test_paged_attn_plain_vs_port_gather_path(int8):
    """Within the port: the fused plain version vs the gather path
    (``paged_read`` + ``mha``)."""
    kvh, cache, pos_tbl, tables, q, q_pos = _attn_inputs(21, 4, int8)
    tcache = {k: _t(v) for k, v in cache.items()}
    k_win, v_win, pos_win = tattn.paged_read(tcache, _t(pos_tbl), _t(tables))
    b, t = k_win.shape[:2]
    want = tattn.mha(_t(q), k_win.reshape(b, t, kvh, -1), v_win.reshape(b, t, kvh, -1), _t(q_pos), pos_win)
    _close(_port_attn(kvh, cache, pos_tbl, tables, q, q_pos), want.numpy())


def test_paged_attn_recycled_page_scrub():
    """A recycled page (stale garbage, slots scrubbed to -1) streaming
    first contributes exactly nothing: the same request without it in
    its table gives the same output."""
    kvh, dh = 1, 8
    cache, pos_tbl, tables = make_paged_state(
        6, n_tokens=(5,), n_pages=6, ps=4, kvd=kvh * dh, garbage_scale=100.0
    )
    stale = 5 if int(tables[0, 0]) != 5 else 4
    tables_stale = jnp.asarray([[stale, *np.asarray(tables[0, :-1])]], jnp.int32)
    pos_tbl = pos_tbl.at[stale].set(-1)
    q = jnp.asarray(np.random.default_rng(7).normal(size=(1, 1, 2, dh)).astype(np.float32))
    q_pos = jnp.asarray([[4]], jnp.int32)
    want = _port_attn(kvh, cache, pos_tbl, tables, q, q_pos)
    _close(_port_attn(kvh, cache, pos_tbl, tables_stale, q, q_pos), want)
    _close(want, jref.paged_attn_ref(q, cache["k"], cache["v"], pos_tbl, tables, q_pos, kv_heads=kvh))


@pytest.mark.parametrize("int8", [False, True], ids=["native_kv", "int8_kv"])
def test_paged_attn_plain_bf16_vs_interpret_kernel(int8):
    """The call the tensor-core kernel takes on the card, bf16 GQA at
    granite-moe-1b-a400m's head shape (2 query heads per KV head of 64),
    PS 8, with padding rows (no valid key): the plain version vs the
    interpret-mode Pallas kernel, both in bf16.  Within 1.6e-2, two bf16
    ulps at 1: the two round probabilities and the output to bf16, and a
    sum in another order can land either side of a rounding."""
    kvh, dh, s = 2, 64, 3
    cache, pos_tbl, tables = make_paged_state(31, n_tokens=(13, 6), ps=8, kvd=kvh * dh,
                                              int8=int8, garbage_scale=1.0)
    if not int8:
        cache = {k: v.astype(jnp.bfloat16) for k, v in cache.items()}
    rng = np.random.default_rng(131)
    q = jnp.asarray(rng.normal(size=(2, s, 2 * kvh, dh)), jnp.bfloat16)
    q_pos = jnp.asarray([[10, 11, 12], [5, -1, -1]], jnp.int32)
    kw = dict(kv_heads=kvh, k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    want = paged_attn_fused(q, cache["k"], cache["v"], pos_tbl, tables, q_pos, interpret=True,
                            **kw)

    def bf16(x):
        return _t(np.asarray(x, np.float32)).to(torch.bfloat16)

    page = (lambda x: _t(x)) if int8 else bf16
    got = tref.paged_attn_ref(
        bf16(q), page(cache["k"]), page(cache["v"]), _t(pos_tbl), _t(tables), _t(q_pos),
        kv_heads=kvh, k_scale=_t(cache["k_scale"]) if int8 else None,
        v_scale=_t(cache["v_scale"]) if int8 else None,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1.6e-2,
                               rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["native_kv", "int8_kv"])
@pytest.mark.parametrize("ps", [4, 3], ids=["ps4", "ps3"])
def test_paged_attn_plain_bf16_latent_vs_interpret_kernel(int8, ps):
    """The call the latent tensor-core kernel takes on the card: bf16 MLA
    latent mode (one latent of Dk = 48, v its first 32 features, 8 query
    heads, an explicit softmax scale), pages of 4 and of 3 slots (not a
    multiple of 8), int8 k with scales or native bf16, a chunk with padding
    rows (no valid key): the plain version vs the interpret-mode Pallas
    kernel, both in bf16, within 1.6e-2 as for GQA."""
    lora, rope_d, h, s = 32, 16, 8, 3
    cache, pos_tbl, tables = make_paged_state(41 + ps, n_tokens=(9, 5), ps=ps,
                                              kvd=lora + rope_d, garbage_scale=1.0)
    k = cache["k"]
    k_scale = None
    if int8:  # MLA quantizes only the latent k plane
        k, k_scale = jquant.quantize_rows(k)
    else:
        k = k.astype(jnp.bfloat16)
    rng = np.random.default_rng(141 + ps)
    q = jnp.asarray(rng.normal(size=(2, s, h, lora + rope_d)), jnp.bfloat16)
    q_pos = jnp.asarray([[6, 7, 8], [4, -1, -1]], jnp.int32)
    scale = 1.0 / np.sqrt(24.0)
    want = paged_attn_fused(q, k, None, pos_tbl, tables, q_pos, interpret=True, kv_heads=1,
                            softmax_scale=scale, k_scale=k_scale, latent_dv=lora)
    got = tref.paged_attn_ref(
        _t(np.asarray(q, np.float32)).to(torch.bfloat16),
        _t(k) if int8 else _t(np.asarray(k, np.float32)).to(torch.bfloat16), None,
        _t(pos_tbl), _t(tables), _t(q_pos), kv_heads=1, softmax_scale=scale,
        k_scale=None if k_scale is None else _t(k_scale), latent_dv=lora,
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, s, h, lora)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1.6e-2,
                               rtol=0)


def test_tc_shape_rule():
    """The shapes the tensor-core kernel takes: the main paths' head
    shapes do, the rest name what they break."""
    assert paged_attn.tc_shape_error(4, 128, 128, 16) is None  # granite-3-8b
    assert paged_attn.tc_shape_error(2, 64, 64, 16) is None  # granite-moe-1b-a400m
    assert paged_attn.tc_shape_error(64, 16, 8, 8) is None
    for args, word in (((4, 40, 40, 16), "Dk=40"), ((4, 64, 60, 16), "Dv=60"),
                       ((4, 64, 136, 16), "Dv=136"), ((4, 64, 64, 0), "PS=0"),
                       ((65, 64, 64, 16), "65 query heads")):
        assert word in paged_attn.tc_shape_error(*args)


@pytest.mark.parametrize("latent", [False, True], ids=["gqa", "latent"])
def test_tc_shape_rule_page_sizes(latent):
    """Both tensor-core kernels take every page size from one slot up:
    pad slots fill the S fragment's 8-slot n-tiles, and a page of more
    than 64 slots is walked as 64-slot sub-pages (65, 72 and 128 among
    them).  A page of no slot is refused."""
    g, dk, dv = (40, 288, 256) if latent else (4, 128, 128)
    for ps in list(range(1, 130)) + [256, 1000]:
        assert paged_attn.tc_shape_error(g, dk, dv, ps, latent) is None, ps
    for ps in (0, -1):
        assert f"PS={ps}" in paged_attn.tc_shape_error(g, dk, dv, ps, latent)


def test_tc_shape_rule_latent():
    """The latent kernel: minicpm3-4b's latent (Dk 288, Dv 256, 40 query
    heads over one latent), its smoke latent (Dk 40: zero-padded to 48 in
    shared memory) and any head count; Dk a multiple of 8, Dv up to 256,
    within Dk; any page size from 1 up."""
    assert paged_attn.tc_shape_error(40, 288, 256, 16, latent=True) is None  # minicpm3-4b
    assert paged_attn.tc_shape_error(40, 40, 32, 16, latent=True) is None  # its smoke config
    assert paged_attn.tc_shape_error(128, 48, 8, 1, latent=True) is None
    assert paged_attn.tc_shape_error(40, 288, 256, 80, latent=True) is None
    for args, word in (((40, 36, 32, 16), "Dk=36"), ((40, 288, 260, 16), "Dv=260"),
                       ((40, 320, 264, 16), "Dv=264"), ((40, 288, 256, 0), "PS=0")):
        assert word in paged_attn.tc_shape_error(*args, latent=True)


def _smoke_native_shapes():
    """The full-width (K, N) of ``chip_smoke.py``'s native-wire linears
    that the tc body takes (``NATIVE_LINEARS``: minicpm3-4b,
    granite-moe-1b-a400m, starcoder2-15b, phi3.5-moe-42b-a6.6b,
    qwen2-vl-72b, mamba2-130m, hymba-1.5b and whisper-base)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return sorted({row[-3:-1] for row in mod.NATIVE_LINEARS if row[-1] == "tc"})


@pytest.mark.parametrize("k,n", _smoke_native_shapes())
def test_native_plan_full_width(k, n):
    """The native matmuls' launch plan at every full-width shape: a
    function of (K, N) alone, its splits whole k-steps that cover K with
    none empty, at most 8 of them (one portable cluster), and the shape
    taken by the tc body."""
    assert list(inspect.signature(dbb_matmul.native_plan).parameters) == ["k", "n"]
    bn, kb_per_split, n_split = dbb_matmul.native_plan(k, n)
    assert dbb_matmul.native_plan(k, n) == (bn, kb_per_split, n_split)
    kb, step = k // 8, dbb_matmul.STEP_BLOCKS
    assert bn in (64, 128)
    assert kb_per_split % step == 0
    assert (n_split - 1) * kb_per_split < kb <= n_split * kb_per_split
    assert (kb - (n_split - 1) * kb_per_split) % step == 0
    assert 1 <= n_split <= dbb_matmul.MAX_SPLIT == 8
    assert dbb_matmul.tc_body_error(torch.bfloat16, kb, n, 4, (0, 16), (8,)) is None


def test_smoke_tables_name_each_body():
    """``chip_smoke.py``'s body column agrees with the wrappers' rules on
    every full-width linear: "tc" exactly where the tc body takes its K
    and N (int8 wire: K % 128 and N % 16; native: K % 64 and N % 8), and
    the recurrent archs' misses (hymba's K = 1600 on the int8 wire,
    mamba2's N = 3352 there, hymba's N = 6482 on both) are named
    "generic"."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    int8 = [("granite-3-8b",) + row for row in mod.LINEARS] + list(mod.INT8_OTHER_LINEARS)
    for arch, name, _, _, k, n, body in int8:
        takes = dbb_matmul.int8_body_error(k // 8, n) is None
        assert body == ("tc" if takes else "generic"), (arch, name, k, n)
    for arch, name, _, _, _, k, n, body in mod.NATIVE_LINEARS:
        takes = dbb_matmul.tc_body_error(torch.bfloat16, k // 8, n) is None
        assert body == ("tc" if takes else "generic"), (arch, name, k, n)
    generic = {(r[0], r[1], r[-3], r[-2]) for r in int8 if r[-1] == "generic"}
    assert ("hymba-1.5b", "in_proj", 1600, 6482) in generic
    assert ("mamba2-130m", "in_proj", 768, 3352) in generic
    assert {r[1] for r in generic if r[0] == "hymba-1.5b"} >= {"wq", "wo", "in_proj", "lm_head"}
    native_generic = {(r[0], r[1]) for r in mod.NATIVE_LINEARS if r[-1] == "generic"}
    assert native_generic == {("hymba-1.5b", "in_proj")}


def test_tc_body_rule():
    """What the tc body refuses, by name: f32 values, N not a multiple of
    8 (70, 290), K not a multiple of 64, more than 4 values an 8-block,
    misaligned operands."""
    assert "float32" in dbb_matmul.tc_body_error(torch.float32, 320, 768)
    for n in (70, 290):
        assert f"N={n}" in dbb_matmul.tc_body_error(torch.bfloat16, 320, n)
    assert "K=136" in dbb_matmul.tc_body_error(torch.bfloat16, 17, 64)
    assert "NNZ=5" in dbb_matmul.tc_body_error(torch.bfloat16, 8, 64, 5)
    for nnz in (1, 2, 3, 4):
        assert dbb_matmul.tc_body_error(torch.bfloat16, 8, 64, nnz) is None
    assert "aligned" in dbb_matmul.tc_body_error(torch.bfloat16, 8, 64, 4, (8,))
    assert "aligned" in dbb_matmul.tc_body_error(torch.bfloat16, 8, 64, 4, (16,), (4,))


def _smoke_int8_shapes():
    """The full-width (K, N) of ``chip_smoke.py``'s int8-wire linears that
    the int8 tc body takes (``LINEARS``: granite-3-8b,
    ``INT8_OTHER_LINEARS``: minicpm3-4b, granite-moe-1b-a400m,
    qwen2-vl-72b, qwen1.5-110b, mamba2-130m and hymba-1.5b)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return sorted({row[-3:-1] for row in mod.LINEARS + mod.INT8_OTHER_LINEARS
                   if row[-1] == "tc"})


@pytest.mark.parametrize("k,n", _smoke_int8_shapes())
def test_int8_plan_full_width(k, n):
    """The int8 matmuls' launch plan at every full-width shape and M = 1,
    4, 16, 17, 64 and 100: a 16-row tile up to M = 16, else 64; its splits
    whole k-steps that cover K with none empty, at most 8 of them (one
    portable cluster); the shape taken by the int8 tc body."""
    assert list(inspect.signature(dbb_matmul.int8_plan).parameters) == ["m", "k", "n"]
    kb, step = k // 8, dbb_matmul.INT8_STEP_BLOCKS
    for m in (1, 4, 16, 17, 64, 100):
        bm, kb_per_split, n_split = dbb_matmul.int8_plan(m, k, n)
        assert bm == (16 if m <= 16 else 64)
        assert kb_per_split % step == 0
        assert (n_split - 1) * kb_per_split < kb <= n_split * kb_per_split
        assert (kb - (n_split - 1) * kb_per_split) % step == 0
        assert 1 <= n_split <= dbb_matmul.MAX_SPLIT == 8
    assert dbb_matmul.int8_body_error(kb, n, 4, (0, 16, 32, 256)) is None


def test_int8_body_rule():
    """What the int8 tc body refuses, by name: K not a multiple of 128, N
    not a multiple of 16, more than 4 values an 8-block, an operand not
    16-byte aligned; what it takes: NNZ 1-4, a partial last column tile."""
    assert "K=136" in dbb_matmul.int8_body_error(17, 64)
    assert "K=1000" in dbb_matmul.int8_body_error(125, 64)
    for n in (36, 200, 290):
        assert f"N={n}" in dbb_matmul.int8_body_error(32, n)
    assert "NNZ=5" in dbb_matmul.int8_body_error(16, 64, 5)
    for nnz in (1, 2, 3, 4):
        assert dbb_matmul.int8_body_error(16, 288, nnz) is None
    assert dbb_matmul.int8_body_error(16, 16) is None
    for ptrs in ((8,), (16, 4), (0, 16, 32, 36)):
        assert "aligned" in dbb_matmul.int8_body_error(16, 64, 4, ptrs)


def _byte_perm(word, sel):
    """``__byte_perm(word, 0, sel)`` on arrays: byte ``i`` of the result is
    byte ``sel`` nibble ``i`` of ``word`` (0-3), or 0 (4-7: the zero word)."""
    out = np.zeros_like(word)
    for i in range(4):
        nib = (sel >> (4 * i)) & 7
        byte = np.where(nib < 4, (word >> (8 * np.minimum(nib, 3))) & 0xFF, 0)
        out |= byte << (8 * i)
    return out


@pytest.mark.parametrize("nnz", [1, 2, 3, 4])
def test_int8_decode_table(nnz):
    """The int8 tc body's decode table against the plain and JAX decodes,
    for all 256 masks at ``nnz`` values an 8-block: two byte permutes of an
    8-block's value word (slots past ``nnz`` hold garbage the table never
    selects) give its dense low and high words, masks with more set bits
    than values clamped like the oracle's gather."""
    table = dbb_matmul.int8_decode_table()
    assert table.shape == (4, 256) and table.dtype == torch.int32
    e = table[nnz - 1].numpy().astype(np.int64)
    rng = np.random.default_rng(30 + nnz)
    vals = rng.integers(-128, 128, size=(256, 4)).astype(np.int8)  # [mask, slot]
    word = vals.view(np.uint8).astype(np.int64) @ (1 << (8 * np.arange(4)))
    lo, hi = _byte_perm(word, e & 0xFFFF), _byte_perm(word, e >> 16)
    got = (np.stack([lo, hi], -1)[..., None] >> (8 * np.arange(4))) & 0xFF
    got = got.astype(np.uint8).view(np.int8).reshape(256, 8)  # [mask, position]
    masks = np.arange(256, dtype=np.uint8)
    cfg_t, cfg_j = tdbb.DBBConfig(nnz, 8), jdbb.DBBConfig(nnz, 8)
    # weights: w_vals [KB=256, nnz, N=1], one 8-block a mask
    want_w = tref.decode_w(_t(vals[:, :nnz, None]), _t(masks[:, None]), cfg_t)
    np.testing.assert_array_equal(got, want_w.numpy().reshape(256, 8))
    want_wj = jref.decode_w(jnp.asarray(vals[:, :nnz, None]), jnp.asarray(masks[:, None]), cfg_j)
    np.testing.assert_array_equal(got, np.asarray(want_wj).reshape(256, 8))
    # activations: x_vals [M=256, KB=1, nnz]
    want_a = tref.decode_a(_t(vals[:, None, :nnz]), _t(masks[:, None]), cfg_t)
    np.testing.assert_array_equal(got, want_a.numpy())


# ------------------------------------------------------------- dispatch


def test_cpu_dispatch_counts_plain_calls_only():
    """A CPU tensor takes the plain version: the plain counters rise and
    no kernel launch is counted."""
    ops.reset_counters()
    cfg, o = _operands(4, 64, 32, 5, per_row=True)
    tcfg = tdbb.DBBConfig(4, 8)
    ops.dbb_matmul_int8(_t(o["x"]), _t(o["wv"]), _t(o["wm"]), _t(o["ws"]), tcfg, act_scale="per_row")
    ops.dbb_matmul_aw_int8(_t(o["xv"]), _t(o["xm"]), _t(o["xsp"]), _t(o["wv"]), _t(o["wm"]), _t(o["ws"]), tcfg, tcfg)
    kvh, cache, pos_tbl, tables, q, q_pos = _attn_inputs(3, 1, True)
    ops.paged_attention(
        _t(q), _t(cache["k"]), _t(cache["v"]), _t(pos_tbl), _t(tables), _t(q_pos),
        kv_heads=kvh, k_scale=_t(cache["k_scale"]), v_scale=_t(cache["v_scale"]),
    )
    xv, xm = ops.dap_pack(_t(o["x"]), 4, 8)
    wv, wm = ops.pack_weight(_t(o["x"]).t().contiguous(), tcfg)
    ops.dbb_matmul(_t(o["x"]), wv, wm, tcfg)
    ops.dbb_matmul_aw(xv, xm, wv, wm, tcfg, tcfg)
    ops.paged_attention(  # latent mode: one 32-wide latent head
        _t(q).reshape(q.shape[0], q.shape[1], -1, 32), _t(cache["k"]), None, _t(pos_tbl),
        _t(tables), _t(q_pos), kv_heads=1, k_scale=_t(cache["k_scale"]), latent_dv=8, softmax_scale=0.3,
    )
    ops.dap_prune(_t(o["x"]), 4, 8)
    counts = ops.counters()
    assert {k: (c.launches, c.plain) for k, c in counts.items()} == {
        "dbb_matmul": (0, 1), "dbb_matmul_int8": (0, 1), "dbb_matmul_aw_int8": (0, 1),
        "dbb_matmul_aw": (0, 1), "paged_attn": (0, 1), "paged_attn_latent": (0, 1),
        "dap_prune": (0, 1), "dap_prune_int8": (0, 0), "dap_pack": (0, 1), "dap_pack_int8": (0, 0),
    }
    ops.reset_counters()
    assert all(c.launches == 0 and c.plain == 0 for c in ops.counters().values())


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise; they never
    compute on the CPU themselves."""
    cfg, o = _operands(4, 64, 32, 6, per_row=True)
    tcfg = tdbb.DBBConfig(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dbb_matmul.dbb_matmul_int8_cuda(_t(o["xq"]), _t(o["xs"]), _t(o["wv"]), _t(o["wm"]), _t(o["ws"]), tcfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attn.paged_attn_cuda(
            torch.zeros(1, 1, 2, 8), torch.zeros(1, 4, 8), torch.zeros(1, 4, 8),
            torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32), kv_heads=1, latent_dv=4,
        )
    x = _t(o["x"])
    wv, wm = ops.pack_weight(x.t().contiguous(), tcfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dbb_matmul.dbb_matmul_cuda(x, wv, wm, tcfg)
    xv, xm = ops.dap_pack(x, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dbb_matmul.dbb_matmul_aw_cuda(xv, xm, wv, wm, tcfg, tcfg)
    assert dbb_matmul.INT8.launches == 0
    assert dbb_matmul.NATIVE.launches == 0 and dbb_matmul.AW_NATIVE.launches == 0
    assert paged_attn.PAGED_ATTN_LATENT.launches == 0

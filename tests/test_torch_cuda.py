"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
import) when no CUDA device is present, as on a CPU-only host.  On a
machine with an H100 and nvcc, run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the same checks at granite-3-8b's and
minicpm3-4b's full widths; these stay small and add odd, ragged shapes.

Tolerances: int32 accumulators and ``act=None`` float32 outputs of the
int8 matmuls are bit-exact (integer work, then the same f32 operations);
the native-wire matmuls are held to 1e-5 of the largest output in f32
(f32 sums in another order than the plain version's float64), and in
bf16 to that plus one bf16 ulp of the larger output (an f32 difference
can straddle a bf16 rounding); paged attention in f32 is held to 1e-5, the reference's
kernel-vs-oracle bound, on every row (rows with no valid key included),
and in bf16 (the tensor-core kernel) to 1.6e-2 absolute, two bf16 ulps
at 1, as ``chip_smoke.py`` holds it: the sums run in another order than
the plain version's, which can straddle a bf16 rounding of a probability
or of the output; DAP (#5) is selection and is held bit for bit.  The
bf16 gate's card twin holds whole teacher-forced model steps under DAP
to the CPU port's own bf16-vs-f32 gap (``tests/test_torch_bf16_gate.py``'s
bound, with the CPU port in the reference's place) and to 0.125, twice
the largest error its sound runs measure."""

import functools
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.core import dbb, quant
from repro_torch.core.dap import DAPSpec, apply_dap
from repro_torch.kernels import dap_prune, dbb_matmul, ops, paged_attn, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("m,k,n", [(4, 64, 128), (5, 40, 24), (64, 256, 200), (17, 136, 72)])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_int8_matmul_kernels_exact(cuda, m, k, n, kind):
    cfg = dbb.DBBConfig(4, 8)
    w = torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)
    wv, wm, ws = ref.pack_weight_int8(w, cfg)
    x = torch.randn((m, k), generator=cuda, device="cuda")
    acc = torch.empty((m, n), dtype=torch.int32, device="cuda")
    tc_before = dbb_matmul.INT8_TC.launches + dbb_matmul.AW_INT8_TC.launches
    if kind == "aw":
        xv, xm, xs = ops.dap_pack_int8(x, 4, 8, act_scale="per_row")
        y = dbb_matmul.dbb_matmul_aw_int8_cuda(xv, xm, xs, wv, wm, ws, cfg, cfg, acc_out=acc)
        want = ref.dbb_matmul_aw_int8_ref(xv, xm, xs, wv, wm, ws, cfg, cfg)
        x_dense = ref.decode_a(xv, xm, cfg)
    else:
        xq, xs = ref.quantize_act_int8(x)  # per-tensor scalar scale
        y = dbb_matmul.dbb_matmul_int8_cuda(xq, xs, wv, wm, ws, cfg, acc_out=acc)
        want = ref.dbb_matmul_int8_ref(xq, xs, wv, wm, ws, cfg)
        x_dense = xq
    assert torch.equal(acc, ref.int8_acc(x_dense, ref.decode_w(wv, wm, cfg)))
    assert torch.equal(y, want)
    # none of these shapes has K % 128 == 0 and N % 16 == 0: the generic body
    assert dbb_matmul.int8_body_error(k // 8, n) is not None
    assert dbb_matmul.INT8_TC.launches + dbb_matmul.AW_INT8_TC.launches == tc_before


@functools.lru_cache(maxsize=None)
def _smoke_module():
    """``chip_smoke.py``, whose tables list the main paths' full-width shapes."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_int8_linears():
    """Every full-width int8-wire linear of ``chip_smoke.py`` that the int8
    tc body takes: granite-3-8b's (``LINEARS``) and the other archs'
    (``INT8_OTHER_LINEARS``), as (arch, name, kernel, K, N)."""
    mod = _smoke_module()
    rows = [("granite-3-8b",) + row for row in mod.LINEARS] + list(mod.INT8_OTHER_LINEARS)
    return [(arch, name, kind, k, n) for arch, name, kind, _, k, n, body in rows if body == "tc"]


def _int8_operands(gen, m, k, n, kind, nnz=4, per_row=True):
    """Int8 wire operands of kernel #2 (``kind`` "w": x_q and its scale) or
    #3 ("aw": DAP-packed x), weights packed at ``nnz`` of 8."""
    cfg = dbb.DBBConfig(nnz, 8)
    w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
    wop = ref.pack_weight_int8(w, cfg)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    if kind == "aw":
        xop = ops.dap_pack_int8(x, nnz, 8, act_scale="per_row" if per_row else "per_tensor")
    else:
        xop = ref.quantize_act_int8(x, per_row=per_row)
    return cfg, xop, wop


def _int8_run(kind, cfg, xop, wop, m=None, **kw):
    """The kernel's output, its plain version's, the kernel's int32
    accumulators and the dense int8 x, on the first ``m`` rows of x."""
    wv, wm, ws = wop
    xs = xop[-1]
    rows = slice(0, m)
    if xs.ndim:
        xs = xs[rows]
    if kind == "aw":
        xv, xm = xop[0][rows], xop[1][rows]
        acc = torch.empty((xv.shape[0], wv.shape[2]), dtype=torch.int32, device="cuda")
        y = dbb_matmul.dbb_matmul_aw_int8_cuda(xv, xm, xs, wv, wm, ws, cfg, cfg, acc_out=acc, **kw)
        want = ref.dbb_matmul_aw_int8_ref(xv, xm, xs, wv, wm, ws, cfg, cfg, **kw)
        return y, want, acc, ref.decode_a(xv, xm, cfg)
    xq = xop[0][rows]
    acc = torch.empty((xq.shape[0], wv.shape[2]), dtype=torch.int32, device="cuda")
    y = dbb_matmul.dbb_matmul_int8_cuda(xq, xs, wv, wm, ws, cfg, acc_out=acc, **kw)
    want = ref.dbb_matmul_int8_ref(xq, xs, wv, wm, ws, cfg, **kw)
    return y, want, acc, xq


def _int8_counters(kind):
    if kind == "aw":
        return dbb_matmul.AW_INT8, dbb_matmul.AW_INT8_TC
    return dbb_matmul.INT8, dbb_matmul.INT8_TC


INT8_ROWS = (1, 4, 16, 17, 64, 100)


@pytest.mark.parametrize("arch,name,kind,k,n", _smoke_int8_linears(), ids=lambda v: str(v))
def test_int8_tc_full_width(cuda, arch, name, kind, k, n):
    """The int8 tc body at every full-width int8-wire shape of granite-3-8b,
    minicpm3-4b and granite-moe-1b-a400m, at M = 1, 4, 16, 17, 64 and 100:
    every call on the tc body, int32 accumulators and the ``act=None`` f32
    output bit for bit against the plain version, and a row's bits the
    same at every M (per-row scales)."""
    cfg, xop, wop = _int8_operands(cuda, max(INT8_ROWS), k, n, kind)
    w_dense = ref.decode_w(wop[0], wop[1], cfg)
    total, tc = _int8_counters(kind)
    before = (total.launches, tc.launches)
    ys = {}
    for m in INT8_ROWS:
        y, want, acc, x_dense = _int8_run(kind, cfg, xop, wop, m)
        assert torch.equal(acc, ref.int8_acc(x_dense, w_dense)), m
        assert torch.equal(y, want), m
        ys[m] = y
    assert (total.launches, tc.launches) == (before[0] + 6, before[1] + 6)
    for a, b in zip(INT8_ROWS, INT8_ROWS[1:]):
        assert torch.equal(ys[a], ys[b][:a]), (a, b)


@pytest.mark.parametrize("nnz", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_int8_tc_nnz(cuda, nnz, kind):
    """Other densities than 4 of 8 on both operands: the tc body decodes up
    to 4 values an 8-block (its tables clamp ranks to NNZ - 1 like the
    oracle; #3's activations of 1-3 values lie at unaligned offsets), 5
    goes to the generic body; both bit for bit."""
    m, k, n = 20, 512, 144
    cfg, xop, wop = _int8_operands(cuda, m, k, n, kind, nnz=nnz)
    total, tc = _int8_counters(kind)
    before = (total.launches, tc.launches)
    y, want, acc, x_dense = _int8_run(kind, cfg, xop, wop)
    assert torch.equal(acc, ref.int8_acc(x_dense, ref.decode_w(wop[0], wop[1], cfg)))
    assert torch.equal(y, want)
    assert (total.launches, tc.launches) == (before[0] + 1, before[1] + (nnz <= 4))


@pytest.mark.parametrize("fill", [0, 255], ids=["zero_masks", "full_masks"])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_int8_tc_extreme_masks(cuda, fill, kind):
    """Masks all zero (every 8-block decodes to zeros) and all ones (8 set
    bits over 4 values: positions past the fourth take the last value, as
    the oracle's clamped gather), random values: bit for bit on the tc body."""
    m, k, n = 17, 256, 160
    cfg = dbb.DBBConfig(4, 8)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=cuda, device="cuda").to(torch.int8)

    wop = (codes((k // 8, 4, n)), torch.full((k // 8, n), fill, dtype=torch.uint8, device="cuda"),
           torch.rand((n,), generator=cuda, device="cuda") + 0.5)
    xs = torch.rand((m,), generator=cuda, device="cuda") + 0.5
    if kind == "aw":
        xop = (codes((m, k // 8, 4)), torch.full((m, k // 8), fill, dtype=torch.uint8,
                                                 device="cuda"), xs)
    else:
        xop = (codes((m, k)), xs)
    total, tc = _int8_counters(kind)
    before = tc.launches
    y, want, acc, x_dense = _int8_run(kind, cfg, xop, wop)
    w_dense = ref.decode_w(wop[0], wop[1], cfg)
    assert torch.equal(acc, ref.int8_acc(x_dense, w_dense))
    assert torch.equal(y, want)
    assert tc.launches == before + 1
    if fill == 0:
        assert not acc.any()


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "per_tensor"])
@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_int8_tc_epilogue(cuda, per_row, act, kind):
    """The tc body's epilogue: per-row and per-tensor x_scale, with and
    without bias, each activation, f32 and bf16 outputs, acc_out.  The
    accumulators, and every output of ``act`` None or relu, bit for bit;
    silu and gelu in f32 within 1e-6 (+ 1e-6 relative: the card's expf and
    tanhf against ATen's), in bf16 within that plus one bf16 ulp (an f32
    difference can straddle a bf16 rounding)."""
    m, k, n = 33, 384, 272
    cfg, xop, wop = _int8_operands(cuda, m, k, n, kind, per_row=per_row)
    bias = torch.randn((n,), generator=cuda, device="cuda")
    w_dense = ref.decode_w(wop[0], wop[1], cfg)
    total, tc = _int8_counters(kind)
    before = tc.launches
    for out_dtype, b in ((torch.float32, None), (torch.float32, bias), (torch.bfloat16, bias),
                         (torch.bfloat16, None)):
        y, want, acc, x_dense = _int8_run(kind, cfg, xop, wop, act=act, bias=b,
                                          out_dtype=out_dtype)
        assert torch.equal(acc, ref.int8_acc(x_dense, w_dense))
        assert y.dtype == out_dtype
        y, want = y.float(), want.float()
        if act in (None, "relu"):
            assert torch.equal(y, want), (out_dtype, b is not None)
            continue
        tol = 1e-6 + 1e-6 * want.abs()
        if out_dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * torch.maximum(y.abs(), want.abs())
        assert bool(((y - want).abs() <= tol).all()), (out_dtype, b is not None)
    assert tc.launches == before + 4


@pytest.mark.parametrize("m,k,n", [(4, 136, 144), (64, 1000, 160), (17, 256, 200),
                                   (5, 128, 36), (64, 384, 288), (3, 128, 16), (100, 2048, 48)])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_int8_ragged_shapes(cuda, m, k, n, kind):
    """Ragged K and N: K % 128 or N % 16 (the first four) go to the generic
    body, the rest (a partial last column tile, one k-step, two row tiles)
    run the tc body; every one bit for bit."""
    cfg, xop, wop = _int8_operands(cuda, m, k, n, kind)
    total, tc = _int8_counters(kind)
    before = (total.launches, tc.launches)
    y, want, acc, x_dense = _int8_run(kind, cfg, xop, wop)
    assert torch.equal(acc, ref.int8_acc(x_dense, ref.decode_w(wop[0], wop[1], cfg)))
    assert torch.equal(y, want)
    takes_tc = dbb_matmul.int8_body_error(k // 8, n) is None
    assert takes_tc == (k % 128 == 0 and n % 16 == 0)
    assert (total.launches, tc.launches) == (before[0] + 1, before[1] + takes_tc)


def test_int8_misaligned_x_runs_generic(cuda):
    """An x that cp.async cannot copy (not 16-byte aligned) runs the
    generic body, by the rule, bit for bit."""
    m, k, n = 8, 256, 128
    cfg, (xq, xs), wop = _int8_operands(cuda, m, k, n, "w")
    buf = torch.empty(m * k + 4, dtype=torch.int8, device="cuda")
    x_off = buf[4:].view(m, k)
    x_off.copy_(xq)
    assert dbb_matmul.int8_body_error(k // 8, n, 4, (x_off.data_ptr(),)) is not None
    before = (dbb_matmul.INT8.launches, dbb_matmul.INT8_TC.launches)
    y = dbb_matmul.dbb_matmul_int8_cuda(x_off, xs, *wop, cfg)
    assert torch.equal(y, ref.dbb_matmul_int8_ref(xq, xs, *wop, cfg))
    assert (dbb_matmul.INT8.launches, dbb_matmul.INT8_TC.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("s", [3, 70], ids=["chunk", "long_chunk"])
def test_paged_attn_kernel_f32(cuda, s, int8):
    """A long chunk (70 tokens x 2 heads > 64 rows) spans row blocks; KV
    pages int8 with scales, or native f32."""
    n_pages, ps, kv, d, b = 12, 8, 2, 32, 3
    k_q = torch.randn((n_pages, ps, kv * d), generator=cuda, device="cuda")
    v_q = torch.randn((n_pages, ps, kv * d), generator=cuda, device="cuda")
    k_s = v_s = None
    if int8:
        (k_q, k_s), (v_q, v_s) = quant.quantize_rows(k_q), quant.quantize_rows(v_q)
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    pos[3] = torch.arange(ps, dtype=torch.int32)
    pos[7, :5] = torch.arange(ps, ps + 5, dtype=torch.int32)
    pos[5, :6] = torch.arange(6, dtype=torch.int32)
    # null-padded to 6 pages: runs of the null page inside the first split
    # of 4 pages and across the second
    tables = torch.tensor([[3, 7, 9, 0, 0, 0], [5, 0, 0, 0, 0, 0], [0] * 6], dtype=torch.int32,
                          device="cuda")
    q = torch.randn((b, s, 2 * kv, d), generator=cuda, device="cuda")
    # the last s positions of each request; negative ones are padding rows,
    # and request 2 is an idle row over the null page: rows with no valid
    # key take the uniform mean over their table, as in the plain version
    q_pos = torch.stack([torch.arange(13 - s, 13), torch.arange(6 - s, 6),
                         torch.full((s,), -1)]).to(device="cuda", dtype=torch.int32)
    for window in (None, 4):
        kw = dict(kv_heads=kv, window=window, k_scale=k_s, v_scale=v_s)
        got = paged_attn.paged_attn_cuda(q, k_q, v_q, pos, tables, q_pos, **kw)
        want = ref.paged_attn_ref(q, k_q, v_q, pos, tables, q_pos, **kw)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _tc_case(gen, b, s, g, d, kv, int8, p_cnt, ps=16):
    """bf16 GQA operands at a serving head shape: request 0 cached 70
    tokens over pages 1..5, request 1 cached 9 over pages 6 and 7 (page 7
    scrubbed, all slots -1, when page 6 holds the 9), request 2 is idle
    (positions -1 over the null page 0) and request 3 cached 40 over pages
    8..10; every
    table is null-padded to ``p_cnt`` pages, so a null run crosses split
    boundaries.  Query rows are the last ``s`` tokens, those before the
    first cached one padding (-1); request 1 also pads its last rows."""
    n_pages = 12
    k_f = torch.randn((n_pages, ps, kv * d), generator=gen, device="cuda")
    v_f = torch.randn((n_pages, ps, kv * d), generator=gen, device="cuda")
    kw = dict(kv_heads=kv)
    if int8:
        (k, k_s), (v, v_s) = quant.quantize_rows(k_f), quant.quantize_rows(v_f)
        kw.update(k_scale=k_s, v_scale=v_s)
    else:
        k, v = k_f.to(torch.bfloat16), v_f.to(torch.bfloat16)
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    tables = torch.zeros((4, p_cnt), dtype=torch.int32, device="cuda")
    for i, (t, pages) in enumerate(((70, [1, 2, 3, 4, 5]), (9, [6, 7]), (0, []),
                                    (40, [8, 9, 10]))):
        for j, page in enumerate(pages):
            p = torch.arange(j * ps, (j + 1) * ps, device="cuda")
            pos[page] = torch.where(p < t, p, -1).to(torch.int32)
        if pages:
            tables[i, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
    q_pos = torch.full((4, s), -1, dtype=torch.int32, device="cuda")
    for i, t in enumerate((70, 9, 0, 40)):
        n = min(s, t) if i != 1 else min(s, t, max(1, s - 2))
        q_pos[i, :n] = torch.arange(t - n, t, dtype=torch.int32, device="cuda")
    q = torch.randn((4, s, kv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
    return q[:b], k, v, pos, tables[:b], q_pos[:b], kw


@pytest.mark.parametrize("g,d", [(4, 128), (2, 64), (8, 128), (12, 128)],
                         ids=["granite", "granite_moe", "qwen2_vl", "starcoder2"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("s", [1, 16, 20])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_attn_tc_kernel_bf16(cuda, monkeypatch, g, d, int8, s, splits, ps):
    """#6's tensor-core kernel (bf16 GQA) against the plain version at
    granite-3-8b's, granite-moe-1b-a400m's, qwen2-vl-72b's (8 query heads
    a KV head) and starcoder2-15b's (12) head shapes: decode, a whole
    chunk and a chunk over 64 rows (two row blocks), padding rows, an idle
    row over the null page, a scrubbed page, window None and 4, with one
    split (the output written directly) and with three (the combine);
    pages of 8 slots (a half-filled 16-slot chunk), 16 and 32 (the larger
    S fragment)."""
    if splits == 1:  # a table no wider than one split
        monkeypatch.setattr(paged_attn, "PAGES_PER_SPLIT", 8)
        p_cnt = 8
    else:
        p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    q, k, v, pos, tables, q_pos, kw = _tc_case(cuda, 4, s, g, d, 8, int8, p_cnt, ps)
    for window in (None, 4):
        before = paged_attn.PAGED_ATTN_TC.launches
        got = paged_attn.paged_attn_cuda(q, k, v, pos, tables, q_pos, window=window, **kw)
        assert paged_attn.PAGED_ATTN_TC.launches == before + 1
        want = ref.paged_attn_ref(q, k, v, pos, tables, q_pos, window=window, **kw)
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1.6e-2, (window, err)


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("ps", [1, 2, 3, 4, 5, 12, 24, 64, 65, 72, 128])
def test_paged_attn_tc_kernel_bf16_page_sizes(cuda, int8, ps):
    """Page sizes that are not a multiple of 8 (pad slots at position -1
    with a zero K row and a -inf logit), 64, and pages above 64 slots,
    walked as 64-slot sub-pages (65: a one-slot tail; 72; 128: two whole
    sub-pages, the second of request 0's page empty) at granite-3-8b's
    head shape: mixed and keyless rows within 1.6e-2."""
    p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    q, k, v, pos, tables, q_pos, kw = _tc_case(cuda, 4, 16, 4, 128, 8, int8, p_cnt, ps)
    before = paged_attn.PAGED_ATTN_TC.launches
    got = paged_attn.paged_attn_cuda(q, k, v, pos, tables, q_pos, **kw)
    assert paged_attn.PAGED_ATTN_TC.launches == before + 1
    want = ref.paged_attn_ref(q, k, v, pos, tables, q_pos, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2, err


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("s", [1, 16])
def test_paged_attn_tc_rows_bitwise_independent_of_batch(cuda, int8, s):
    """A request's output rows are the same bits served alone (B=1) and
    inside a B=4 call: the page splits have a fixed width and nothing is
    reduced across requests."""
    p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    q, k, v, pos, tables, q_pos, kw = _tc_case(cuda, 4, s, 4, 128, 8, int8, p_cnt)
    full = paged_attn.paged_attn_cuda(q, k, v, pos, tables, q_pos, **kw)
    for i in range(4):
        alone = paged_attn.paged_attn_cuda(q[i:i + 1].contiguous(), k, v, pos,
                                           tables[i:i + 1].contiguous(),
                                           q_pos[i:i + 1].contiguous(), **kw)
        assert torch.equal(alone[0], full[i]), i


@pytest.mark.parametrize("g,dk,dv,ps", [(4, 40, 40, 16), (4, 64, 60, 16), (4, 64, 136, 16),
                                        (4, 64, 64, 0), (80, 64, 64, 16)])
def test_paged_attn_tc_unsupported_shapes_raise(cuda, g, dk, dv, ps):
    """bf16 GQA shapes the tensor-core kernel does not take raise; nothing
    falls back to the scalar kernel or the plain version."""
    kv, n_pages = 2, 3
    q = torch.zeros((1, 1, kv * g, dk), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((n_pages, ps, kv * dk), dtype=torch.bfloat16, device="cuda")
    v = torch.zeros((n_pages, ps, kv * dv), dtype=torch.bfloat16, device="cuda")
    pos = torch.zeros((n_pages, ps), dtype=torch.int32, device="cuda")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    q_pos = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    before = (paged_attn.PAGED_ATTN.launches, paged_attn.PAGED_ATTN_TC.launches)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        paged_attn.paged_attn_cuda(q, k, v, pos, tables, q_pos, kv_heads=kv)
    assert (paged_attn.PAGED_ATTN.launches, paged_attn.PAGED_ATTN_TC.launches) == before


def _native_operands(gen, m, k, n, dtype):
    cfg = dbb.DBBConfig(4, 8)
    w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(dtype)
    wv, wm = ops.pack_weight(w, cfg)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    xv, xm = ops.dap_pack(x, 4, 8)
    bias = torch.randn((n,), generator=gen, device="cuda")
    return cfg, x, xv, xm, wv, wm, bias


@pytest.mark.parametrize("m,k,n", [(4, 64, 128), (5, 40, 24), (64, 256, 200), (17, 136, 70),
                                   (3, 2048, 290)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_native_matmul_kernels_vs_plain(cuda, m, k, n, dtype, kind):
    """Kernels #1 and #4 vs their plain versions, ragged N included (70
    and 290 are not multiples of 4: the generic body's scalar load path).
    bf16 calls with N % 8 == 0 and K % 64 == 0 run the tc body, the rest
    the generic body."""
    cfg, x, xv, xm, wv, wm, bias = _native_operands(cuda, m, k, n, dtype)
    counter, tc = ((dbb_matmul.AW_NATIVE, dbb_matmul.AW_NATIVE_TC) if kind == "aw"
                   else (dbb_matmul.NATIVE, dbb_matmul.NATIVE_TC))
    before = (counter.launches, tc.launches)
    for act, b in ((None, None), ("silu", bias), ("gelu", None)):
        if kind == "aw":
            got = dbb_matmul.dbb_matmul_aw_cuda(xv, xm, wv, wm, cfg, cfg, bias=b, act=act,
                                                out_dtype=torch.float32)
            want = ref.dbb_matmul_aw_ref(xv, xm, wv, wm, cfg, cfg, bias=b, act=act,
                                         out_dtype=torch.float32)
        else:
            got = dbb_matmul.dbb_matmul_cuda(x, wv, wm, cfg, bias=b, act=act,
                                             out_dtype=torch.float32)
            want = ref.dbb_matmul_ref(x, wv, wm, cfg, bias=b, act=act, out_dtype=torch.float32)
        tol32 = 1e-5 * want.abs().max().item() + 1e-6
        err = (got - want).abs().max().item()
        assert err <= tol32, (act, err)
    got16 = (dbb_matmul.dbb_matmul_aw_cuda(xv, xm, wv, wm, cfg, cfg, out_dtype=torch.bfloat16)
             if kind == "aw" else dbb_matmul.dbb_matmul_cuda(x, wv, wm, cfg,
                                                            out_dtype=torch.bfloat16))
    want16 = ref.dbb_matmul_aw_ref(xv, xm, wv, wm, cfg, cfg, out_dtype=torch.bfloat16) \
        if kind == "aw" else ref.dbb_matmul_ref(x, wv, wm, cfg, out_dtype=torch.bfloat16)
    err16 = (got16.float() - want16.float()).abs()
    ulp = 2.0 ** -7 * torch.maximum(got16.float().abs(), want16.float().abs())
    assert bool((err16 <= ulp + 1e-5 * want16.float().abs().max().item() + 1e-6).all())
    takes_tc = dtype == torch.bfloat16 and n % 8 == 0 and k % 64 == 0
    assert counter.launches == before[0] + 4
    assert tc.launches == before[1] + (4 if takes_tc else 0)


@pytest.mark.parametrize("nnz", [1, 2, 3, 5])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_native_matmul_tc_nnz(cuda, nnz, kind):
    """Other densities than 4 of 8: the tc body decodes up to 4 values an
    8-block (its tables clamp ranks to NNZ - 1 like the oracle), more go
    to the generic body; both within the tolerances above."""
    cfg = dbb.DBBConfig(nnz, 8)
    m, k, n = 20, 256, 136
    w = (torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
    wv, wm = ops.pack_weight(w, cfg)
    x = torch.randn((m, k), generator=cuda, device="cuda").to(torch.bfloat16)
    xv, xm = ops.dap_pack(x, nnz, 8)
    tc = dbb_matmul.AW_NATIVE_TC if kind == "aw" else dbb_matmul.NATIVE_TC
    before = tc.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        if kind == "aw":
            got = dbb_matmul.dbb_matmul_aw_cuda(xv, xm, wv, wm, cfg, cfg, act="silu",
                                                out_dtype=out_dtype).float()
            want = ref.dbb_matmul_aw_ref(xv, xm, wv, wm, cfg, cfg, act="silu",
                                         out_dtype=out_dtype).float()
        else:
            got = dbb_matmul.dbb_matmul_cuda(x, wv, wm, cfg, act="silu", out_dtype=out_dtype).float()
            want = ref.dbb_matmul_ref(x, wv, wm, cfg, act="silu", out_dtype=out_dtype).float()
        tol = 1e-5 * want.abs().max().item() + 1e-6
        if out_dtype == torch.bfloat16:
            tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + tol
        assert bool(((got - want).abs() <= tol).all()), out_dtype
    assert tc.launches == before + (2 if nnz <= 4 else 0)


def _smoke_native_linears():
    """``chip_smoke.py``'s full-width native-wire linears that the tc body
    takes: (arch, name, kernel, activation, DAP-pruned input, K, N)."""
    return [row[:-1] for row in _smoke_module().NATIVE_LINEARS if row[-1] == "tc"]


@pytest.mark.parametrize("arch,name,kind,act,dap,k,n", _smoke_native_linears(),
                         ids=lambda v: str(v))
def test_native_matmul_tc_full_width(cuda, arch, name, kind, act, dap, k, n):
    """The tc body at every full-width shape of minicpm3-4b's and
    granite-moe-1b-a400m's native-wire linears, bf16, at M = 1, 4 and 64:
    every call on the tc body, f32 output within 1e-5 of the largest
    output of the plain version, bf16 within that plus one bf16 ulp, and a
    row's bits the same at every M."""
    cfg = dbb.DBBConfig(4, 8)
    bf16 = torch.bfloat16
    w = (torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)).to(bf16)
    wv, wm = ops.pack_weight(w, cfg)
    x = torch.randn((64, k), generator=cuda, device="cuda").to(bf16)
    if dap:
        x = apply_dap(x, DAPSpec(4, 8))
    xv, xm = ops.dap_pack(x, 4, 8)
    tc = dbb_matmul.AW_NATIVE_TC if kind == "aw" else dbb_matmul.NATIVE_TC

    def run(fn, m, out_dtype):
        if kind == "aw":
            return fn(xv[:m], xm[:m], wv, wm, cfg, cfg, act=act, out_dtype=out_dtype)
        return fn(x[:m], wv, wm, cfg, act=act, out_dtype=out_dtype)

    kern = dbb_matmul.dbb_matmul_aw_cuda if kind == "aw" else dbb_matmul.dbb_matmul_cuda
    plain = ref.dbb_matmul_aw_ref if kind == "aw" else ref.dbb_matmul_ref
    before = tc.launches
    y = {m: run(kern, m, torch.float32) for m in (1, 4, 64)}
    assert tc.launches == before + 3
    assert torch.equal(y[1][0], y[4][0]) and torch.equal(y[4], y[64][:4])
    for m in (1, 4, 64):
        want = run(plain, m, torch.float32)
        tol32 = 1e-5 * want.abs().max().item()
        assert (y[m] - want).abs().max().item() <= tol32, m
        yb = run(kern, m, bf16).float()
        yb_ref = run(plain, m, bf16).float()
        ulp = 2.0 ** -7 * torch.maximum(yb.abs(), yb_ref.abs())
        assert bool(((yb - yb_ref).abs() <= ulp + tol32).all()), m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_native_matmul_rows_bitwise_independent_of_m(cuda, dtype, kind):
    """A row's output bits are the same at M=1, inside M=4, M=64 and M=100
    (two row tiles): the K split depends on (K, N) only and nothing is
    added atomically; bf16 runs the tc body (eight splits in a cluster),
    f32 the generic body."""
    cfg, x, xv, xm, wv, wm, _ = _native_operands(cuda, 100, 2560, 288, dtype)

    def run(rows):
        if kind == "aw":
            return dbb_matmul.dbb_matmul_aw_cuda(xv[rows], xm[rows], wv, wm, cfg, cfg, act="silu")
        return dbb_matmul.dbb_matmul_cuda(x[rows], wv, wm, cfg, act="silu")

    full = run(slice(0, 100))
    assert torch.equal(run(slice(0, 64)), full[:64])
    assert torch.equal(run(slice(20, 24)), full[20:24])
    for r in (0, 21, 63, 99):
        assert torch.equal(run(slice(r, r + 1))[0], full[r]), r


@pytest.mark.parametrize("int8", [False, True], ids=["native_kv", "int8_kv"])
@pytest.mark.parametrize("s", [1, 5])
def test_paged_attn_latent_kernel(cuda, int8, s):
    """#6 in MLA's latent mode: kv_heads=1, v the first Dv features of the
    dequantized k row, no v pages or v scale, an explicit softmax scale."""
    n_pages, ps, lora, rope_d, h, b = 12, 8, 40, 8, 6, 3
    lat = torch.randn((n_pages, ps, lora + rope_d), generator=cuda, device="cuda")
    k_scale = None
    if int8:
        lat, k_scale = quant.quantize_rows(lat)
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    pos[3] = torch.arange(ps, dtype=torch.int32)
    pos[7, :5] = torch.arange(ps, ps + 5, dtype=torch.int32)
    pos[5, :6] = torch.arange(6, dtype=torch.int32)
    tables = torch.tensor([[3, 7, 9], [5, 0, 0], [0, 0, 0]], dtype=torch.int32, device="cuda")
    q = torch.randn((b, s, h, lora + rope_d), generator=cuda, device="cuda")
    q_pos = torch.stack([torch.arange(13 - s, 13), torch.arange(6 - s, 6),
                         torch.full((s,), -1)]).to(device="cuda", dtype=torch.int32)
    kw = dict(kv_heads=1, softmax_scale=0.21, k_scale=k_scale, latent_dv=lora)
    got = paged_attn.paged_attn_cuda(q, lat, None, pos, tables, q_pos, **kw)
    want = ref.paged_attn_ref(q, lat, None, pos, tables, q_pos, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert paged_attn.PAGED_ATTN_LATENT.launches > 0


def _latent_case(gen, s, int8, p_cnt, ps, h=40, dk=288, dv=256):
    """bf16 latent operands at minicpm3-4b's head shape (40 query heads
    over one 288-wide latent, v its first 256 features): the requests of
    ``_tc_case`` (a long one, a short one whose second page is scrubbed
    when the first holds its 9 tokens, an idle one over the null page, and
    a third), each as many tokens as its pages hold, padding rows before a
    request's first cached token and at the end of request 1, tables
    null-padded to ``p_cnt`` pages."""
    n_pages = 12
    lat = torch.randn((n_pages, ps, dk), generator=gen, device="cuda")
    k_scale = None
    if int8:
        lat, k_scale = quant.quantize_rows(lat)
    else:
        lat = lat.to(torch.bfloat16)
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    tables = torch.zeros((4, p_cnt), dtype=torch.int32, device="cuda")
    lengths = []
    for i, (t, pages) in enumerate(zip((70, 9, 0, 40), ([1, 2, 3, 4, 5], [6, 7], [], [8, 9, 10]))):
        t = min(t, len(pages) * ps)  # tokens the pages hold
        lengths.append(t)
        for j, page in enumerate(pages):
            p = torch.arange(j * ps, (j + 1) * ps, device="cuda")
            pos[page] = torch.where(p < t, p, -1).to(torch.int32)
        if pages:
            tables[i, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
    q_pos = torch.full((4, s), -1, dtype=torch.int32, device="cuda")
    for i, t in enumerate(lengths):
        n = min(s, t) if i != 1 else min(s, t, max(1, s - 2))
        q_pos[i, :n] = torch.arange(t - n, t, dtype=torch.int32, device="cuda")
    q = torch.randn((4, s, h, dk), generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(kv_heads=1, softmax_scale=1.0 / math.sqrt(96), k_scale=k_scale, latent_dv=dv)
    return q, lat, pos, tables, q_pos, kw


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("s", [1, 16, 20])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("ps", [4, 8, 16, 32])
def test_paged_attn_latent_tc_kernel_bf16(cuda, monkeypatch, int8, s, splits, ps):
    """#6's latent tensor-core kernel (bf16 MLA) against the plain version
    at minicpm3-4b's head shapes: decode (40 rows, one row tile), a whole
    chunk (640 rows over 10 tiles) and 20 tokens (800 rows, tiles across
    token boundaries), padding rows, an idle row over the null page, a
    scrubbed page, one split (the output written directly) and three (the
    combine), pages of 4, 8, 16 and 32 slots."""
    if splits == 1:  # a table no wider than one split
        monkeypatch.setattr(paged_attn, "PAGES_PER_SPLIT", 8)
        p_cnt = 8
    else:
        p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    q, lat, pos, tables, q_pos, kw = _latent_case(cuda, s, int8, p_cnt, ps)
    before = (paged_attn.PAGED_ATTN_LATENT.launches, paged_attn.PAGED_ATTN_LATENT_TC.launches)
    got = paged_attn.paged_attn_cuda(q, lat, None, pos, tables, q_pos, **kw)
    assert (paged_attn.PAGED_ATTN_LATENT.launches,
            paged_attn.PAGED_ATTN_LATENT_TC.launches) == (before[0] + 1, before[1] + 1)
    want = ref.paged_attn_ref(q, lat, None, pos, tables, q_pos, **kw)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2, err


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("ps", [65, 72, 128])
def test_paged_attn_latent_tc_kernel_bf16_large_pages(cuda, int8, s, ps):
    """The latent tensor-core kernel at pages above 64 slots (64-slot
    sub-pages, the last one shorter) at minicpm3-4b's head shapes, with
    padding rows, an idle row and a scrubbed page, over three splits."""
    p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    q, lat, pos, tables, q_pos, kw = _latent_case(cuda, s, int8, p_cnt, ps)
    before = paged_attn.PAGED_ATTN_LATENT_TC.launches
    got = paged_attn.paged_attn_cuda(q, lat, None, pos, tables, q_pos, **kw)
    assert paged_attn.PAGED_ATTN_LATENT_TC.launches == before + 1
    want = ref.paged_attn_ref(q, lat, None, pos, tables, q_pos, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2, err


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("ps", [8, 16, 72])
def test_paged_attn_latent_tc_kernel_bf16_narrow_latent(cuda, monkeypatch, int8, s, splits, ps):
    """minicpm3-4b's smoke latent: Dk 40 (kv_lora 32 + rope 8, not a
    multiple of 16: zero-padded to 48 in shared memory, int8 rows copied 8
    bytes at a time), Dv 32, 4 heads; one split and three."""
    if splits == 1:  # a table no wider than one split
        monkeypatch.setattr(paged_attn, "PAGES_PER_SPLIT", 8)
        p_cnt = 8
    else:
        p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    q, lat, pos, tables, q_pos, kw = _latent_case(cuda, s, int8, p_cnt, ps, h=4, dk=40, dv=32)
    before = paged_attn.PAGED_ATTN_LATENT_TC.launches
    got = paged_attn.paged_attn_cuda(q, lat, None, pos, tables, q_pos, **kw)
    assert paged_attn.PAGED_ATTN_LATENT_TC.launches == before + 1
    want = ref.paged_attn_ref(q, lat, None, pos, tables, q_pos, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2, err


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("s", [1, 16])
def test_paged_attn_latent_tc_rows_bitwise_independent_of_batch(cuda, int8, s):
    """A request's latent rows are the same bits alone (B=1) and inside a
    B=4 call: the row tiles and splits are fixed by the mode, and a row's
    arithmetic is its own warps'."""
    p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    q, lat, pos, tables, q_pos, kw = _latent_case(cuda, s, int8, p_cnt, 16)
    full = paged_attn.paged_attn_cuda(q, lat, None, pos, tables, q_pos, **kw)
    for i in range(4):
        alone = paged_attn.paged_attn_cuda(q[i:i + 1].contiguous(), lat, None, pos,
                                           tables[i:i + 1].contiguous(),
                                           q_pos[i:i + 1].contiguous(), **kw)
        assert torch.equal(alone[0], full[i]), i


@pytest.mark.parametrize("dk,dv,ps", [(36, 32, 16), (288, 260, 16), (320, 264, 16),
                                      (288, 256, 0)])
def test_paged_attn_latent_tc_unsupported_shapes_raise(cuda, dk, dv, ps):
    """bf16 latent shapes the tensor-core kernel does not take raise;
    nothing falls back to the scalar kernel or the plain version."""
    n_pages = 3
    q = torch.zeros((1, 1, 40, dk), dtype=torch.bfloat16, device="cuda")
    lat = torch.zeros((n_pages, ps, dk), dtype=torch.bfloat16, device="cuda")
    pos = torch.zeros((n_pages, ps), dtype=torch.int32, device="cuda")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    q_pos = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    before = (paged_attn.PAGED_ATTN_LATENT.launches, paged_attn.PAGED_ATTN_LATENT_TC.launches)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        paged_attn.paged_attn_cuda(q, lat, None, pos, tables, q_pos, kv_heads=1, latent_dv=dv)
    assert (paged_attn.PAGED_ATTN_LATENT.launches,
            paged_attn.PAGED_ATTN_LATENT_TC.launches) == before


@pytest.mark.parametrize("page_size", [2, 4])
def test_engine_serves_small_pages_bf16(cuda, monkeypatch, page_size):
    """A granite smoke config in bf16 serves at page sizes 2 and 4 on
    CUDA through the tensor-core kernel, and its tokens equal the same
    engine's on the CPU (the kernels' plain versions).  A split here
    takes a whole table (32 pages): the kernel then walks the pages in
    the plain version's order and writes its output itself.  With several
    splits the combine rounds in another order, within 1.6e-2 of the
    plain version (the kernel tests above), and DAP's top-4 selection
    after attention can turn one bf16 ulp into another token: at
    ``page_size=2`` and 4 pages a split, the 15th token of a request
    differs, its logits 0.3-0.6 apart on the two devices (NVIDIA H100)."""
    monkeypatch.setattr(paged_attn, "PAGES_PER_SPLIT", 32)
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = dataclasses.replace(configs.get_config("granite_3_8b", smoke=True), vocab=64,
                              d_model=64, d_ff=128, n_layers=2, dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
    # "fused" by name: the CPU engine's "auto" would gather
    scfg = ServeConfig(prefill_mode="continuous", pack_weights=True, max_seq=32,
                       page_size=page_size, max_batch=2, prefill_chunk=4, paged_attn="fused")
    rng = np.random.default_rng(page_size)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 5, 12)]
    outs = {}
    for device in ("cpu", "cuda"):
        ops.reset_counters()
        paged_attn.PAGED_ATTN_TC.launches = 0
        eng = Engine(params, cfg, scfg, device=device)
        outs[device] = eng.generate_requests(prompts, 6, arrivals=[0, 3, 1])
    attn = ops.counters()["paged_attn"]
    assert attn.plain == 0 and attn.launches > 0
    assert paged_attn.PAGED_ATTN_TC.launches == attn.launches
    for got, want in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_engine_serves_large_pages_bf16(cuda, monkeypatch, arch):
    """bf16 smoke engines serve at ``page_size=72`` on CUDA: each page is
    walked as sub-pages of 64 and 8 slots, and prompts of 70 and 80 tokens
    cross the sub-page boundary.  granite runs the GQA tensor-core kernel;
    minicpm3 the latent one at its smoke latent of 40 (kv_lora 32 + rope
    8, zero-padded to 48 in shared memory), the shape that kernel refused
    before.  A split takes a whole table, as above.

    With weights-only DBB (``wdbb``: no DAP) the tokens equal the CPU
    engine's and a solo prefill's logits agree within four bf16 ulps of
    the largest (measured on an NVIDIA H100: 0.025 and 0.035 of 3.5 and
    4.3, the same gap as at 16-slot pages).  With DAP (the configs'
    ``awdbb``) the sub-pages' online softmax rounds in another order than
    the plain version's whole page and DAP's top-4 selection turns one
    bf16 ulp into other tokens (logits 1.2 and 2.6 apart there; the CPU
    engine alone moves 1.7 and 2.6 between page sizes 16 and 72), so that
    engine is held to itself: every request served, every attention call
    on the tensor-core kernel, the longest request re-served alone
    byte-identical."""
    monkeypatch.setattr(paged_attn, "PAGES_PER_SPLIT", 32)
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import paged_cache
    from repro_torch.serve.engine import Engine, ServeConfig

    scfg = ServeConfig(prefill_mode="continuous", pack_weights=True, max_seq=160, page_size=72,
                       max_batch=2, prefill_chunk=16, paged_attn="fused")
    rng = np.random.default_rng(72)
    attn = "paged_attn_latent" if arch == "minicpm3_4b" else "paged_attn"
    tc = paged_attn.PAGED_ATTN_LATENT_TC if arch == "minicpm3_4b" else paged_attn.PAGED_ATTN_TC
    for mode in ("wdbb", "awdbb"):
        cfg = configs.get_config(arch, smoke=True)
        if arch == "granite_3_8b":
            cfg = dataclasses.replace(cfg, vocab=64, d_model=64, d_ff=128)
        cfg = dataclasses.replace(cfg, n_layers=2, dtype="bfloat16",
                                  sparsity=dataclasses.replace(cfg.sparsity, mode=mode))
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
        prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (70, 5, 80)]
        outs, logits = {}, {}
        for device in ("cpu", "cuda"):
            ops.reset_counters()
            tc.launches = 0
            eng = Engine(params, cfg, scfg, device=device)
            outs[device] = eng.generate_requests(prompts, 6, arrivals=[0, 3, 1])
            s = len(prompts[2])
            n_pages = -(-s // 72) + 1
            cache = paged_cache.make_paged_cache(eng.cfg, n_pages, 72, device)
            lg, _ = lm.paged_step(
                eng.params, cache, torch.tensor(prompts[2][None], device=device),
                torch.arange(s, dtype=torch.int32, device=device)[None],
                torch.arange(1, n_pages, dtype=torch.int32, device=device)[None], eng.cfg)
            logits[device] = lg[0, :, :cfg.vocab].float().cpu()
        count = ops.counters()[attn]
        assert count.plain == 0 and count.launches > 0
        assert tc.launches == count.launches
        if mode == "wdbb":
            for got, want in zip(outs["cuda"], outs["cpu"]):
                np.testing.assert_array_equal(got, want)
            bound = 4 * 2.0 ** -7 * logits["cpu"].abs().max().item()
            assert (logits["cuda"] - logits["cpu"]).abs().max().item() <= bound
        else:
            again = eng.generate_requests([prompts[2]], 6)[0]
            np.testing.assert_array_equal(again, outs["cuda"][2])


@pytest.mark.parametrize("m,k", [(4, 768), (64, 4096), (3, 40), (1, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nnz", [1, 2, 3, 4, 5, 8])
def test_dap_prune_kernel_bit_exact(cuda, m, k, dtype, nnz):
    """#5 vs its plain version, bit for bit: ties (small integers), zeros
    of both signs, +-inf and a NaN in the first row; a misaligned input
    (an offset view) goes through an aligned copy."""
    x = torch.randn((m, k), generator=cuda, device="cuda")
    x[0, : min(k, 8)] = torch.tensor([3.0, -3.0, 0.0, -0.0, float("inf"), -3.0, float("nan"),
                                      1.0], device="cuda")[: min(k, 8)]
    if m > 1:
        x[1] = torch.randint(-2, 3, (k,), generator=cuda, device="cuda").float()
        x[1, :8] = -0.0
    x = x.to(dtype)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    buf = torch.empty(m * k + 4, dtype=dtype, device="cuda")
    buf[4:] = x.reshape(-1)
    for xin in (x, buf[4:].view(m, k)):
        got_p, got_m = dap_prune.dap_prune_cuda(xin, nnz)
        want_p, want_m = ref.dap_prune_ref(x, nnz)
        assert torch.equal(got_p.view(view), want_p.view(view))
        assert torch.equal(got_m, want_m)
    assert dap_prune.DAP_PRUNE.launches > 0


# ---------------------------------------------------------------- DAP's four forms

# form -> (kernel wrapper, plain version); each returns a tuple of tensors
DAP_FORMS = {
    "dense": (dap_prune.dap_prune_cuda, ref.dap_prune_ref),
    "pack": (dap_prune.dap_pack_cuda, ref.dap_pack_ref),
    "dense_int8": (dap_prune.dap_prune_int8_cuda, ref.dap_prune_int8_ref),
    "pack_int8": (dap_prune.dap_pack_int8_cuda, ref.dap_pack_int8_ref),
}
# every DAP width of the served paths and qwen1.5-110b's down input, then odd ones
DAP_SERVED_KS = [768, 1024, 2560, 4096, 6400, 12800, 6144, 8192, 24576, 29568, 49152]
DAP_KS = DAP_SERVED_KS + [8, 40, 136]


def _dap_rows(gen, m, k, dtype):
    """Normal rows with the hard cases planted in the first four: a NaN in
    block 0 and a NaN block (row 0), ties of small integers and a -0.0
    block (row 1), +-inf (row 2: its int8 scale is inf, a kept infinity's
    quotient NaN, which the card casts to code 0 on both sides), zeros
    of both signs around one non-zero (row 3)."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    inf, nan = float("inf"), float("nan")
    rows = [[3.0, -3.0, 0.0, -0.0, inf, -3.0, nan, 1.0],
            None,
            [inf, -inf, 1.0, -inf, 2.0, inf, 0.5, -1.0],
            [0.0, -0.0, 0.0, 1.5, -0.0, 0.0, 0.0, -0.0]]
    for i, row in enumerate(rows[:m]):
        if i == 1:
            x[1] = torch.randint(-2, 3, (k,), generator=gen, device="cuda").float()
            x[1, :8] = -0.0
            continue
        x[i, :8] = torch.tensor(row, device="cuda")
        if k >= 16:
            x[i, 8:16] = nan if i == 0 else -0.0
    return x.to(dtype)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(a.dtype, a.dtype)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("form", sorted(DAP_FORMS))
@pytest.mark.parametrize("k", DAP_KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nnz", [1, 2, 3, 4, 5, 8])
def test_dap_forms_bit_exact(cuda, form, k, dtype, nnz):
    """Each of #5's forms against its plain version on the card, bit for
    bit (values, masks, codes, scales; NaNs included), at M = 1 to 100
    rows of every main-path width; a row's bits are the same at M = 1, 4,
    64 and 100, and a misaligned input (an offset view) goes through an
    aligned copy."""
    kern, plain = DAP_FORMS[form]
    x = _dap_rows(cuda, 100, k, dtype)
    before = {name: c.launches for name, c in ops.counters().items()}
    full = kern(x, nnz)
    for m in (1, 3, 4, 17, 64, 100):
        got = kern(x[:m], nnz)
        want = plain(x[:m], nnz)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert _bits_equal(g, w), f"{form} M={m} output {i} differs from its plain version"
            assert _bits_equal(g, full[i][:m]), f"{form} M={m} output {i}: rows depend on M"
    buf = torch.empty(64 * k + 4, dtype=dtype, device="cuda")
    buf[4:] = x[:64].reshape(-1)
    for g, w in zip(kern(buf[4:].view(64, k), nnz), full):
        assert _bits_equal(g, w[:64]), f"{form}: the misaligned input differs"
    name = {"dense": "dap_prune", "pack": "dap_pack", "dense_int8": "dap_prune_int8",
            "pack_int8": "dap_pack_int8"}[form]
    assert ops.counters()[name].launches == before[name] + 8


@pytest.mark.parametrize("form", ["dense_int8", "pack_int8"])
@pytest.mark.parametrize("k", DAP_SERVED_KS)
@pytest.mark.parametrize("m", [100, 64, 32, 16])
def test_dap_row_forms_any_cluster(cuda, form, k, m):
    """The per-row forms at every cluster size the plan takes (at K >=
    2560: 1, 2, 4 and 8 blocks a row at M = 100, 64, 32 and 16; a cluster
    exchanges partial maxima through distributed shared memory): the same
    bits as the plain version, and a row's bits the same as at M = 4."""
    kern, plain = DAP_FORMS[form]
    cluster = dap_prune.row_plan(m, k)[0]
    for dtype in (torch.bfloat16, torch.float32):
        x = _dap_rows(cuda, m, k, dtype)
        got = kern(x, 4)
        for g, w, g4 in zip(got, plain(x, 4), kern(x[:4], 4)):
            assert _bits_equal(g, w), f"{form} K={k} cluster {cluster} M={m} {dtype}"
            assert _bits_equal(g[:4], g4), f"{form} K={k} cluster {cluster} M={m}: rows vary"


def test_dap_pack_int8_per_tensor_on_cuda(cuda):
    """Off the served paths: ``act_scale="per_tensor"`` on CUDA is #5's
    packed form, then the plain per-tensor quantization."""
    x = _dap_rows(cuda, 64, 4096, torch.bfloat16)[4:]
    before = (dap_prune.DAP_PACK.launches, dap_prune.DAP_PACK_INT8.launches)
    got = ops.dap_pack_int8(x, 4, 8)
    want = ref.dap_pack_int8_ref(x, 4, 8, per_row=False)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    assert (dap_prune.DAP_PACK.launches, dap_prune.DAP_PACK_INT8.launches) == (
        before[0] + 1, before[1])


@pytest.mark.parametrize("arch,wire", [("granite_3_8b", "int8"), ("minicpm3_4b", "native"),
                                       ("granite_moe_1b_a400m", "native")])
def test_engine_dap_forms_on_the_kernel(cuda, monkeypatch, arch, wire):
    """A bf16 smoke engine on each served path: every DAP call site runs
    #5 (no plain DAP counter moves), in the wire's forms, and its tokens
    equal those of the route before the packed forms existed (the packs
    in plain ops on the card, wo's DAP as #5's dense form then the plain
    per-row quantization).  An MoE step couples its tokens through expert
    capacity, so the comparison holds the same requests and arrivals."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), n_layers=2, dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
    scfg = ServeConfig(prefill_mode="continuous", pack_weights=True, max_seq=64, page_size=16,
                       max_batch=2, prefill_chunk=8, wire_dtype=wire, kv_dtype=wire)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 5, 20)]
    ops.reset_counters()
    got = Engine(params, cfg, scfg, device="cuda").generate_requests(prompts, 6,
                                                                     arrivals=[0, 3, 1])
    counts = {name: (c.launches, c.plain) for name, c in ops.counters().items()
              if name.startswith("dap")}
    assert all(plain == 0 for _, plain in counts.values()), counts
    used = {"int8": {"dap_pack_int8", "dap_prune_int8"},
            "native": {"dap_pack", "dap_prune"}}[wire]
    assert {name for name, (n, _) in counts.items() if n > 0} == used, counts
    monkeypatch.setattr(dap_prune, "dap_pack_cuda", ref.dap_pack_ref)
    monkeypatch.setattr(dap_prune, "dap_pack_int8_cuda", ref.dap_pack_int8_ref)
    monkeypatch.setattr(dap_prune, "dap_prune_int8_cuda", lambda x, nnz, bz=8: (
        ref.quantize_act_int8(dap_prune.dap_prune_cuda(x, nnz, bz)[0], per_row=True)))
    want = Engine(params, cfg, scfg, device="cuda").generate_requests(prompts, 6,
                                                                      arrivals=[0, 3, 1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", ["dense_int8", "pack_int8"])
@pytest.mark.parametrize("k", [29568, 49152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dap_row_forms_long_rows_any_m(cuda, form, k, dtype):
    """The per-row forms at qwen2-vl-72b's and qwen1.5-110b's down inputs
    at every M a step or a solo prefill gives, 1 to 512: K = 49152 takes
    the least cluster that holds a row (2 blocks, whatever M), and every
    M is bit for bit the plain version, a row's bits those of M = 4."""
    kern, plain = DAP_FORMS[form]
    x = _dap_rows(cuda, 512, k, dtype)
    four = kern(x[:4], 4)
    for m in (1, 4, 64, 67, 100, 512):
        cluster = dap_prune.row_plan(m, k)[0]
        if k == 49152:
            assert cluster >= 2
        got = kern(x[:m], 4)
        for g, w, g4 in zip(got, plain(x[:m], 4), four):
            assert _bits_equal(g, w), f"{form} K={k} M={m} cluster {cluster} {dtype}"
            assert _bits_equal(g[:min(m, 4)], g4[:min(m, 4)]), f"{form} K={k} M={m}: rows vary"


# ------------------- qwen2-vl, qwen1.5, starcoder2 and phi3.5-moe at full width


NEW_ARCHS = ("qwen2-vl-72b", "qwen1.5-110b", "starcoder2-15b", "phi3.5-moe-42b-a6.6b")
FULL_WIDTH_ROWS = (1, 4, 64, 100)


def _served_bias(gen, arch, name, n):
    if arch in _smoke_module().QKV_BIAS_ARCHS and name in ("wq", "wk", "wv"):
        return torch.randn((n,), generator=gen, device="cuda").to(torch.bfloat16)
    return None


@pytest.mark.parametrize("arch,name,kind,act,k,n", [
    row[:-1] for row in _smoke_module().INT8_OTHER_LINEARS if row[0] in NEW_ARCHS],
    ids=lambda v: str(v))
def test_int8_tc_full_width_served_epilogue(cuda, arch, name, kind, act, k, n):
    """qwen2-vl-72b's and qwen1.5-110b's int8-wire shapes at M = 1, 4, 64
    and 100 with the epilogue their main path runs: a random bias on wq,
    wk, wv, silu on gate.  Every call on the int8 tc body; ``act=None``
    f32 outputs (bias added) bit for bit and a row's bits the same at
    every M; the served activation in f32 within 1e-6 (+ 1e-6 relative)
    and in bf16 within one bf16 ulp more."""
    cfg, xop, wop = _int8_operands(cuda, max(FULL_WIDTH_ROWS), k, n, kind)
    bias = _served_bias(cuda, arch, name, n)
    total, tc = _int8_counters(kind)
    before = tc.launches
    ys = {}
    for m in FULL_WIDTH_ROWS:
        y, want, _, _ = _int8_run(kind, cfg, xop, wop, m, bias=bias)
        assert torch.equal(y, want), m
        ys[m] = y
        if act is not None:
            for out_dtype in (torch.float32, torch.bfloat16):
                y, want, _, _ = _int8_run(kind, cfg, xop, wop, m, bias=bias, act=act,
                                          out_dtype=out_dtype)
                y, want = y.float(), want.float()
                tol = 1e-6 + 1e-6 * want.abs()
                if out_dtype == torch.bfloat16:
                    tol = tol + 2.0 ** -7 * torch.maximum(y.abs(), want.abs())
                assert bool(((y - want).abs() <= tol).all()), (m, out_dtype)
    per_m = 3 if act is not None else 1
    assert tc.launches == before + per_m * len(FULL_WIDTH_ROWS)
    for a, b in zip(FULL_WIDTH_ROWS, FULL_WIDTH_ROWS[1:]):
        assert torch.equal(ys[a], ys[b][:a]), (a, b)


@pytest.mark.parametrize("arch,name,kind,act,dap,k,n", [
    row[:-1] for row in _smoke_module().NATIVE_LINEARS if row[0] in NEW_ARCHS],
    ids=lambda v: str(v))
def test_native_matmul_tc_full_width_served_epilogue(cuda, arch, name, kind, act, dap, k, n):
    """starcoder2-15b's, phi3.5-moe's and qwen2-vl-72b's native-wire
    shapes at M = 1, 4, 64 and 100 with the epilogue their main path runs
    (a random bias on starcoder2's and qwen2-vl's wq, wk, wv; gelu on
    starcoder2's up, silu on gate): every call on the tc body, f32 within
    1e-5 of the largest output, bf16 within that plus one bf16 ulp, a
    row's bits the same at every M."""
    cfg = dbb.DBBConfig(4, 8)
    bf16 = torch.bfloat16
    w = (torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)).to(bf16)
    wv, wm = ops.pack_weight(w, cfg)
    x = torch.randn((max(FULL_WIDTH_ROWS), k), generator=cuda, device="cuda").to(bf16)
    if dap:
        x = apply_dap(x, DAPSpec(4, 8))
    xv, xm = ops.dap_pack(x, 4, 8)
    bias = _served_bias(cuda, arch, name, n)
    tc = dbb_matmul.AW_NATIVE_TC if kind == "aw" else dbb_matmul.NATIVE_TC

    def run(fn, m, out_dtype):
        if kind == "aw":
            return fn(xv[:m], xm[:m], wv, wm, cfg, cfg, bias=bias, act=act, out_dtype=out_dtype)
        return fn(x[:m], wv, wm, cfg, bias=bias, act=act, out_dtype=out_dtype)

    kern = dbb_matmul.dbb_matmul_aw_cuda if kind == "aw" else dbb_matmul.dbb_matmul_cuda
    plain = ref.dbb_matmul_aw_ref if kind == "aw" else ref.dbb_matmul_ref
    before = tc.launches
    y = {m: run(kern, m, torch.float32) for m in FULL_WIDTH_ROWS}
    assert tc.launches == before + len(FULL_WIDTH_ROWS)
    for a, b in zip(FULL_WIDTH_ROWS, FULL_WIDTH_ROWS[1:]):
        assert torch.equal(y[a], y[b][:a]), (a, b)
    for m in FULL_WIDTH_ROWS:
        want = run(plain, m, torch.float32)
        tol32 = 1e-5 * want.abs().max().item()
        assert (y[m] - want).abs().max().item() <= tol32, m
        yb = run(kern, m, bf16).float()
        yb_ref = run(plain, m, bf16).float()
        ulp = 2.0 ** -7 * torch.maximum(yb.abs(), yb_ref.abs())
        assert bool(((yb - yb_ref).abs() <= ulp + tol32).all()), m


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("g,kv", [(12, 4), (8, 8)], ids=["starcoder2", "qwen2_vl"])
@pytest.mark.parametrize("s", [1, 16, 20])
def test_paged_attn_tc_window_over_long_tables(cuda, int8, g, kv, s):
    """#6's tensor-core kernel with starcoder2-15b's 4096-token window over
    tables of 5120 slots (its 12 query heads a KV head, and qwen2-vl's 8):
    requests of 5000 and 4517 cached tokens lose their oldest keys to the
    window; decode, chunk and mixed rows with a padding tail and an idle
    row over the null page, within 1.6e-2 of the plain version (f32:
    1e-5, through the scalar kernel)."""
    d, ps, b, p_cnt, window = 128, 16, 4, 320, 4096
    lengths = (5000, 4517, 64, 250)
    n_pages = b * p_cnt + 1
    k_f = torch.randn((n_pages, ps, kv * d), generator=cuda, device="cuda")
    v_f = torch.randn((n_pages, ps, kv * d), generator=cuda, device="cuda")
    kw = dict(kv_heads=kv, window=window)
    if int8:
        (k, k_s), (v, v_s) = quant.quantize_rows(k_f), quant.quantize_rows(v_f)
        kw.update(k_scale=k_s, v_scale=v_s)
        k32, v32 = k, v
    else:
        k, v = k_f.to(torch.bfloat16), v_f.to(torch.bfloat16)
        k32, v32 = k.float(), v.float()
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    tables = torch.zeros((b, p_cnt), dtype=torch.int32, device="cuda")
    nxt = 1
    for i, t in enumerate(lengths):
        used = -(-t // ps)
        tables[i, :used] = torch.arange(nxt, nxt + used, device="cuda")
        slots = torch.arange(used * ps, device="cuda")
        pos[nxt:nxt + used] = torch.where(slots < t, slots, -1).reshape(used, ps).int()
        nxt += used
    q_pos = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    for i, t in enumerate(lengths):
        n = (1, s, max(1, s - 3), s)[i]
        q_pos[i, :n] = torch.arange(t - n, t, dtype=torch.int32, device="cuda")
    q_pos[2], tables[2] = -1, 0  # an idle row over the null page
    q = torch.randn((b, s, kv * g, d), generator=cuda, device="cuda").to(torch.bfloat16)
    before = paged_attn.PAGED_ATTN_TC.launches
    got = paged_attn.paged_attn_cuda(q, k, v, pos, tables, q_pos, **kw)
    assert paged_attn.PAGED_ATTN_TC.launches == before + 1
    want = ref.paged_attn_ref(q, k, v, pos, tables, q_pos, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2, err
    full = ref.paged_attn_ref(q, k, v, pos, tables, q_pos, **{**kw, "window": None})
    assert (full.float() - want.float()).abs().max().item() > 1e-2  # the window bites
    got32 = paged_attn.paged_attn_cuda(q.float(), k32, v32, pos, tables, q_pos, **kw)
    want32 = ref.paged_attn_ref(q.float(), k32, v32, pos, tables, q_pos, **kw)
    assert (got32 - want32).abs().max().item() <= 1e-5 + 1e-5 * want32.abs().max().item()


def _with_biases(params, seed):
    """``params`` with every ``"b"`` drawn non-zero (the init draws zeros)."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(params, dict):
        return {k: (torch.randn(v.shape, generator=gen).to(v.dtype) if k == "b"
                    else _with_biases(v, seed + 1 + i)) for i, (k, v) in enumerate(params.items())}
    if isinstance(params, list):
        return [_with_biases(v, seed + 100 * (i + 1)) for i, v in enumerate(params)]
    return params


@pytest.mark.parametrize("arch,wire", [("qwen2_vl_72b", "int8"), ("qwen2_vl_72b", "native"),
                                       ("starcoder2_15b", "native")])
def test_engine_serves_new_archs_bf16(cuda, monkeypatch, arch, wire):
    """bf16 smoke engines of qwen2-vl-72b (M-RoPE, QKV bias) and
    starcoder2-15b (gelu, QKV bias, its 32-token window biting in prompts
    of 70 and 80 tokens) served on CUDA and on the CPU with the same
    weights, random non-zero biases.  A split takes a whole table, as in
    the engine tests above.  Without DAP (``wdbb``) the tokens equal the
    CPU engine's.  With DAP (the configs' ``awdbb``) one bf16 ulp can
    become another token (see ``test_engine_serves_large_pages_bf16``), so
    that engine is held to itself: every request served, every kernel
    launched on its tc body, no plain version, the longest request
    re-served alone byte-identical."""
    monkeypatch.setattr(paged_attn, "PAGES_PER_SPLIT", 32)
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    scfg = ServeConfig(prefill_mode="continuous", pack_weights=True, max_seq=160, page_size=16,
                       max_batch=2, prefill_chunk=16, wire_dtype=wire, kv_dtype=wire,
                       paged_attn="fused")
    rng = np.random.default_rng(20)
    for mode in ("wdbb", "awdbb"):
        cfg = configs.get_config(arch, smoke=True)
        cfg = dataclasses.replace(cfg, n_layers=2, dtype="bfloat16",
                                  sparsity=dataclasses.replace(cfg.sparsity, mode=mode))
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
        params = _with_biases(params, 7)
        prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (70, 5, 80)]
        outs = {}
        for device in ("cpu", "cuda"):
            ops.reset_counters()
            dbb_matmul.AW_NATIVE_TC.launches = dbb_matmul.AW_INT8_TC.launches = 0
            dbb_matmul.NATIVE_TC.launches = dbb_matmul.INT8_TC.launches = 0
            paged_attn.PAGED_ATTN_TC.launches = 0
            eng = Engine(params, cfg, scfg, device=device)
            outs[device] = eng.generate_requests(prompts, 6, arrivals=[0, 3, 1])
            assert all(r.finish_reason == "length" for r in eng.last_results)
        counts = ops.counters()
        assert all(c.plain == 0 for c in counts.values()), counts
        # wdbb packs no activation: every linear takes #2 or #1
        mm, mm_tc = {("int8", "awdbb"): ("dbb_matmul_aw_int8", dbb_matmul.AW_INT8_TC),
                     ("native", "awdbb"): ("dbb_matmul_aw", dbb_matmul.AW_NATIVE_TC),
                     ("int8", "wdbb"): ("dbb_matmul_int8", dbb_matmul.INT8_TC),
                     ("native", "wdbb"): ("dbb_matmul", dbb_matmul.NATIVE_TC)}[wire, mode]
        assert counts[mm].launches > 0 and mm_tc.launches == counts[mm].launches
        assert paged_attn.PAGED_ATTN_TC.launches == counts["paged_attn"].launches > 0
        if mode == "wdbb":
            for got, want in zip(outs["cuda"], outs["cpu"]):
                np.testing.assert_array_equal(got, want)
        else:
            again = eng.generate_requests([prompts[2]], 6)[0]
            np.testing.assert_array_equal(again, outs["cuda"][2])


# ------------------------------------------------- the bf16 gate's card twin

# the smoke configs at 2 layers in bf16, widened where a call would miss
# its tc body (int8: K % 128, N % 16): qwen1.5's down (K = d_ff) and
# minicpm3's q_up (K = q_lora), kv_down (N = kv_lora + rope) and wo (K =
# H * v_head), and the SSD mixers' in_proj (N = 2 d_inner + 2 d_state +
# heads: 552 at heads of 32, 560 at heads of 16); starcoder2's and
# hymba's windows bite in the gate's prompts
GATE_TWIN_OVERRIDES = {"qwen1_5_110b": dict(d_ff=384), "starcoder2_15b": dict(sliding_window=6),
                       "hymba_1_5b": dict(sliding_window=8)}
GATE_TWIN_MLA = dict(q_lora_rank=128, kv_lora_rank=24, v_head_dim=32)
GATE_TWIN_SSM = dict(headdim=16)
GATE_DROPPING = 0.3  # granite-moe's capacity factor at which these steps drop pairs
# the card's logits against the CPU port's: sound runs are bit for bit in 14
# of the 20 paged cases and within 0.0606 in the rest; this is twice that,
# 8 bf16 ulps at the logits' 2-4, where the fault the CPU gate found (the
# silu's rounding) moved them by 1.69-2.14
GATE_TWIN_TOL = 0.125
# whisper's cases are held site by site instead (``_torch_bf16_gate.SiteReplay``):
# DAP turns its card's few one-rounding sites into 0.21 and 0.52 on the
# native and unpacked cases' logits end to end.  At equal inputs the sound
# runs (an H100, scripts/encdec_card_sites.py) have at most 2 of their
# 964-1344 hooked calls apart, by at most half a bf16 ulp of the call's
# largest output (the float64-summed ``mha`` of a decode step, a native
# matmul's split sum, a layer norm's float64 mean, an int8 gelu epilogue);
# the limits are twice that.  A rounding fault repeats at every call of its
# site: ``F.gelu`` in place of ``epilogue.gelu`` puts 30 calls of the
# unpacked case apart (one ulp each)
GATE_TWIN_SITE_ULPS = 1.0
GATE_TWIN_SITES_APART = 4


def _gate_twin_cfg(arch, capacity_factor=None):
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch, smoke=True)
    kw = dict(GATE_TWIN_OVERRIDES.get(arch, {}))
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, **GATE_TWIN_MLA)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, **GATE_TWIN_SSM)
    if capacity_factor is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    return dataclasses.replace(cfg, n_layers=2, dtype="bfloat16", **kw)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _gate_twin_served(params, cfg, wire, kv_dtype):
    """``(params, cfg)`` as an engine serves them: packed on ``wire``
    (dense for ``"unpacked"``), the KV dtype, per-row activation scales
    on the int8 wire, and the fused paged read on both devices (by name:
    the CPU's ``"auto"`` gathers)."""
    import dataclasses

    from repro_torch.serve.engine import pack_params_for_serving

    sp = dataclasses.replace(cfg.sparsity, kv_dtype=kv_dtype, paged_attn="fused")
    if wire == "int8":
        sp = dataclasses.replace(sp, act_scale="per_row")
    cfg = dataclasses.replace(cfg, sparsity=sp)
    return (params if wire == "unpacked" else pack_params_for_serving(params, cfg, wire)), cfg


def _gate_twin_cases():
    import _torch_bf16_gate as gate

    return ([c + (None,) for c in gate.CASES + gate.FAMILY_CASES]
            + [("granite_moe_1b_a400m", w, w, GATE_DROPPING) for w in ("native", "int8")])


@pytest.mark.parametrize("arch,wire,kv_dtype,capacity_factor", _gate_twin_cases())
def test_bf16_gate_card_twin(cuda, monkeypatch, arch, wire, kv_dtype, capacity_factor):
    """The bf16 gates' serving cases (``tests/test_torch_bf16_gate.py``,
    ``tests/test_torch_bf16_gate_families.py``) on the card, under
    ``awdbb`` with random non-zero biases (and, in the families' cases,
    the mixers' ``A_log``, ``D``, ``dt_bias``, conv biases and the layer
    norms' biases and scales): the CUDA port's logits within the gate's
    bound of the CPU port's on the same weights, the bound taken from the
    CPU port's own bf16 and f32 runs,

        bound = max(max|cpu_bf16 - cpu_f32|, 2e-2 * max|cpu_f32|),

    and within ``GATE_TWIN_TOL`` of them, twice the largest error of the
    sound runs (the bound is about a logit, and would pass a wrong
    kernel); greedy tokens equal wherever the CPU's top two logits are more than
    ``2 * bound`` apart, every run fed the CPU's bf16 greedy tokens.  Every
    kernel launches on its tensor-core body and no plain version runs;
    each kernel the case's path takes launches.  whisper's cases are held
    site by site in place of ``GATE_TWIN_TOL``: the card run again with
    every linear, DAP call, kernel, layer norm and ``mha`` fed the CPU's
    inputs (``_torch_bf16_gate.SiteReplay``): at most
    ``GATE_TWIN_SITES_APART`` calls apart from the CPU's, each within
    ``GATE_TWIN_SITE_ULPS`` ulps of its largest output (integers equal),
    and the logits equal.
    granite-moe also runs at a capacity factor of 0.3 with an idle row in
    the batch: #6's tensor-core kernel sums the keyless rows in another
    order, and under MoE those rows take capacity and decide which pairs
    drop (the dispatch drops pairs on the card)."""
    import dataclasses

    import numpy as np

    import _torch_bf16_gate as gate
    from repro_torch.models import encdec, lm
    from repro_torch.models import moe as moe_mod

    cfg = _gate_twin_cfg(arch, capacity_factor)
    kind = gate.kind_of(cfg.family, wire)
    idle = 1 if capacity_factor is not None else 0
    init = encdec.init_params if cfg.family == "encdec" else lm.init_params
    params = _with_biases(init(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None), 7)
    if (arch, wire, kv_dtype) in gate.FAMILY_CASES:
        params = gate.nonzero_extras(params, 8)
    served, scfg = _gate_twin_served(params, cfg, wire, kv_dtype)
    want, fed = gate.port_run(served, scfg, "cpu", idle=idle)
    served32, scfg32 = _gate_twin_served(gate.f32_tree(params),
                                         dataclasses.replace(cfg, dtype="float32"), wire,
                                         kv_dtype)
    want32, _ = gate.port_run(served32, scfg32, "cpu", fed, idle)

    ops.reset_counters()
    dbb_matmul.AW_NATIVE_TC.launches = dbb_matmul.AW_INT8_TC.launches = 0
    dbb_matmul.NATIVE_TC.launches = dbb_matmul.INT8_TC.launches = 0
    paged_attn.PAGED_ATTN_TC.launches = paged_attn.PAGED_ATTN_LATENT_TC.launches = 0
    drops = {"n": 0}
    inner = moe_mod._dispatch

    def spy(*a, **kw):
        out = inner(*a, **kw)
        drops["n"] += int((~out[2]).sum())
        return out

    monkeypatch.setattr(moe_mod, "_dispatch", spy)
    got, _ = gate.port_run(_tree_map(lambda t: t.to("cuda"), served), scfg, "cuda", fed, idle)
    counts = ops.counters()
    assert all(c.plain == 0 for c in counts.values()), counts
    tc = {"dbb_matmul": dbb_matmul.NATIVE_TC, "dbb_matmul_aw": dbb_matmul.AW_NATIVE_TC,
          "dbb_matmul_int8": dbb_matmul.INT8_TC, "dbb_matmul_aw_int8": dbb_matmul.AW_INT8_TC,
          "paged_attn": paged_attn.PAGED_ATTN_TC,
          "paged_attn_latent": paged_attn.PAGED_ATTN_LATENT_TC}
    for name, counter in tc.items():
        assert counter.launches == counts[name].launches, name
    aw, w = (("dbb_matmul_aw_int8", "dbb_matmul_int8") if wire == "int8"
             else ("dbb_matmul_aw", "dbb_matmul"))
    attn = "paged_attn_latent" if cfg.mla is not None else "paged_attn"
    need = {"dap_prune_int8" if wire == "int8" else "dap_prune"}
    need |= {attn} if kind == "paged" else set()
    if wire != "unpacked":
        need |= {w} | ({aw} if cfg.family != "ssm" else set())
    assert all(counts[name].launches > 0 for name in need), counts
    if capacity_factor is not None:
        assert drops["n"] > 0

    assert np.isfinite(got).all() and got.shape == want.shape == want32.shape
    err, bound, ref_gap, sure = gate.gate_report(got, want, want32)
    line = (f"{arch} {wire} wire {kv_dtype} KV ({kind})"
            f"{'' if idle == 0 else ', capacity 0.3, idle row'}"
            f": |cuda - cpu_bf16| {err:.4g}, bound {bound:.4g} (|cpu_bf16 - cpu_f32| "
            f"{ref_gap:.4g}), limit {GATE_TWIN_TOL}; tokens compared at {int(sure.sum())} of "
            f"{len(sure)} positions")
    print(line)
    assert err <= bound, line
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure], err_msg=line)
    if kind != "encdec":
        assert err <= GATE_TWIN_TOL, line
        return
    sites = gate.SiteReplay("cuda")
    sites.install(monkeypatch.setattr)
    gate.port_run(served, scfg, "cpu", fed)
    sites.replay()
    handed, _ = gate.port_run(_tree_map(lambda t: t.to("cuda"), served), scfg, "cuda", fed)
    worst = max((d[3] for d in sites.diffs), default=0.0)
    print(f"  site by site: {len(sites.diffs)} of {len(sites.rec)} calls apart, at most "
          f"{worst:.3g} ulps; {sites.diffs[:4]}")
    assert worst <= GATE_TWIN_SITE_ULPS, sites.diffs[:8]
    assert len(sites.diffs) <= GATE_TWIN_SITES_APART, sites.diffs[:8]
    np.testing.assert_array_equal(handed, want)


# ------------------------------------------------ sampler and serving modes


@pytest.mark.parametrize("vocab", [152064, 49155])
def test_threefry_bits_on_cuda_equal_cpu(cuda, vocab):
    """Keys and random bits are integer work in int64: the card's equal
    the CPU's bit for bit, and so do the uniform draws built on them."""
    from repro_torch.core import prng

    for seed in (0, 1, 2**31 - 1, 2**32 - 1):
        for pos in (0, 1, 1023, 40000):
            keys = {dev: prng.fold_in(prng.prng_key(torch.tensor([seed], device=dev)),
                                      torch.tensor([pos], device=dev))
                    for dev in ("cpu", "cuda")}
            assert torch.equal(prng.random_bits(keys["cuda"], vocab).cpu(),
                               prng.random_bits(keys["cpu"], vocab))
            assert torch.equal(prng.uniform(keys["cuda"], vocab).cpu(),
                               prng.uniform(keys["cpu"], vocab))


@pytest.mark.parametrize("vocab", [152064, 49155])
def test_sampled_tokens_on_cuda_equal_cpu(cuda, vocab):
    """``sample_tokens`` at B = 4 gives the CPU's tokens on the same
    logits: temperature alone, top-k, top-p and a greedy row."""
    from repro_torch.core.sampling import sample_tokens

    gen = torch.Generator().manual_seed(vocab)
    for trial in range(4):
        logits = torch.randn((4, vocab), generator=gen) * 4
        rows = (torch.tensor([0.7, 0.0, 1.1, 0.9]), torch.tensor([0, 0, 50, 0]),
                torch.tensor([1.0, 1.0, 0.95, 0.8]),
                torch.tensor([11, 3, 2**32 - 1, 2**31 + 7]),
                torch.tensor([5, 63, 1023, 40000]) + trial)
        want = sample_tokens(logits, *rows)
        got = sample_tokens(logits.cuda(), *(r.cuda() for r in rows))
        assert torch.equal(got.cpu(), want)


def _small_engine_params(arch, mode="wdbb"):
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), n_layers=2,
                              dtype="bfloat16", sparsity=SparsityConfig(mode=mode))
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)


@pytest.mark.parametrize("wire", ["native", "int8"])
@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_batched_prefill_batch_invariant_on_cuda(cuda, arch, wire):
    """One-shot batched prefill over the ring on the card: a prompt's
    tokens (greedy and sampled) do not depend on the prompts batched with
    it — every kernel sums a row in its own order, and the ring path's
    einsums and softmax sums run in float64 (``models/attention.py``)."""
    import numpy as np

    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, params = _small_engine_params(arch, "awdbb")
    rng = np.random.default_rng(7)
    a = rng.integers(0, cfg.vocab, (1, 24)).astype(np.int32)
    oth = rng.integers(0, cfg.vocab, (3, 24)).astype(np.int32)
    for samp in ({}, dict(temperature=0.8, top_k=50, top_p=0.95, seed=5)):
        scfg = ServeConfig(max_seq=64, prefill_mode="batched", pack_weights=True,
                           wire_dtype=wire, kv_dtype=wire, **samp)
        solo = Engine(params, cfg, scfg, device="cuda").generate(a, 8)[0]
        co = Engine(params, cfg, scfg, device="cuda").generate(np.concatenate([a, oth]), 8)[0]
        np.testing.assert_array_equal(solo, co)


@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_gather_equals_fused_on_cuda(cuda, arch):
    """``paged_attn="gather"`` serves the fused kernel's tokens on the card
    under ``mode="wdbb"`` on the native wire (no DAP and no activation
    quantization to amplify a bf16 ulp of #6 into another token), int8
    KV (both paths read the same stored codes)."""
    import numpy as np

    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, params = _small_engine_params(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 5, 20)]
    outs = {}
    for attn in ("fused", "gather"):
        scfg = ServeConfig(prefill_mode="continuous", pack_weights=True, max_seq=64,
                           page_size=16, max_batch=2, prefill_chunk=8, wire_dtype="native",
                           kv_dtype="int8", paged_attn=attn)
        ops.reset_counters()
        outs[attn] = Engine(params, cfg, scfg, device="cuda").generate_requests(
            prompts, 8, arrivals=[0, 3, 1])
        n_attn = sum(ops.counters()[k].launches for k in ("paged_attn", "paged_attn_latent"))
        assert (n_attn > 0) == (attn == "fused")
    for g, f in zip(outs["gather"], outs["fused"]):
        np.testing.assert_array_equal(g, f)


# ---------------------------------------------- speculative decoding's shapes


@pytest.mark.parametrize("int8", [True, False], ids=["int8_kv", "native_kv"])
@pytest.mark.parametrize("mode", ["gqa", "latent"])
def test_paged_attn_rows_bitwise_independent_of_window(cuda, int8, mode):
    """Speculative decoding's verify pass runs #6 over a ``decode_block``
    = 16 window where plain decode runs one query: a query at each index
    of an S = 16 window gives the same bits as that query alone at S = 1
    (same cache, pages of 16, splits over a table wider than one), GQA at
    granite-3-8b's head shape and MLA's latent mode at minicpm3-4b's."""
    p_cnt = 2 * paged_attn.PAGES_PER_SPLIT + 3
    if mode == "gqa":
        q, k, v, pos, tables, q_pos, kw = _tc_case(cuda, 4, 16, 4, 128, 8, int8, p_cnt)
        tc = paged_attn.PAGED_ATTN_TC
    else:
        q, k, pos, tables, q_pos, kw = _latent_case(cuda, 16, int8, p_cnt, 16)
        v, tc = None, paged_attn.PAGED_ATTN_LATENT_TC
    before = tc.launches
    full = paged_attn.paged_attn_cuda(q, k, v, pos, tables, q_pos, **kw)
    for j in range(16):
        one = paged_attn.paged_attn_cuda(q[:, j:j + 1].contiguous(), k, v, pos, tables,
                                         q_pos[:, j:j + 1].contiguous(), **kw)
        assert torch.equal(one[:, 0], full[:, j]), j
    assert tc.launches == before + 17


SPEC_INT8_LINEARS = (("granite-3-8b", "wq", 4096, 4096), ("granite-3-8b", "gate", 4096, 12800),
                     ("granite-3-8b", "down", 12800, 4096))
SPEC_NATIVE_LINEARS = (("minicpm3-4b", "q_down", 2560, 768),
                       ("minicpm3-4b", "kv_down", 2560, 288),
                       ("minicpm3-4b", "gate", 2560, 6400), ("minicpm3-4b", "down", 6400, 2560))
DRAFT_ROWS = (1, 4, 16)  # a draft pass reads max_batch rows (4 on the card's paths)


@pytest.mark.parametrize("arch,name,k,n", SPEC_INT8_LINEARS, ids=lambda v: str(v))
def test_int8_tc_draft_nnz2_against_nnz4(cuda, arch, name, k, n):
    """The ``nnz`` draft on the int8 wire: #3 with activations DAP-packed
    at NNZ 2 against weights packed at NNZ 4, at granite-3-8b's full-width
    shapes: on the tc body, int32 accumulators and the f32 output bit for
    bit against the plain version."""
    cfg_a, cfg_w = dbb.DBBConfig(2, 8), dbb.DBBConfig(4, 8)
    w = (torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
    wv, wm, ws = ref.pack_weight_int8(w, cfg_w)
    w_dense = ref.decode_w(wv, wm, cfg_w)
    x = torch.randn((max(DRAFT_ROWS), k), generator=cuda, device="cuda").to(torch.bfloat16)
    xv, xm, xs = ops.dap_pack_int8(x, 2, 8, act_scale="per_row")
    assert xv.shape[-1] == 2
    before = (dbb_matmul.AW_INT8.launches, dbb_matmul.AW_INT8_TC.launches)
    for m in DRAFT_ROWS:
        acc = torch.empty((m, n), dtype=torch.int32, device="cuda")
        y = dbb_matmul.dbb_matmul_aw_int8_cuda(xv[:m], xm[:m], xs[:m], wv, wm, ws, cfg_a, cfg_w,
                                               acc_out=acc)
        want = ref.dbb_matmul_aw_int8_ref(xv[:m], xm[:m], xs[:m], wv, wm, ws, cfg_a, cfg_w)
        assert torch.equal(acc, ref.int8_acc(ref.decode_a(xv[:m], xm[:m], cfg_a), w_dense)), m
        assert torch.equal(y, want), m
    n_calls = len(DRAFT_ROWS)
    assert (dbb_matmul.AW_INT8.launches, dbb_matmul.AW_INT8_TC.launches) == (
        before[0] + n_calls, before[1] + n_calls)


@pytest.mark.parametrize("arch,name,k,n", SPEC_NATIVE_LINEARS, ids=lambda v: str(v))
def test_native_tc_draft_nnz2_against_nnz4(cuda, arch, name, k, n):
    """The ``nnz`` draft on the native wire: #4 with bf16 activations
    DAP-packed at NNZ 2 against weights at NNZ 4, at minicpm3-4b's
    full-width shapes: on the tc body, the bf16 output within 0.0156 of
    the plain version and the f32 output within 1e-5 of its largest."""
    cfg_a, cfg_w = dbb.DBBConfig(2, 8), dbb.DBBConfig(4, 8)
    w = (torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
    wv, wm = ops.pack_weight(w, cfg_w)
    x = torch.randn((max(DRAFT_ROWS), k), generator=cuda, device="cuda").to(torch.bfloat16)
    xv, xm = ops.dap_pack(x, 2, 8)
    before = (dbb_matmul.AW_NATIVE.launches, dbb_matmul.AW_NATIVE_TC.launches)
    for m in DRAFT_ROWS:
        for out_dtype in (torch.bfloat16, torch.float32):
            got = dbb_matmul.dbb_matmul_aw_cuda(xv[:m], xm[:m], wv, wm, cfg_a, cfg_w,
                                                out_dtype=out_dtype).float()
            want = ref.dbb_matmul_aw_ref(xv[:m], xm[:m], wv, wm, cfg_a, cfg_w,
                                         out_dtype=out_dtype).float()
            err = (got - want).abs().max().item()
            tol = 0.0156 if out_dtype == torch.bfloat16 else 1e-5 * want.abs().max().item() + 1e-6
            assert err <= tol, (m, out_dtype, err)
    n_calls = 2 * len(DRAFT_ROWS)
    assert (dbb_matmul.AW_NATIVE.launches, dbb_matmul.AW_NATIVE_TC.launches) == (
        before[0] + n_calls, before[1] + n_calls)


@pytest.mark.parametrize("arch,wire,draft", [("granite_3_8b", "int8", "nnz"),
                                             ("granite_3_8b", "int8", "int8_wire"),
                                             ("minicpm3_4b", "native", "int8_wire")])
def test_spec_engine_equals_plain_on_cuda(cuda, arch, wire, draft):
    """A spec engine serves the plain engine's tokens on the card under
    ``awdbb`` (bf16 smoke configs, 2 layers): the verify pass's 16-wide
    window reproduces one-token decode bit for bit.  The minicpm3-4b
    engine drafts on the int8 wire (#2/#3) while it verifies on the native
    one (#1/#4)."""
    import numpy as np

    from repro_torch.serve.engine import Engine, ServeConfig, SpecConfig

    cfg, params = _small_engine_params(arch, "awdbb")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 5, 20, 33)]
    kw = dict(prefill_mode="continuous", pack_weights=True, max_seq=96, page_size=16,
              max_batch=4, prefill_chunk=16, wire_dtype=wire, kv_dtype=wire)
    plain = Engine(params, cfg, ServeConfig(**kw), device="cuda").generate_requests(
        prompts, 24, arrivals=[0, 1, 2, 3])
    ops.reset_counters()
    eng = Engine(params, cfg, ServeConfig(spec=SpecConfig(draft=draft), **kw), device="cuda")
    out = eng.generate_requests(prompts, 24, arrivals=[0, 1, 2, 3])
    for i, (a, b) in enumerate(zip(out, plain)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert eng.spec_stats()["spec_runs"] > 0 and eng.spec_stats()["proposed"] > 0
    counts = ops.counters()
    assert all(c.plain == 0 for c in counts.values())
    if draft == "int8_wire" and wire == "native":
        assert counts["dbb_matmul_aw_int8"].launches > 0 and counts["dbb_matmul_aw"].launches > 0


@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_fused_fault_falls_back_to_gather_on_cuda(cuda, arch):
    """The injected fused-kernel fault on the card: the engine switches to
    gather one way and serves the fault-free fused engine's tokens (under
    ``wdbb``, where gather equals fused on the card)."""
    import numpy as np

    from repro_torch.serve import faults
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, params = _small_engine_params(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 5, 20)]
    scfg = ServeConfig(prefill_mode="continuous", pack_weights=True, max_seq=64, page_size=16,
                       max_batch=2, prefill_chunk=8, wire_dtype="native", kv_dtype="int8",
                       paged_attn="fused")
    want = Engine(params, cfg, scfg, device="cuda").generate_requests(prompts, 8,
                                                                      arrivals=[0, 3, 1])
    eng = Engine(params, cfg, scfg, device="cuda")
    eng.set_faults(faults.FaultConfig(seed=0, fail_fused=True))
    got = eng.generate_requests(prompts, 8, arrivals=[0, 3, 1])
    assert eng.fallbacks == 1 and eng.cfg.sparsity.paged_attn == "gather"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------ recurrent families


@pytest.mark.parametrize("m,k,n", [(1, 1600, 6482), (4, 1600, 6482), (64, 1600, 6482),
                                   (3, 64, 6), (5, 1600, 6)])
@pytest.mark.parametrize("kind", ["w", "aw"])
def test_int8_generic_any_n(cuda, m, k, n, kind):
    """#2 and #3 take any N: the generic body's guarded column tail at
    N % 4 != 0 (hymba-1.5b's ``in_proj``, 1600 -> 6482, and N = 6), the
    packed weight in the reference's layout, unpadded.  Int32 accumulators
    and the f32 output with a random bias bit for bit with the plain
    versions, on the generic body."""
    cfg, xop, wop = _int8_operands(cuda, m, k, n, kind)
    bias = torch.randn((n,), generator=cuda, device="cuda")
    total, tc = _int8_counters(kind)
    before = (total.launches, tc.launches)
    y, want, acc, x_dense = _int8_run(kind, cfg, xop, wop, bias=bias)
    assert torch.equal(acc, ref.int8_acc(x_dense, ref.decode_w(wop[0], wop[1], cfg)))
    assert torch.equal(y, want)
    assert dbb_matmul.int8_body_error(k // 8, n) is not None
    assert (total.launches, tc.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("arch,wire", [("mamba2_130m", "native"), ("mamba2_130m", "int8"),
                                       ("hymba_1_5b", "native"), ("hymba_1_5b", "int8")])
def test_engine_serves_recurrent_archs_bf16(cuda, arch, wire):
    """bf16 smoke engines of mamba2-130m (ssm; native KV) and hymba-1.5b
    (hybrid; KV on the wire's dtype) served stepped (``auto``) on CUDA and
    on the CPU with the same weights, prompts past hymba's window of 32.
    Without DAP (``wdbb``) the tokens equal the CPU engine's.  With DAP
    (``awdbb``) one bf16 ulp can become another token, so that engine is
    held to itself: a fresh engine re-serves the same tokens.  Every
    linear ran a kernel, no plain version."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    kv = "native" if arch == "mamba2_130m" else wire
    scfg = ServeConfig(pack_weights=True, max_seq=96, wire_dtype=wire, kv_dtype=kv)
    prompts = np.random.default_rng(21).integers(0, 512, (3, 40)).astype(np.int32)
    for mode in ("wdbb", "awdbb"):
        cfg = configs.get_config(arch, smoke=True)
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  sparsity=dataclasses.replace(cfg.sparsity, mode=mode))
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
        outs = {}
        for device in ("cpu", "cuda"):
            ops.reset_counters()
            eng = Engine(params, cfg, scfg, device=device)
            outs[device] = eng.generate(prompts, 8)
            assert eng.prefill_calls == prompts.shape[1]
        counts = ops.counters()
        assert all(c.plain == 0 for c in counts.values()), counts
        mm = "dbb_matmul_int8" if wire == "int8" else "dbb_matmul"
        assert counts[mm].launches > 0
        if mode == "wdbb":
            np.testing.assert_array_equal(outs["cuda"], outs["cpu"])
        else:
            again = Engine(params, cfg, scfg, device="cuda").generate(prompts, 8)
            np.testing.assert_array_equal(again, outs["cuda"])


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_whisper_decode_loop_cuda_matches_cpu(cuda, wire):
    """whisper-base's smoke config in bf16 under ``wdbb`` (no DAP: one bf16
    ulp cannot become another selection), packed on ``wire``: ``encode``
    of 2 seeded frame tensors, then a 12-token greedy ``decode_step`` loop
    over the ring cache, on CUDA and on the CPU with the same weights.
    The encoder outputs agree within 2e-2 of their scale, the tokens are
    equal, and every linear ran a kernel on CUDA, no plain version."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import encdec, lm
    from repro_torch.serve.engine import _to_device, pack_params_for_serving

    cfg = configs.get_config("whisper_base", smoke=True)
    cfg = dataclasses.replace(cfg, dtype="bfloat16",
                              sparsity=dataclasses.replace(cfg.sparsity, mode="wdbb"))
    dense = encdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    packed = pack_params_for_serving(dense, cfg, wire)
    rng = np.random.default_rng(23)
    frames = torch.from_numpy(rng.standard_normal((2, cfg.n_frames, cfg.d_model))
                              .astype(np.float32)).to(torch.bfloat16)
    start = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
    n_new = 12
    encs, toks = {}, {}
    for device in ("cpu", "cuda"):
        params = _to_device(packed, device)
        ops.reset_counters()
        enc = encdec.encode(params, frames.to(device), cfg)
        cache = lm.make_cache(cfg, 2, n_new, device)
        tok, out = start.to(device), []
        for t in range(n_new):
            logits, cache = encdec.decode_step(params, cache, enc, tok, t, cfg)
            tok = logits[:, -1, :cfg.vocab].argmax(dim=-1, keepdim=True).to(torch.int32)
            out.append(tok)
        encs[device], toks[device] = enc.float().cpu(), torch.cat(out, dim=1).cpu()
    counts = ops.counters()
    assert all(c.plain == 0 for c in counts.values()), counts
    mm = "dbb_matmul_int8" if wire == "int8" else "dbb_matmul"
    assert counts[mm].launches > 0
    scale = encs["cpu"].abs().max().item()
    assert (encs["cuda"] - encs["cpu"]).abs().max().item() <= 2e-2 * scale
    assert torch.equal(toks["cuda"], toks["cpu"])


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(64, 1024), (17, 40)])
def test_dap_ste_on_the_card(cuda, dtype, m, k):
    """The straight-through DAP (``core/dap.DAPSTE``) on a CUDA tensor: #5's
    dense form forward, bit for bit with ``dbb.prune``; the backward bit for
    bit with the gradient times a recomputed ``dbb.topk_block_mask``, on
    zero-filled and part-zero blocks, -0.0, ties and a NaN block."""
    from repro_torch.core.dap import DAPSTE

    x = torch.randn((m, k), generator=cuda, device="cuda")
    x[0, :8] = 0.0
    x[1, ::3] = 0.0
    x[2, :8] = -0.0
    x[3, :8] = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 0.0, -0.0, 2.0], device="cuda")
    x[4, 8:16] = float("nan")
    x = x.to(dtype)
    g = torch.randn((m, k), generator=cuda, device="cuda").to(dtype)
    before = dap_prune.DAP_PRUNE.launches
    xa = x.clone().requires_grad_(True)
    y = DAPSTE.apply(xa, 4, 8)
    y.backward(g)
    assert dap_prune.DAP_PRUNE.launches == before + 1
    cfg = dbb.DBBConfig(4, 8)
    v = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(y.detach().view(v), dbb.prune(x, cfg).view(v))
    want = torch.where(dbb.topk_block_mask(x, cfg), g, torch.zeros_like(g))
    assert torch.equal(xa.grad.view(v), want.view(v))


def _train_smoke(arch, mode="awdbb", dtype="float32", **over):
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch, smoke=True, sparsity_mode=mode)
    return dataclasses.replace(cfg, dtype=dtype, **over)


def _train_batch(cfg, b=2, s=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen, dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}


def _grads(cfg, params, batch):
    from repro_torch.core import tree
    from repro_torch.train import train_step

    req = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = train_step.loss_fn(tree.unflatten(params, req), batch, cfg)
    return torch.autograd.grad(loss, req)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "granite_3_8b"])
def test_remat_same_grads_on_the_card(cuda, arch):
    """Under awdbb on the card (#5 in every DAP site, twice with remat),
    ``remat="full"`` and ``"none"`` give the same gradients bit for bit."""
    from repro_torch.core import tree
    from repro_torch.models import lm

    cfg = _train_smoke(arch, dtype="bfloat16")
    params = lm.init_params(cfg, cuda, "cuda", wire_dtype=None)
    batch = {k: v.cuda() for k, v in _train_batch(cfg).items()}
    before = dap_prune.DAP_PRUNE.launches
    full = _grads(cfg, params, batch)
    n_full = dap_prune.DAP_PRUNE.launches - before
    import dataclasses

    none = _grads(dataclasses.replace(cfg, remat="none"), params, batch)
    n_none = dap_prune.DAP_PRUNE.launches - before - n_full
    assert n_full == 2 * n_none > 0
    for a, b in zip(full, none):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert len(full) == len(tree.leaves(params))


def test_train_step_card_matches_cpu(cuda):
    """One smoke ``train_step`` of granite-moe in f32 under wdbb (no DAP, so
    no selection flip) with W-DBB masks: the card against the CPU, loss
    within 1e-5 relative, moments within 1e-4 of each leaf's largest,
    params within 1e-4 absolute at lr 1e-3 (AdamW's first step divides a
    moment by its own root)."""
    from repro_torch.core import schedule, tree
    from repro_torch.models import lm
    from repro_torch.train import optimizer, train_step

    cfg = _train_smoke("granite_moe_1b_a400m", mode="wdbb")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
    masks = schedule.wdbb_masks(params, dbb.DBBConfig(4, 8))
    batch = _train_batch(cfg)
    ocfg = optimizer.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for dev in ("cpu", "cuda"):
        mv = lambda t, dev=dev: t.to(dev)  # noqa: E731
        out[dev] = train_step.train_step(
            tree.tree_map(mv, params), optimizer.init(tree.tree_map(mv, params)),
            {k: v.to(dev) for k, v in batch.items()}, cfg=cfg, opt_cfg=ocfg,
            masks=tree.tree_map(mv, masks))
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out["cuda"]
    assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-5 * abs(float(mc["loss"]))
    assert float(mc["lr"]) == float(mg["lr"])
    for a, b in zip(tree.leaves(pc), tree.leaves(pg)):
        assert (a - b.cpu()).abs().max().item() <= 1e-4
    for ta, tb in ((sc.mu, sg.mu), (sc.nu, sg.nu)):
        for a, b in zip(tree.leaves(ta), tree.leaves(tb)):
            assert (a - b.cpu()).abs().max().item() <= 1e-4 * max(a.abs().max().item(), 1e-30)
    cmask = schedule.wdbb_masks(tree.tree_map(lambda t: t.cuda(), params), dbb.DBBConfig(4, 8))
    for a, b in zip(tree.leaves(masks), tree.leaves(cmask)):
        assert torch.equal(a, b.cpu())


# ------------------------------------------------------------- the autotuner


@pytest.fixture
def plan_cache(monkeypatch, tmp_path):
    """``kernels/autotune`` with its cache in a file of the test's own
    directory, empty before and cleared after."""
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "plans.json"))
    autotune.clear_cache()
    yield autotune
    autotune.clear_cache()


@pytest.mark.parametrize("kind", ["w_int8", "aw_int8"])
def test_int8_every_candidate_plan_exact(cuda, plan_cache, kind):
    """Every candidate plan of #2 / #3 at a tc shape (M = 40: bm 16 takes
    three row tiles, 64 one; K = 1024: 1 to 8 splits) runs the tc body and
    gives the plain version's int32 accumulators and f32 output bit for
    bit (integer sums are exact under any split)."""
    cfg = dbb.DBBConfig(4, 8)
    m, k, n = 40, 1024, 384
    w = torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)
    wv, wm, ws = ref.pack_weight_int8(w, cfg)
    x = torch.randn((m, k), generator=cuda, device="cuda")
    if kind == "aw_int8":
        xv, xm, xs = ops.dap_pack_int8(x, 4, 8, act_scale="per_row")
        x_dense, tc = ref.decode_a(xv, xm, cfg), dbb_matmul.AW_INT8_TC
        want = ref.dbb_matmul_aw_int8_ref(xv, xm, xs, wv, wm, ws, cfg, cfg)

        def run(plan, acc):
            return dbb_matmul.dbb_matmul_aw_int8_cuda(xv, xm, xs, wv, wm, ws, cfg, cfg,
                                                      acc_out=acc, plan=plan)
    else:
        xq, xs = ref.quantize_act_int8(x, per_row=True)
        x_dense, tc = xq, dbb_matmul.INT8_TC
        want = ref.dbb_matmul_int8_ref(xq, xs, wv, wm, ws, cfg)

        def run(plan, acc):
            return dbb_matmul.dbb_matmul_int8_cuda(xq, xs, wv, wm, ws, cfg, acc_out=acc, plan=plan)
    want_acc = ref.int8_acc(x_dense, ref.decode_w(wv, wm, cfg))
    plans = dbb_matmul.candidate_plans(kind, m, k, n)
    assert len(plans) == 10
    for plan in plans:
        acc = torch.empty((m, n), dtype=torch.int32, device="cuda")
        before = tc.launches
        y = run(plan, acc)
        assert tc.launches == before + 1, plan
        assert torch.equal(acc, want_acc) and torch.equal(y, want), plan
    with pytest.raises(ValueError, match="bm=32"):
        run((32, 128, 1), None)


@pytest.mark.parametrize("kind", ["w", "aw"])
def test_native_every_candidate_plan_within_tolerance(cuda, plan_cache, kind):
    """Every candidate plan of #1 / #4 at a tc shape (K = 1536: 1 to 8
    splits of whole 64-wide k-steps; bn 64 and 128) runs the tc body: f32
    within 1e-5 of the largest output, bf16 within one ulp of it (both well
    inside the record's 0.0156), and under each plan the rows of an M = 4
    call and a one-row call equal the M = 64 call's bit for bit."""
    m, k, n = 64, 1536, 320
    cfg, x, xv, xm, wv, wm, bias = _native_operands(cuda, m, k, n, torch.bfloat16)
    tc = dbb_matmul.AW_NATIVE_TC if kind == "aw" else dbb_matmul.NATIVE_TC

    def run(rows, out, plan=None, plain=False):
        if kind == "aw":
            fn = ref.dbb_matmul_aw_ref if plain else dbb_matmul.dbb_matmul_aw_cuda
            kw = {} if plain else dict(plan=plan)
            return fn(xv[rows], xm[rows], wv, wm, cfg, cfg, bias=bias, act="silu", out_dtype=out,
                      **kw)
        fn = ref.dbb_matmul_ref if plain else dbb_matmul.dbb_matmul_cuda
        kw = {} if plain else dict(plan=plan)
        return fn(x[rows], wv, wm, cfg, bias=bias, act="silu", out_dtype=out, **kw)

    want = run(slice(0, m), torch.float32, plain=True)
    want_b = run(slice(0, m), torch.bfloat16, plain=True).float()
    tol = 1e-5 * want.abs().max().item()
    plans = dbb_matmul.candidate_plans(kind, m, k, n)
    assert len(plans) == 14
    for plan in plans:
        before = tc.launches
        y = run(slice(0, m), torch.float32, plan)
        assert tc.launches == before + 1, plan
        assert (y - want).abs().max().item() <= tol, plan
        yb = run(slice(0, m), torch.bfloat16, plan).float()
        ulp = 2.0 ** -7 * torch.maximum(yb.abs(), want_b.abs())
        assert bool(((yb - want_b).abs() <= ulp + tol).all()), plan
        assert torch.equal(run(slice(0, 4), torch.float32, plan), y[:4]), plan
        assert torch.equal(run(slice(9, 10), torch.float32, plan)[0], y[9]), plan
    with pytest.raises(ValueError, match="leave one empty"):
        run(slice(0, m), torch.float32, (128, 128, 3))


def test_autotune_on_the_card(cuda, plan_cache):
    """A sweep on the card: #3's winner is cached and resolved for its
    shape; gather against fused at a decode step caches a verdict (both
    implementations run here) that ``get_paged_attn_impl`` returns for
    CUDA tensors, and a CPU lookup answers fused only by the heuristic's
    rule (never)."""
    import json
    import os

    from repro_torch.models import attention

    autotune = plan_cache
    cfg = dbb.DBBConfig(4, 8)
    m, k, n = 64, 2048, 1024
    w = torch.randn((k, n), generator=cuda, device="cuda") / math.sqrt(k)
    wv, wm, ws = ref.pack_weight_int8(w, cfg)
    xv, xm, xs = ops.dap_pack_int8(torch.randn((m, k), generator=cuda, device="cuda"), 4, 8,
                                   act_scale="per_row")
    win = autotune.autotune(
        lambda plan: (lambda: dbb_matmul.dbb_matmul_aw_int8_cuda(
            xv, xm, xs, wv, wm, ws, cfg, cfg, out_dtype=torch.bfloat16, plan=plan)),
        m, k, n, 4, 8, "aw_int8", rules=dbb_matmul.PLAN_RULES)
    assert win in dbb_matmul.candidate_plans("aw_int8", m, k, n)
    assert autotune.get_plan("aw_int8", m, k, n, 4, 8, dbb_matmul.PLAN_RULES) == win
    q, k_p, v_p, pos, tables, q_pos, kw = _tc_case(cuda, 4, 1, 4, 128, 8, True, 6)
    layer = dict(k=k_p, v=v_p, k_scale=kw["k_scale"], v_scale=kw["v_scale"], pos=pos)
    timings = {}
    impl = autotune.autotune_paged_attn(
        lambda i: (lambda: attention.paged_attend(i, q, layer, tables, q_pos, kv_heads=8,
                                                  window=None, dtype=torch.bfloat16)),
        4, 4, 16, 128, timings=timings)
    assert set(timings) == set(autotune.PAGED_ATTN_IMPLS)
    assert all(isinstance(t, float) for t in timings.values())
    assert impl == min(timings, key=timings.get)
    assert autotune.get_paged_attn_impl(4, 4, 16, 128, q.device) == impl
    assert autotune.get_paged_attn_impl(4, 4, 16, 128, "cpu") == "gather"
    with open(os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]) as f:
        saved = json.load(f)
    assert saved[json.dumps(["paged_attn", 4, 4, 16, 128, 0])] == [impl]
    assert saved[json.dumps(["aw_int8", m, k, n, 4, 8])] == list(win)

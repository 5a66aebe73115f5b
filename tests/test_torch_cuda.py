"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
import) when no CUDA device is present, as on a CPU-only host.  On a
machine with an H100 and nvcc, run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the same checks at granite-3-8b's full widths;
these stay small and add odd, ragged shapes.

Tolerances: int32 accumulators and ``act=None`` float32 outputs are
bit-exact (integer work, then the same f32 operations); paged attention
in f32 is held to 1e-5, the reference's kernel-vs-oracle bound."""

import math

import pytest
import torch

from repro_torch.core import dbb, quant
from repro_torch.kernels import dbb_matmul, ops, paged_attn, ref

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


@pytest.mark.parametrize("s", [3, 70], ids=["chunk", "long_chunk"])
def test_paged_attn_kernel_f32(cuda, s):
    """A long chunk (70 tokens x 2 heads > 64 rows) spans row blocks."""
    n_pages, ps, kv, d, b = 12, 8, 2, 32, 2
    k_q, k_s = quant.quantize_rows(torch.randn((n_pages, ps, kv * d), generator=cuda, device="cuda"))
    v_q, v_s = quant.quantize_rows(torch.randn((n_pages, ps, kv * d), generator=cuda, device="cuda"))
    pos = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    pos[3] = torch.arange(ps, dtype=torch.int32)
    pos[7, :5] = torch.arange(ps, ps + 5, dtype=torch.int32)
    pos[5, :6] = torch.arange(6, dtype=torch.int32)
    tables = torch.tensor([[3, 7, 9], [5, 0, 0]], dtype=torch.int32, device="cuda")
    q = torch.randn((b, s, 2 * kv, d), generator=cuda, device="cuda")
    # the last s positions of each request; negative ones are padding rows
    q_pos = torch.stack([torch.arange(13 - s, 13), torch.arange(6 - s, 6)]).to(
        device="cuda", dtype=torch.int32)
    rows = q_pos >= 0  # padding rows attend to nothing: their output is garbage
    for window in (None, 4):
        kw = dict(kv_heads=kv, window=window, k_scale=k_s, v_scale=v_s)
        got = paged_attn.paged_attn_cuda(q, k_q, v_q, pos, tables, q_pos, **kw)
        want = ref.paged_attn_ref(q, k_q, v_q, pos, tables, q_pos, **kw)
        torch.testing.assert_close(got[rows], want[rows], atol=1e-5, rtol=1e-5)

"""The yardstick's arithmetic on synthetic inputs, worked by hand: the
traffic generator, the metric readers, the frozen roofline sums, the
trace reductions and the kernel-path guard."""

import types

import numpy as np
import pytest

import pb_harness
import pb_roofline
import pb_spec
import pb_trace
import pb_traffic

GRANITE = pb_spec.config("granite-3-8b.int8")


@pytest.mark.parametrize("mix_name", ["longdoc", "chat"])
def test_traffic_is_seeded_and_in_range(mix_name):
    mix = pb_spec.traffic(mix_name)
    a = pb_traffic.Rounds(mix, 1000, 2**31 + 17)
    b = pb_traffic.Rounds(mix, 1000, 2**31 + 17)
    c = pb_traffic.Rounds(mix, 1000, 5)
    pa, oa = a.next()
    pb, ob = b.next()
    pc, oc = c.next()
    assert oa == ob and all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert len(pa) == mix["round_size"]
    # every seed serves the same sizes in the same order: its own tokens
    assert [len(p) for p in pa] == [len(p) for p in pc] and oa == oc
    assert not any(np.array_equal(x, y) for x, y in zip(pa, pc))
    lo, hi = mix["prompt_len"]["min"], mix["prompt_len"]["max"]
    assert all(lo <= len(p) <= hi for p in pa)
    assert all(mix["output_len"]["min"] <= o <= mix["output_len"]["max"] for o in oa)
    assert all(p.dtype == np.int32 and p.min() >= 0 and p.max() < 1000 for p in pa)
    # a second round: new prompts, the same sizes in another order
    pa2, oa2 = a.next()
    assert sorted(zip(map(len, pa2), oa2)) == sorted(zip(map(len, pa), oa))
    assert [len(p) for p in pa2] != [len(p) for p in pa]


def _run(**kw):
    base = dict(cfg=GRANITE, mix=pb_spec.traffic("longdoc"), requests=[], window_s=2.0,
                setup_s=30.0, gen_tokens=0, step_calls=0, dispatches=[], spans=[], slice=None,
                slice_range=None, roofline=pb_roofline)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_tails_are_over_all_requests():
    reqs = [dict(ttft_s=0.1 * (i + 1), tpot_s=None if i == 0 else 0.01 * i, n_gen=5)
            for i in range(10)]
    run = _run(requests=reqs, gen_tokens=50, window_s=2.0)
    # numpy's linear quantile: (10 - 1) * 0.9 = 8.1 -> 0.9 + 0.1 * (1.0 - 0.9)
    assert pb_spec.reader("ttft_p90_ms")(run) == pytest.approx(910.0)
    # tpot over the 9 requests with two or more tokens: 0.01..0.09, 8 * 0.9 = 7.2
    assert pb_spec.reader("tpot_p90_ms")(run) == pytest.approx(82.0)
    assert pb_spec.reader("gen_tokens_per_s")(run) == pytest.approx(25.0)


def test_pass_fill_dispatch_and_enqueue():
    disp = [dict(kind="step", computed=16 * 128, fed=1000, passes=1, sampled=8,
                 rows=[(0, 100)], host_s=0.05),
            dict(kind="run", computed=16 * 4, fed=40, passes=4, sampled=40,
                 rows=[(100, 4)] * 10, host_s=0.15)]
    run = _run(dispatches=disp, step_calls=2, window_s=1.0)
    assert pb_spec.reader("pass_fill")(run) == pytest.approx(100.0 * 1040 / 2112)
    assert pb_spec.reader("dispatch_ms")(run) == pytest.approx(500.0)
    assert pb_spec.reader("enqueue_ms_per_pass")(run) == pytest.approx(40.0)


def test_granite_model_work_by_hand():
    # per token: 40 layers x 2 x (4/8 of the weights) x (wq 4096^2 + wk, wv 4096 x 1024
    # + wo 4096^2 + gate, up, down 4096 x 12800) = 7,969,177,600
    # ten tokens from position 0: 55 (query, key) pairs x 4 x 32 heads x 128 x 40 layers
    # one sampled token through the head: 2 x 4096 x 49155 x 4/8
    want = 10 * 7_969_177_600 + 55 * 4 * 32 * 128 * 40 + 201_338_880
    assert pb_roofline.model_work(GRANITE, [(0, 10)], 1) == want
    run = _run(dispatches=[dict(rows=[(0, 10)], sampled=1)], window_s=1.0)
    assert pb_spec.reader("mfu")(run) == pytest.approx(100.0 * want / 1979e12)


def test_bounds_reproduce_the_kernel_table():
    """PERF.md's kernel table: #2 0.1746 ms and #3 1.4340 ms a granite pass at M = 64."""
    w8, aw8 = 0.0, 0.0
    for name, k, n, count, packed, dap in pb_roofline.linears(GRANITE):
        t = count * pb_roofline.bound_s(pb_roofline.linear_bytes(GRANITE, k, n, 64, packed),
                                        pb_roofline.linear_ops(GRANITE, k, n, 64, dap),
                                        pb_roofline.INT8_OPS_PER_S)
        if packed:
            aw8 += t
        else:
            w8 += t
    assert round(w8 * 1e3, 4) == 0.1746
    assert round(aw8 * 1e3, 4) == 1.4340
    assert pb_roofline.dbb_bound_s(GRANITE, 64) == pytest.approx(w8 + aw8)


def test_attention_bound_counts_causal_pairs():
    rows = [(0, 16), (100, 1)]
    nbytes, nops = pb_roofline.attn_bytes_ops(GRANITE, rows, 16, 2, 16, 196)
    pairs = 16 * 17 // 2 + 101
    assert nops == 40 * pairs * 4 * 32 * 128
    page = 2 * 16 * 1024 + 4 * 16 + 8 * 16
    assert nbytes == 40 * (2 * 2 * 2 * 16 * 32 * 128 + (1 + 7) * page + 4 * 2 * 196 + 4 * 2 * 16)


def test_trace_reductions():
    ev = [("void (anonymous namespace)::dbb_int8_tc_kernel<4, true>(signed char const*)", 0.0, 1.0),
          ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)", 1.5, 2.0),
          ("void (anonymous namespace)::reduce_kernel<float>(float const*)", 3.0, 3.5)]
    assert pb_trace.busy_s(ev, 0.0, 4.0) == pytest.approx(2.0)
    match = pb_trace.kernel_matcher(("dbb_int8_tc_kernel", "reduce_kernel"))
    assert [match(n) for n, _, _ in ev] == [True, False, True]
    assert pb_trace.device_time(ev, 0.0, 4.0, match) == pytest.approx(1.5)
    spans = [("round", 0.0, 4.0, 0), ("plan", 0.9, 1.6, 1)]
    gaps = dict((n, t) for n, t in pb_trace.idle_gaps(ev, 0.0, 4.0, spans))
    assert gaps == pytest.approx({"plan": 0.5, "round": 1.5})
    top = pb_trace.top_ops(ev, 0.0, 4.0)
    assert top[0] == ["dbb_int8_tc_kernel", 1.0]
    sl = types.SimpleNamespace(events=ev, t0=0.0, t1=4.0)
    assert pb_spec.reader("idle_share")(_run(slice=sl)) == pytest.approx(50.0)
    assert pb_spec.reader("idle_share")(_run()) is None


def test_kernel_guard():
    c = types.SimpleNamespace
    clean = {"a": c(plain=0, launches=5), "b": c(plain=0, launches=1)}
    assert pb_harness.kernel_guard(clean, 0, None, True) == {
        "plain_calls": (0, 0), "gather_calls": (0, 0), "autotune_cache_env": (0, 0)}
    bad = pb_harness.kernel_guard({"a": c(plain=3, launches=0)}, 2, "/x.json", True)
    assert bad == {"plain_calls": (3, 0), "gather_calls": (2, 0), "autotune_cache_env": (1, 0)}
    # on the CPU every kernel is its plain version: not a fault there
    assert "plain_calls" not in pb_harness.kernel_guard({"a": c(plain=3, launches=0)}, 0, None,
                                                        False)

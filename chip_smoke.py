#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and runs right on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; needs one CUDA card and nvcc, and
nothing of JAX.  Phases, each printed on its own line; any failure exits
non-zero and prints no result:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. the kernel build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled
   with nvcc for sm_90a, all at once, and its time;
3. each kernel held against its plain PyTorch version on the card at the
   main path's full-width granite-3-8b shapes, and timed beside its plain
   version, a PyTorch library call computing the same function, and its
   bound (bytes over 3.35 TB/s or operations over the peak rate);
4. the main path: a full-width granite-3-8b engine (40 layers, seeded
   random weights, bf16, int8 DBB wire, int8 KV) serves 8 requests
   continuously through ``Engine.generate_requests``, and the launch
   counters show every linear and every attention call went through the
   kernels.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak

SEED = 0
N_REQUESTS, N_NEW = 8, 32
SERVE = dict(
    prefill_mode="continuous", pack_weights=True, wire_dtype="int8", kv_dtype="int8",
    max_seq=1024, page_size=16, max_batch=4, prefill_chunk=16, decode_block=16,
)
# (name, kernel, act on the main path, K, N) of granite-3-8b's linears
LINEARS = (
    ("wq", "aw", None, 4096, 4096),
    ("wk", "aw", None, 4096, 1024),
    ("wv", "aw", None, 4096, 1024),
    ("wo", "w", None, 4096, 4096),
    ("gate", "aw", "silu", 4096, 12800),
    ("up", "aw", None, 4096, 12800),
    ("down", "aw", None, 12800, 4096),
    ("lm_head", "w", None, 4096, 49408),
)
KERNELS = {
    "dbb_matmul_aw_int8": dict(
        source="src/repro_torch/kernels/csrc/dbb_matmul_int8.cu",
        replaces="src/repro/kernels/dbb_matmul.py:345",
    ),
    "dbb_matmul_int8": dict(
        source="src/repro_torch/kernels/csrc/dbb_matmul_int8.cu",
        replaces="src/repro/kernels/dbb_matmul.py:272",
    ),
    "paged_attn": dict(
        source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:168",
    ),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*parts):
    print(*parts, flush=True)


def phase_card(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    say(smi[0])
    say(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi[0]


def timer(torch, flush_buf):
    """Mean device time in ms over ``iters`` calls, each timed with its own
    CUDA events and started with a cold L2 (a 256 MB write first), as the
    main path meets its weights: streamed once per step."""

    def run(fn, iters, warmup=1):
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            flush_buf.zero_()
            # keep the card busy while the host enqueues the call, so the
            # events time the device work and not the Python wrapper
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    return run


def phase_matmuls(torch, run_ms):
    from repro_torch.core import dbb
    from repro_torch.core.dap import DAPSpec, apply_dap
    from repro_torch.kernels import dbb_matmul, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = dbb.DBBConfig(4, 8)
    per_kernel = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                          bytes=0.0, ops=0.0)
                  for k in ("dbb_matmul_aw_int8", "dbb_matmul_int8")}
    for name, kind, act, k, n in LINEARS:
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        wv, wm, ws = ref.pack_weight_int8(w.to(torch.bfloat16), cfg)
        del w
        w_dense = ref.decode_w(wv, wm, cfg)
        w_nz = (w_dense != 0).sum(dim=1).double()  # non-zeros per k row
        kname = "dbb_matmul_aw_int8" if kind == "aw" else "dbb_matmul_int8"
        count = 1 if name == "lm_head" else 40  # launches per forward pass
        for m in (4, 64):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            if kind == "aw":
                xv, xm, xs = ops.dap_pack_int8(x, 4, 8, act_scale="per_row")
                x_dense = ref.decode_a(xv, xm, cfg)
                kern = lambda a, o, acc=None: dbb_matmul.dbb_matmul_aw_int8_cuda(  # noqa: E731
                    xv, xm, xs, wv, wm, ws, cfg, cfg, act=a, out_dtype=o, acc_out=acc)
                plain = lambda a, o: ref.dbb_matmul_aw_int8_ref(  # noqa: E731
                    xv, xm, xs, wv, wm, ws, cfg, cfg, act=a, out_dtype=o)
                x_bytes = xv.numel() + xm.numel() + 4 * m
            else:
                if name == "wo":  # the attention output is DAP-pruned first
                    x = apply_dap(x, DAPSpec(4, 8))
                xq, xs = ref.quantize_act_int8(x, per_row=True)
                x_dense = xq
                kern = lambda a, o, acc=None: dbb_matmul.dbb_matmul_int8_cuda(  # noqa: E731
                    xq, xs, wv, wm, ws, cfg, act=a, out_dtype=o, acc_out=acc)
                plain = lambda a, o: ref.dbb_matmul_int8_ref(  # noqa: E731
                    xq, xs, wv, wm, ws, cfg, act=a, out_dtype=o)
                x_bytes = xq.numel() + 4 * m
            # exact: int32 accumulators and the act=None f32 output
            acc = torch.empty((m, n), dtype=torch.int32, device="cuda")
            y = kern(None, torch.float32, acc)
            acc_ref = ref.int8_acc(x_dense, w_dense)
            check(torch.equal(acc, acc_ref), f"{name} M={m}: int32 accumulators differ")
            y_ref = plain(None, torch.float32)
            check(torch.equal(y, y_ref), f"{name} M={m}: act=None f32 output differs")
            # silu and bf16: the f32 silu within 1e-6; bf16 within one bf16 ulp
            # (a 1-ulp f32 difference in sigmoid can straddle a bf16 rounding)
            ys = kern("silu", torch.float32)
            ys_ref = plain("silu", torch.float32)
            err32 = (ys - ys_ref).abs()
            check(bool((err32 <= 1e-6 + 1e-6 * ys_ref.abs()).all()),
                  f"{name} M={m}: silu f32 off by {err32.max().item():.3g}")
            yb = kern("silu", torch.bfloat16).float()
            yb_ref = plain("silu", torch.bfloat16).float()
            errb = (yb - yb_ref).abs()
            check(bool((errb <= 2.0 ** -7 * yb_ref.abs() + 1e-6).all()),
                  f"{name} M={m}: silu bf16 off by {errb.max().item():.3g}")
            err = max(err32.max().item(), errb.max().item())
            # times at the main path's call: bf16 out, its own activation
            t_k = run_ms(lambda: kern(act, torch.bfloat16), iters=10)
            t_p = run_ms(lambda: plain(act, torch.bfloat16), iters=2)
            t_lib = None
            if m > 16:  # torch._int_mm refuses M <= 16
                t_lib = run_ms(lambda: torch._int_mm(x_dense, w_dense), iters=10)
            nbytes = x_bytes + wv.numel() + wm.numel() + 4 * n + 2 * m * n
            x_nz = (x_dense != 0).sum(dim=0).double()
            nops = 2.0 * float((x_nz * w_nz).sum())  # non-zero products only
            bound = max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / INT8_OPS_PER_S else "operations"
            say(f"kernel {kname} {name} M={m} K={k} N={n}: kernel_ms {t_k:.4f} "
                f"plain_ms {t_p:.3f} library_ms "
                f"{'n/a' if t_lib is None else f'{t_lib:.4f}'} bound_ms {bound:.4f} "
                f"({by}) max_abs_err {err:.3g}")
            agg = per_kernel[kname]
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if m == 64:  # the JSON record: one mixed-step forward pass
                agg["ms"] += count * t_k
                agg["plain_ms"] += count * t_p
                agg["library_ms"] += count * t_lib
                agg["bytes"] += count * nbytes
                agg["ops"] += count * nops
        del wv, wm, ws, w_dense
        torch.cuda.empty_cache()
    for agg in per_kernel.values():
        t_bytes = agg["bytes"] / HBM_BYTES_PER_S
        t_ops = agg["ops"] / INT8_OPS_PER_S
        agg["bound_ms"] = max(t_bytes, t_ops) * 1e3
        agg["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return per_kernel


def phase_attention(torch, run_ms):
    from repro_torch.core import quant
    from repro_torch.kernels import paged_attn, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, kv, g, d, ps, p_cnt = 4, 8, 4, 128, 16, 64
    n_pages = b * p_cnt + 1
    kvd = kv * d
    k_q, k_s = quant.quantize_rows(torch.randn((n_pages, ps, kvd), generator=gen, device="cuda"))
    v_q, v_s = quant.quantize_rows(torch.randn((n_pages, ps, kvd), generator=gen, device="cuda"))
    pos_tbl = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    lengths = (1000, 517, 64, 250)  # tokens cached per request
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((b, p_cnt), dtype=torch.int32, device="cuda")  # null padded
    nxt = 0
    for i, t in enumerate(lengths):
        used = -(-t // ps) + 1  # + one recycled page: allocated, slots scrubbed
        pages = perm[nxt:nxt + used]
        nxt += used
        tables[i, :used] = pages
        for j, page in enumerate(pages[:-1].tolist()):
            pos = torch.arange(j * ps, (j + 1) * ps, device="cuda")
            pos_tbl[page] = torch.where(pos < t, pos, -1).to(torch.int32)
    valid_pages = pos_tbl[tables.long()].ge(0).any(dim=-1)  # [B, P] pages with data
    stats = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0, bytes=0.0, ops=0.0)
    for s in (1, 16):
        q = torch.randn((b, s, kv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
        q_pos = torch.stack([torch.arange(t - s, t, device="cuda") for t in lengths]).to(torch.int32)
        kw = dict(kv_heads=kv, k_scale=k_s, v_scale=v_s)
        out = paged_attn.paged_attn_cuda(q, k_q, v_q, pos_tbl, tables, q_pos, **kw)
        want = ref.paged_attn_ref(q, k_q, v_q, pos_tbl, tables, q_pos, **kw)
        # bf16: the sums run in another order, which can straddle a bf16
        # rounding of a probability or of the output: two bf16 ulps at 1
        err = (out.float() - want.float()).abs().max().item()
        check(err <= 1.6e-2, f"paged_attn S={s} bf16: max error {err:.3g}")
        out32 = paged_attn.paged_attn_cuda(q.float(), k_q, v_q, pos_tbl, tables, q_pos, **kw)
        want32 = ref.paged_attn_ref(q.float(), k_q, v_q, pos_tbl, tables, q_pos, **kw)
        err32 = (out32 - want32).abs().max().item()
        check(err32 <= 1e-5 + 1e-5 * want32.abs().max().item(),
              f"paged_attn S={s} f32: max error {err32:.3g}")
        t_k = run_ms(lambda: paged_attn.paged_attn_cuda(q, k_q, v_q, pos_tbl, tables, q_pos, **kw), 20)
        t_p = run_ms(lambda: ref.paged_attn_ref(q, k_q, v_q, pos_tbl, tables, q_pos, **kw), 2)
        # library yardstick: SDPA over the gathered, dequantized window
        # (the gather is set-up, outside the timed call)
        kk = quant.dequantize_rows(k_q[tables.long()], k_s[tables.long()], torch.bfloat16)
        vv = quant.dequantize_rows(v_q[tables.long()], v_s[tables.long()], torch.bfloat16)
        kk = kk.reshape(b, p_cnt * ps, kv, d).transpose(1, 2)
        vv = vv.reshape(b, p_cnt * ps, kv, d).transpose(1, 2)
        kpos = pos_tbl[tables.long()].reshape(b, 1, 1, p_cnt * ps)
        qp = q_pos.reshape(b, 1, s, 1)
        mask = (kpos >= 0) & (kpos <= qp)
        qq = q.transpose(1, 2)
        t_lib = run_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=True), 20)
        n_valid_pages = int(valid_pages.sum())
        page_bytes = 2 * ps * kvd + 2 * 4 * ps + 4 * ps  # k, v, scales, slot positions
        nbytes = (2 * q.numel() * 2 + n_valid_pages * page_bytes + tables.numel() * 4
                  + q_pos.numel() * 4)
        nops = 4.0 * s * kv * g * d * n_valid_pages * ps  # QK^T and PV over kept pages
        bound = max(nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / BF16_OPS_PER_S else "operations"
        say(f"kernel paged_attn B={b} S={s} H={kv * g} KV={kv} D={d} P={p_cnt} PS={ps} "
            f"int8-KV bf16: kernel_ms {t_k:.4f} plain_ms {t_p:.3f} library_ms {t_lib:.4f} "
            f"bound_ms {bound:.4f} ({by}) max_abs_err {err:.3g} (f32 {err32:.3g})")
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        if s == 16:  # the JSON record: one mixed-step forward pass (40 layers)
            stats.update(ms=40 * t_k, plain_ms=40 * t_p, library_ms=40 * t_lib,
                         bytes=40 * nbytes, ops=40 * nops)
    t_bytes = stats["bytes"] / HBM_BYTES_PER_S
    t_ops = stats["ops"] / BF16_OPS_PER_S
    stats["bound_ms"] = max(t_bytes, t_ops) * 1e3
    stats["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return stats


def phase_main_path(torch, np):
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = configs.get_config("granite_3_8b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, "cuda", wire_dtype="int8")
    torch.cuda.synchronize()
    packed_bytes = sum(
        t.numel() * t.element_size()
        for layer in params["layers"] for sub in layer.values() for p in sub.values()
        for t in (p.values() if isinstance(p, dict) else [p])
    ) + sum(t.numel() * t.element_size() for t in params["lm_head"].values())
    say(f"main path: init_params {time.perf_counter() - t0:.1f} s, packed linear "
        f"weights {packed_bytes} B (int8 DBB wire), embedding "
        f"{params['embed']['w'].numel() * 2} B (bf16)")
    eng = Engine(params, cfg, ServeConfig(**SERVE), device="cuda")

    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, size=N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, size=int(s)).astype(np.int32) for s in lens]
    arrivals = [2 * i for i in range(N_REQUESTS)]

    steps = {"n": 0}
    inner = lm.paged_step

    def counting_step(*a, **kw):
        steps["n"] += 1
        return inner(*a, **kw)

    lm.paged_step = counting_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    t0 = time.perf_counter()
    outs = eng.generate_requests(prompts, N_NEW, arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (c.launches, c.plain) for k, c in ops.counters().items()}
    lm.paged_step = inner
    passes = steps["n"]
    results = eng.last_results
    say(f"main path: {N_REQUESTS} requests, prompt lengths {lens.tolist()}, "
        f"arrivals {arrivals}, {N_NEW} new tokens each; {eng.step_calls} scheduler "
        f"dispatches ({eng.decode_run_calls} decode runs), {passes} forward passes, "
        f"wall {wall:.2f} s")
    for r in results:
        check(r.finish_reason == "length" and r.n_generated == N_NEW,
              f"request {r.rid}: {r.finish_reason} after {r.n_generated} tokens")
    check(all(len(o) == len(p) + N_NEW for o, p in zip(outs, prompts)), "output lengths")
    # per forward pass: wq, wk, wv, gate, up, down per layer; wo per layer
    # plus the lm_head; one attention per layer (240, 41, 40 at 40 layers)
    n_l = cfg.n_layers
    expect = {"dbb_matmul_aw_int8": 6 * n_l, "dbb_matmul_int8": n_l + 1, "paged_attn": n_l}
    for name, per_pass in expect.items():
        launches, plain = counts[name]
        check(plain == 0, f"{name}: plain version ran {plain} times on the main path")
        check(launches == per_pass * passes,
              f"{name}: {launches} launches, expected {per_pass} x {passes} passes")
    say(f"main path: launches {json.dumps({k: v[0] for k, v in counts.items()})}, "
        f"plain-version calls {json.dumps({k: v[1] for k, v in counts.items()})}")
    ttft = sorted(r.time_to_first_token for r in results)
    tok_s = N_REQUESTS * N_NEW / wall
    say(f"main path: TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms "
        f"(from enqueue; arrivals staggered), decode+prefill throughput "
        f"{tok_s:.2f} generated tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated()} B")

    # the same request served alone (its prompt pages now hit the prefix
    # cache): per-row int8 scales make it byte-identical
    k = int(np.argmax(lens))
    again = eng.generate_requests([prompts[k]], N_NEW)[0]
    check(np.array_equal(again, outs[k]), f"request {k} re-served alone diverged")
    # finite logits: the longest prompt's prefill logits, one solo step on
    # a fresh cache, and its greedy token equals the served first token
    from repro_torch.serve import paged_cache

    s = len(prompts[k])
    n_pages = -(-s // SERVE["page_size"]) + 1
    cache = paged_cache.make_paged_cache(eng.cfg, n_pages, SERVE["page_size"], "cuda")
    logits, _ = lm.paged_step(
        eng.params, cache, torch.tensor(prompts[k][None], device="cuda"),
        torch.arange(s, dtype=torch.int32, device="cuda")[None],
        torch.arange(1, n_pages, dtype=torch.int32, device="cuda")[None], eng.cfg,
    )
    row = logits[0, -1, : cfg.vocab]
    check(bool(torch.isfinite(logits[0, :, : cfg.vocab]).all()), "non-finite logits")
    check(int(row.argmax()) == int(outs[k][s]), "solo prefill token differs from served token")
    say(f"main path: re-served request {k} alone byte-identical; its prefill logits "
        f"finite, shape {tuple(logits.shape)}")
    return counts


def main():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_card(torch)
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    libs = native.build_all()
    say(f"build: {len(libs)} kernel libraries with nvcc ({' '.join(native.NVCC_FLAGS)}) "
        f"in {time.perf_counter() - t0:.1f} s")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    run_ms = timer(torch, flush)
    mm = phase_matmuls(torch, run_ms)
    attn = phase_attention(torch, run_ms)
    del flush
    torch.cuda.empty_cache()
    counts = phase_main_path(torch, np)

    record = []
    for name, info in KERNELS.items():
        st = mm[name] if name in mm else attn
        record.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"], "launches": counts[name][0],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st["library_ms"],
        })
    say("kernel times above in the record: one mixed-step forward pass of granite-3-8b "
        "(M=64 rows, S=16 query tokens per request), summed over its launches")
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

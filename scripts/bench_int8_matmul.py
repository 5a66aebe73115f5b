#!/usr/bin/env python3
"""Device time of the int8-wire DBB matmuls (kernels #2 and #3) at the
shapes a granite-3-8b serving step gives them, for one checkout of the port.

    python3 scripts/bench_int8_matmul.py [--root DIR] [--label NAME] [--iters 30]
        [--plan-blocks N] [--library]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts compare in one call: run it once per checkout, in turns.  For
each int8 linear of granite-3-8b (wq, wk, wv, gate, up, down: #3 on
DAP-packed activations; wo, lm_head: #2, wo's input DAP-pruned), at M = 4
(a decode step) and M = 64 (a mixed step), per-row activation scales and a
bf16 output as on the main path, it prints:

- the median device time of one call, CUDA events, cold L2 (a 256 MB
  write before each call), as ``chip_smoke.py`` times it;
- the device operations of one call, from ``torch.profiler`` over
  ``--iters`` warm calls: each kernel (and memset) by name with its device
  time per call, and how many device operations a call makes (the generic
  body's split calls: a memset, the body and an epilogue launch).

Then the per-pass sums at M = 64 and M = 4 (each linear times its launches
per forward pass: 40 layers, one head), the figure ``chip_smoke.py``
records.  ``--plan-blocks`` sets ``dbb_matmul.INT8_PLAN_BLOCKS``, the
blocks the launch plan aims for, for this run (a checkout without the
int8 plan ignores it); ``--library`` also
times ``torch._int_mm`` on the decoded operands at M = 64, the weight
row-major and column-major.
"""

import argparse
import math
import statistics
import sys
from pathlib import Path

# (name, kernel, activation, K, N), as chip_smoke.py's LINEARS
GRANITE = (
    ("wq", "aw", None, 4096, 4096),
    ("wk", "aw", None, 4096, 1024),
    ("wv", "aw", None, 4096, 1024),
    ("wo", "w", None, 4096, 4096),
    ("gate", "aw", "silu", 4096, 12800),
    ("up", "aw", None, 4096, 12800),
    ("down", "aw", None, 12800, 4096),
    ("lm_head", "w", None, 4096, 49408),
)
N_LAYERS = 40


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--plan-blocks", type=int, default=None)
    ap.add_argument("--library", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_int8_matmul: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.core import dbb
    from repro_torch.core.dap import DAPSpec, apply_dap
    from repro_torch.kernels import dbb_matmul, ops, ref

    if args.plan_blocks is not None and hasattr(dbb_matmul, "INT8_PLAN_BLOCKS"):
        dbb_matmul.INT8_PLAN_BLOCKS = args.plan_blocks
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn):
        fn()
        times = []
        for _ in range(args.iters):
            flush.zero_()
            torch.cuda._sleep(10_000_000)  # the host enqueues while the card is busy
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ops(fn):
        """Device ms per call of each kernel or memset ``fn`` makes, and
        how many device operations a call makes."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        out, n_ops = {}, 0
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t > 0 and ev.count > 0:
                name = ev.key.split("<")[0].split("::")[-1].split("(")[0].strip()
                out[name] = out.get(name, 0.0) + t / 1e3 / args.iters
                n_ops += ev.count
        return out, n_ops / args.iters

    gen = torch.Generator(device="cuda").manual_seed(3)
    cfg = dbb.DBBConfig(4, 8)
    bf16 = torch.bfloat16
    per_pass = {(kind, m): 0.0 for kind in ("aw", "w") for m in (4, 64)}
    lib_pass = {(kind, lay): 0.0 for kind in ("aw", "w") for lay in ("row", "column")}
    for name, kind, act, k, n in GRANITE:
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        wv, wm, ws = ref.pack_weight_int8(w.to(bf16), cfg)
        del w
        x = torch.randn((64, k), generator=gen, device="cuda").to(bf16)
        if kind == "aw":
            xv, xm, xs = ops.dap_pack_int8(x, 4, 8, act_scale="per_row")
            x_dense = ref.decode_a(xv, xm, cfg) if args.library else None
        else:
            if name == "wo":
                x = apply_dap(x, DAPSpec(4, 8))
            xq, xs = ref.quantize_act_int8(x, per_row=True)
            x_dense = xq
        count = 1 if name == "lm_head" else N_LAYERS
        for m in (4, 64):
            if kind == "aw":
                fn = lambda: dbb_matmul.dbb_matmul_aw_int8_cuda(  # noqa: E731
                    xv[:m], xm[:m], xs[:m], wv, wm, ws, cfg, cfg, act=act, out_dtype=bf16)
            else:
                fn = lambda: dbb_matmul.dbb_matmul_int8_cuda(  # noqa: E731
                    xq[:m], xs[:m], wv, wm, ws, cfg, act=act, out_dtype=bf16)
            ms = time_ms(fn)
            parts, n_ops = device_ops(fn)
            per_pass[(kind, m)] += count * ms
            plan_s = (f" plan {dbb_matmul.int8_plan(m, k, n)}"
                      if hasattr(dbb_matmul, "int8_plan") else "")
            split = ", ".join(f"{kname} {t:.4f}" for kname, t in sorted(parts.items()))
            kname = "dbb_matmul_aw_int8" if kind == "aw" else "dbb_matmul_int8"
            lib = ""
            if args.library and m == 64:
                w_dense = ref.decode_w(wv, wm, cfg)
                w_cm = w_dense.t().contiguous().t()
                t_rm = time_ms(lambda: torch._int_mm(x_dense[:m], w_dense))
                t_cm = time_ms(lambda: torch._int_mm(x_dense[:m], w_cm))
                lib_pass[(kind, "row")] += count * t_rm
                lib_pass[(kind, "column")] += count * t_cm
                lib = f"; _int_mm weight row-major {t_rm:.4f}, column-major {t_cm:.4f}"
                del w_dense, w_cm
            print(f"{args.label}: {kname} {name} M={m} K={k} N={n}{plan_s}: {ms:.4f} ms "
                  f"(warm, {n_ops:g} device operations a call: {split}){lib}", flush=True)
        del wv, wm, ws, x, x_dense
        torch.cuda.empty_cache()
    for m in (64, 4):
        print(f"{args.label}: per granite-3-8b pass M={m}: dbb_matmul_aw_int8 "
              f"{per_pass[('aw', m)]:.4f} ms, dbb_matmul_int8 {per_pass[('w', m)]:.4f} ms",
              flush=True)
    if args.library:
        for kind, kname in (("aw", "dbb_matmul_aw_int8"), ("w", "dbb_matmul_int8")):
            print(f"{args.label}: per granite-3-8b pass M=64, _int_mm on {kname}'s shapes: "
                  f"weight row-major {lib_pass[(kind, 'row')]:.4f} ms, column-major "
                  f"{lib_pass[(kind, 'column')]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device time of the native-wire DBB matmuls (kernels #1 and #4) at the
shapes a serving step gives them, for one checkout of the port.

    python3 scripts/bench_native_matmul.py [--root DIR] [--label NAME] [--iters 30]
        [--arch minicpm3|granite-moe|both] [--plan-blocks N] [--bn 64|128]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts compare in one call: run it once per checkout, in turns.  For
each bf16 linear of minicpm3-4b (q_down, kv_down, q_up, wo, gate, up,
down, lm_head) and/or granite-moe-1b-a400m (wq, wk, wv, wo, lm_head), at
M = 4 (a decode step) and M = 64 (a mixed step), DAP-pruned inputs as on
the main path, it prints:

- the median device time of one call, CUDA events, cold L2 (a 256 MB
  write before each call), as ``chip_smoke.py`` times it;
- the device time of each CUDA kernel the call launched, by name, from
  ``torch.profiler`` over ``--iters`` warm calls: the matmul body apart
  from a split-K reduce launch where there is one.

Then one line per architecture with the per-pass sums at M = 64 and M = 4
(each linear times its launches per forward pass: one per layer, one for
the head), the figure ``chip_smoke.py`` records for minicpm3-4b.
``--plan-blocks`` sets ``dbb_matmul.PLAN_BLOCKS`` and ``--bn`` forces the
tile width of the launch plan, for this run, to measure the choice (a
checkout without a launch plan ignores both).
"""

import argparse
import math
import statistics
import sys
from pathlib import Path

# (name, kernel, activation, DAP-pruned input, K, N), as chip_smoke.py
MINICPM3 = (
    ("q_down", "aw", None, True, 2560, 768),
    ("kv_down", "aw", None, True, 2560, 288),
    ("q_up", "w", None, True, 768, 3840),
    ("wo", "w", None, True, 2560, 2560),
    ("gate", "aw", "silu", True, 2560, 6400),
    ("up", "aw", None, True, 2560, 6400),
    ("down", "aw", None, True, 6400, 2560),
    ("lm_head", "w", None, False, 2560, 73472),
)
GRANITE_MOE = (
    ("wq", "aw", None, True, 1024, 1024),
    ("wk", "aw", None, True, 1024, 512),
    ("wv", "aw", None, True, 1024, 512),
    ("wo", "w", None, True, 1024, 1024),
    ("lm_head", "w", None, False, 1024, 49408),
)
ARCHS = {"minicpm3": ("minicpm3-4b", 62, MINICPM3),
         "granite-moe": ("granite-moe-1b-a400m", 24, GRANITE_MOE)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--arch", default="minicpm3", choices=("minicpm3", "granite-moe", "both"))
    ap.add_argument("--plan-blocks", type=int, default=None)
    ap.add_argument("--bn", type=int, default=None, choices=(64, 128))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_native_matmul: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.core import dbb
    from repro_torch.core.dap import DAPSpec, apply_dap
    from repro_torch.kernels import dbb_matmul, ops

    if hasattr(dbb_matmul, "native_plan"):
        if args.plan_blocks is not None:
            dbb_matmul.PLAN_BLOCKS = args.plan_blocks
        if args.bn is not None:
            base_plan = dbb_matmul.native_plan
            dbb_matmul.native_plan = lambda k, n: (args.bn,) + base_plan(k, n)[1:]
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

    def kernel_ms(fn):
        """Device ms per call of each CUDA kernel ``fn`` launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t > 0 and ev.count > 0:
                name = ev.key.split("<")[0].split("::")[-1]
                out[name] = out.get(name, 0.0) + t / 1e3 / args.iters
        return out

    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg = dbb.DBBConfig(4, 8)
    bf16 = torch.bfloat16
    for key in (("minicpm3", "granite-moe") if args.arch == "both" else (args.arch,)):
        arch, n_layers, linears = ARCHS[key]
        per_pass = {(kind, m): 0.0 for kind in ("aw", "w") for m in (4, 64)}
        for name, kind, act, dap, k, n in linears:
            w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(bf16)
            wv, wm = ops.pack_weight(w, cfg)
            del w
            x = torch.randn((64, k), generator=gen, device="cuda").to(bf16)
            if dap:
                x = apply_dap(x, DAPSpec(4, 8))
            xv, xm = ops.dap_pack(x, 4, 8)
            count = 1 if name == "lm_head" else n_layers
            for m in (4, 64):
                if kind == "aw":
                    fn = lambda: dbb_matmul.dbb_matmul_aw_cuda(  # noqa: E731
                        xv[:m], xm[:m], wv, wm, cfg, cfg, act=act, out_dtype=bf16)
                else:
                    fn = lambda: dbb_matmul.dbb_matmul_cuda(  # noqa: E731
                        x[:m], wv, wm, cfg, act=act, out_dtype=bf16)
                ms = time_ms(fn)
                parts = kernel_ms(fn)
                per_pass[(kind, m)] += count * ms
                plan_s = (f" plan {dbb_matmul.native_plan(k, n)}"
                          if hasattr(dbb_matmul, "native_plan") else "")
                split = ", ".join(f"{kname} {t:.4f}" for kname, t in sorted(parts.items()))
                kname = "dbb_matmul_aw" if kind == "aw" else "dbb_matmul"
                print(f"{args.label}: {kname} {arch} {name} M={m} K={k} N={n}{plan_s}: "
                      f"{ms:.4f} ms (warm, by kernel: {split})", flush=True)
            del wv, wm, x, xv, xm
            torch.cuda.empty_cache()
        for m in (64, 4):
            print(f"{args.label}: per {arch} pass M={m}: dbb_matmul_aw "
                  f"{per_pass[('aw', m)]:.4f} ms, dbb_matmul {per_pass[('w', m)]:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device time of DAP (kernel #5) in each of its four forms at every call
site of the three served paths, beside the chain of operations each form
replaced on the card, for this checkout of the port.

    python3 scripts/bench_dap.py [--root DIR] [--label NAME] [--iters 20]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
variant of the kernel (a copy of ``src/`` with its source or its launch
plan, ``dap_prune.row_plan``, edited) times beside it in one call.

For each call site (granite-3-8b on the int8 wire: the attention, MLP and
down inputs packed (``dap_pack_int8``), wo's input pruned and quantized
(``dap_prune_int8``); minicpm3-4b and granite-moe-1b-a400m on the native
wire: the packed inputs (``dap_pack``) and the dense-input linears' and
the MoE input's pruning (``dap_prune``)), at M = 4 (a decode step) and
M = 64 (a mixed step), bf16, NNZ 4, it prints:

- the median device time of one kernel call, CUDA events, cold L2 (a
  256 MB write before each call), as ``chip_smoke.py`` times it;
- the same for the chain the form replaced on the card: the plain packers
  (``dbb.pack_bitmask``, ``pack_bitmask_int8``) for the packed forms, #5's
  dense form and then the plain per-row quantize for ``dap_prune_int8``
  (``dap_prune`` replaced nothing and has no chain);
- the device operations one call makes, kernel and chain, from
  ``torch.profiler`` over warm calls;
- the bytes bound: each input read once and each output written once
  over 3.35 TB/s.

Then, per forward pass of each arch (each site times its calls a pass),
the kernel's and the chain's device time and device operations, and the
per-row forms' launch plans (``dap_prune.row_plan``) at granite-3-8b's
widths.
"""

import argparse
import statistics
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# (arch, form, K, calls a forward pass, call site)
SITES = (
    ("granite-3-8b", "dap_pack_int8", 4096, 80, "attention and MLP inputs"),
    ("granite-3-8b", "dap_pack_int8", 12800, 40, "down input"),
    ("granite-3-8b", "dap_prune_int8", 4096, 40, "wo input"),
    ("minicpm3-4b", "dap_pack", 2560, 124, "attention and MLP inputs"),
    ("minicpm3-4b", "dap_pack", 6400, 62, "down input"),
    ("minicpm3-4b", "dap_prune", 768, 62, "q_up input"),
    ("minicpm3-4b", "dap_prune", 2560, 62, "wo input"),
    ("granite-moe-1b-a400m", "dap_pack", 1024, 24, "attention input"),
    ("granite-moe-1b-a400m", "dap_prune", 1024, 48, "wo and MoE inputs"),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_dap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import dap_prune, native, ref

    native.build_all(["dap_prune"])
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
        """Device operations (kernels, memsets, copies) one call makes."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        n = 0
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t > 0:
                n += ev.count
        return n / 5

    kernels = {"dap_prune": dap_prune.dap_prune_cuda, "dap_pack": dap_prune.dap_pack_cuda,
               "dap_prune_int8": dap_prune.dap_prune_int8_cuda,
               "dap_pack_int8": dap_prune.dap_pack_int8_cuda}
    chains = {
        "dap_pack": lambda x: ref.dap_pack_ref(x, 4),
        "dap_pack_int8": lambda x: ref.dap_pack_int8_ref(x, 4),
        "dap_prune_int8": lambda x: ref.quantize_act_int8(
            dap_prune.dap_prune_cuda(x, 4)[0], per_row=True),
    }
    gen = torch.Generator(device="cuda").manual_seed(4)
    inputs = {}
    sums = {}
    for arch, form, k, count, site in SITES:
        if k not in inputs:
            inputs[k] = torch.randn((64, k), generator=gen, device="cuda").to(torch.bfloat16)
        for m in (4, 64):
            x = inputs[k][:m]
            kern = lambda: kernels[form](x, 4)  # noqa: E731
            out = kern()
            nbytes = x.numel() * 2 + sum(t.numel() * t.element_size() for t in out)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            t_k, n_k = time_ms(kern), device_ops(kern)
            t_c, n_c = t_k, n_k
            line = ""
            if form in chains:
                chain = lambda: chains[form](x)  # noqa: E731
                t_c, n_c = time_ms(chain), device_ops(chain)
                line = f"; the chain it replaced {t_c:.4f} ms, {n_c:g} device operations"
            print(f"{args.label}: {form} {arch} {site} M={m} K={k}: kernel {t_k:.4f} ms, "
                  f"{n_k:g} device operations a call{line}; bound {bound:.5f} ms (bytes)",
                  flush=True)
            s = sums.setdefault((arch, m), [0.0, 0.0, 0.0, 0.0, 0.0])
            for i, v in enumerate((t_k, t_c, n_k, n_c, bound)):
                s[i] += count * v
    for (arch, m), (t_k, t_c, n_k, n_c, bound) in sums.items():
        print(f"{args.label}: DAP per {arch} pass M={m}: kernel {t_k:.4f} ms in {n_k:g} device "
              f"operations; the chains before {t_c:.4f} ms in {n_c:g}; bound {bound:.4f} ms",
              flush=True)

    for m in (4, 64):
        plans = [f"K={k} {dap_prune.row_plan(m, k)}" for k in (4096, 12800)]
        print(f"{args.label}: per-row plans (cluster, threads, per, per_block) at M={m}: "
              f"{', '.join(plans)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

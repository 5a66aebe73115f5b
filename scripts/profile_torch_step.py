#!/usr/bin/env python3
"""Where one serving step of the PyTorch port spends its time, on the GPU.

    python3 scripts/profile_torch_step.py [--arch granite_3_8b] [--wire int8]
        [--kv int8] [--layers N] [--iters 5]

Builds a full-width model (seeded random weights in bf16; granite-3-8b
on the int8 DBB wire with int8 KV by default, or e.g. ``--arch
minicpm3_4b --wire native --kv native``; ``--layers`` cuts the depth) and
times two steps of
``lm.paged_step`` with a warm cache: a mixed step (4 rows x 16 tokens, the
main path's prefill chunk) and a decode step (4 rows x 1 token).  The
recurrent families (``--arch mamba2_130m`` or ``hymba_1_5b``), which serve
stepped over the ring cache, time one ``lm.decode_step`` of 8 rows at
position 64 instead (``chip_smoke.py``'s stepped serve, its 64 prompt
tokens stepped in first).  For each
it prints the wall time per step (host clock around a synchronized step),
then profiles one step with ``torch.profiler``: the device time summed
over kernels, the number of kernel launches, the device's idle share of
the step, and the kernels that take the most device time.
"""

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def profile(args, cfg, name, step):
    """Wall per step over ``args.iters`` steps, then one profiled step:
    device busy, kernel launches, idle share, the costliest kernels."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"{args.arch} {args.wire} wire {args.kv} KV {name} ({cfg.n_layers} layers): wall "
          f"{wall_ms:.2f} ms/step; profiled step wall {prof_wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms over {len(kernels)} kernels, idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t:8.3f} ms {n:6d} x  {kname[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--wire", default="int8", choices=("native", "int8"))
    ap.add_argument("--kv", default="int8", choices=("native", "int8"))
    ap.add_argument("--layers", type=int, default=None, help="default: the full depth")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import native
    from repro_torch.models import lm
    from repro_torch.serve import paged_cache

    native.build_all()
    cfg = configs.get_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    # the engine's effective settings: per-row activation scales on the int8 wire
    sp = dataclasses.replace(cfg.sparsity, kv_dtype=args.kv)
    if args.wire == "int8":
        sp = dataclasses.replace(sp, act_scale="per_row")
    cfg = dataclasses.replace(cfg, sparsity=sp)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                            wire_dtype=args.wire)
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.family in lm.RECURRENT_FAMILIES:
        b, s0 = 8, 64
        cache = lm.make_cache(cfg, b, s0 + 32, "cuda")
        toks = torch.randint(0, cfg.vocab, (b, s0 + 1), generator=gen, device="cuda").to(
            torch.int32)
        for t in range(s0):
            lm.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        # the step at position s0, repeated (the state moves on; the work does not)
        step = lambda: lm.decode_step(params, cache, toks[:, s0:], s0, cfg)  # noqa: E731
        profile(args, cfg, f"stepped {b}x1", step)
        return 0
    b, ps, p_cnt = 4, 16, 64
    cache = paged_cache.make_paged_cache(cfg, b * p_cnt + 1, ps, "cuda")
    tables = (torch.arange(b * p_cnt, dtype=torch.int32, device="cuda") + 1).reshape(b, p_cnt)
    # fill 256 positions per row, as a mid-prompt mixed step would find them
    for c in range(16):
        pos = (torch.arange(16, device="cuda") + 16 * c).repeat(b, 1).to(torch.int32)
        toks = torch.randint(0, cfg.vocab, (b, 16), generator=gen, device="cuda").to(torch.int32)
        lm.paged_step(params, cache, toks, pos, tables, cfg)
    torch.cuda.synchronize()
    shapes = {"mixed 4x16": (16, 256), "decode 4x1": (1, 272)}
    for name, (s, start) in shapes.items():
        pos = (torch.arange(s, device="cuda") + start).repeat(b, 1).to(torch.int32)
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda").to(torch.int32)
        step = lambda: lm.paged_step(params, cache, toks, pos, tables, cfg)  # noqa: E731
        profile(args, cfg, name, step)
    return 0


if __name__ == "__main__":
    sys.exit(main())

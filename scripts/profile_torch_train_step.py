#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time, on the GPU.

    python3 scripts/profile_torch_train_step.py [--arch granite_moe_1b_a400m]
        [--layers N] [--batch 8] [--seq 512] [--iters 3] [--remat full] [--e2e]

Builds the ``Trainer`` of ``chip_smoke.py``'s ``phase_train`` (full width,
seeded random bf16 weights, the arch's awdbb sparsity with the
straight-through DAP gradient, W-DBB masks at 4/8, AdamW; ``--layers``
cuts the depth) over ``MarkovLM(2048)`` batches, runs two warm steps, and
prints the wall time per step (host clock around synchronized steps) and
the wall of its parts: the forward and backward (``loss_fn`` and
``torch.autograd.grad``), the optimizer, the mask projections.  Then it
profiles one step with ``torch.profiler``: the device time summed over
kernels, the kernel launches, the device's idle share, and the kernels
that take the most device time; and times the straight-through backward
at one DAP site's shape.  ``--e2e`` takes the model, batch and stream of
``examples/train_e2e_torch.py`` instead (its ~110M-parameter default,
f32, ``MarkovLM(8192)``, 8 x 256) and also times the steps fed through a
``Prefetcher``, as the example feeds them.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_moe_1b_a400m")
    ap.add_argument("--layers", type=int, default=None, help="default: the full depth")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--remat", default=None, choices=("none", "full", "dots"))
    ap.add_argument("--e2e", action="store_true",
                    help="examples/train_e2e_torch.py's model, batch and stream instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train_step: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import configs
    from repro_torch.core import dbb, schedule, tree
    from repro_torch.core.dap import selection_mask
    from repro_torch.data.pipeline import MarkovLM, Prefetcher
    from repro_torch.kernels import native, ops
    from repro_torch.train import optimizer, train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    native.build_all()
    vocab = 2048
    if args.e2e:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "train_e2e_torch", ROOT / "examples" / "train_e2e_torch.py")
        e2e = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(e2e)
        cfg, args.batch, args.seq = e2e.model_config(False)
        args.arch, vocab = "train_e2e", cfg.vocab
    else:
        cfg = configs.get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.remat is not None:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    data = MarkovLM(vocab, args.batch, args.seq, seed=0)
    sched = schedule.WDBBSchedule(dbb.DBBConfig(4, 8), begin_step=0, end_step=1, update_every=1)
    tr = Trainer(cfg, optimizer.OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=100),
                 TrainerConfig(log_every=0, wdbb=sched), data,
                 torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tr.run(2)
    card = torch.cuda.get_device_name(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(args.iters)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.iters
    tok = args.batch * args.seq
    print(f"{args.arch} ({cfg.n_layers} layers, remat {cfg.remat}, batch {args.batch} x "
          f"{args.seq}) on {card}: wall {wall * 1e3:.1f} ms/step, {tok / wall:.1f} tokens/s")
    if args.e2e:  # the same steps, the batches drawn by a Prefetcher's thread
        tr.data = Prefetcher(MarkovLM(vocab, args.batch, args.seq, seed=1))
        try:
            hist = tr.run(args.iters + 1)[1:]
        finally:
            tr.data.close()
            tr.data = data
        steps = sorted(h["step_time"] for h in hist)
        print(f"through a Prefetcher: step time (the step alone, synchronized) median "
              f"{steps[len(steps) // 2] * 1e3:.1f} ms, min {steps[0] * 1e3:.1f} ms")

    # the step's parts, each synchronized
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t) * 1e3
        return out

    flat = tree.leaves(tr.params)
    req = [p.detach().requires_grad_(True) for p in flat]
    loss, _ = timed("forward", lambda: train_step.loss_fn(tree.unflatten(tr.params, req), batch,
                                                          cfg))
    grads = timed("backward", lambda: torch.autograd.grad(loss, req))
    grads = tree.unflatten(tr.params, list(grads))
    del req, loss
    grads = timed("mask grads", lambda: train_step._masked(grads, tr.masks))
    new = timed("optimizer", lambda: optimizer.update(tr.opt_cfg, grads, tr.opt_state, tr.params))
    timed("mask params", lambda: train_step._masked(new[0], tr.masks))
    del grads, new
    print("parts (ms, host clock, synchronized): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profiled step: wall {prof_wall_ms:.1f} ms, device busy {busy_ms:.1f} ms over "
          f"{len(kernels)} kernels, idle share {1 - busy_ms / prof_wall_ms:.3f}")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"  {t:8.3f} ms {n:6d} x  {kname[:110]}")

    # the straight-through backward at one DAP site's shape
    x = torch.randn((tok, cfg.d_model), device="cuda").to(torch.bfloat16)
    g = torch.randn_like(x)
    pruned = ops.dap_prune(x, 4, 8)[0]
    for _ in range(3):
        torch.where(selection_mask(x, pruned, 4, 8), g, torch.zeros_like(g))
    with torch.profiler.profile(activities=acts) as prof:
        torch.where(selection_mask(x, pruned, 4, 8), g, torch.zeros_like(g))
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"STE backward at [{tok}, {cfg.d_model}] bf16: {len(ks)} kernels, "
          f"{sum(e.time_range.elapsed_us() for e in ks) / 1e3:.3f} ms device: "
          + "; ".join(f"{e.name[:60]} {e.time_range.elapsed_us():.1f} us" for e in ks))


if __name__ == "__main__":
    main()

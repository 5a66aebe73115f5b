#!/usr/bin/env python3
"""The SSD duality of mamba2-130m at full width, and why DAP breaks it.

    python3 scripts/ssd_duality.py [--prompt 512] [--device cuda] [--smoke]

Builds mamba2-130m (24 layers, d 768, seeded random weights, f32, packed
on the native DBB wire) and runs one seeded prompt two ways: ``lm.forward``
(the chunked SSD scan) and one ``lm.decode_step`` a token (the O(1)
recurrence).  It prints the largest logit difference of the two under
``wdbb`` (weights DBB, dense activations) and under ``awdbb`` (DAP, the
top 4 of every 8 activations, before every mixer projection).

Under ``awdbb`` it also records every DAP call of both runs and compares
the blocks each kept, call site by call site in layer order: how many
blocks kept other values, and for the first site where any did, how far
apart the two runs' inputs to DAP were there against the gap between the
4th and 5th largest magnitude of each flipped block.  A flip whose gap is
within the input difference is a near-tie that the two runs' rounding
decided differently.  ``--smoke`` runs the smoke config instead, and
``--device cpu`` runs on the host (the plain versions, not the kernels).
"""

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def run(lm, ops, params, cfg, prompt, device):
    """(chunked logits, stepped logits, the chunked run's DAP calls, the
    stepped run's) of ``prompt``: each call recorded as (input, kept-block
    masks), both ``[rows, ...]``."""
    orig = ops.dap_prune
    fwd, steps = [], []
    sink = [fwd]

    def recorded(x, nnz, bz=8):
        out = orig(x, nnz, bz)
        sink[0].append((x.detach().reshape(-1, x.shape[-1]).clone(),
                        out[1].reshape(-1, x.shape[-1] // bz).clone()))
        return out

    ops.dap_prune = recorded
    try:
        full = lm.forward(params, prompt, cfg)
        sink[0] = steps
        cache = lm.make_cache(cfg, 1, prompt.shape[1], device)
        out = []
        for t in range(prompt.shape[1]):
            lg, cache = lm.decode_step(params, cache, prompt[:, t:t + 1], t, cfg)
            out.append(lg)
    finally:
        ops.dap_prune = orig
    return full, torch.cat(out, dim=1), fwd, steps


def compare_sites(fwd, steps, n_layers, bz):
    """Per DAP call site (in_proj then out_proj of each layer): blocks whose
    kept set differs between the chunked run (``fwd``: one call a site)
    and the stepped run (``steps``: one call a site a token)."""
    sites = len(fwd)
    assert sites == 2 * n_layers, sites
    assert len(steps) == sites * fwd[0][0].shape[0], (len(steps), sites)
    first = None
    total_blocks = total_flips = 0
    for c in range(sites):
        fx, fm = fwd[c]
        sx = torch.cat([steps[t * sites + c][0] for t in range(fx.shape[0])])
        sm = torch.cat([steps[t * sites + c][1] for t in range(fx.shape[0])])
        flips = fm != sm
        n_flip = int(flips.sum())
        total_blocks += flips.numel()
        total_flips += n_flip
        if n_flip and first is None:
            first = c
            xdiff = (fx - sx).abs()
            rows, blocks = flips.nonzero(as_tuple=True)
            mags = fx.abs().reshape(fx.shape[0], -1, bz)[rows, blocks]
            top = mags.sort(dim=-1, descending=True).values
            gap = top[:, 3] - top[:, 4]  # 4th largest minus 5th largest magnitude
            # the two runs' input difference within each flipped block
            near = xdiff.reshape(fx.shape[0], -1, bz)[rows, blocks].amax(dim=-1)
            print(f"first site with a flip: layer {c // 2} {('in_proj', 'out_proj')[c % 2]} "
                  f"input: {n_flip} of {flips.numel()} blocks kept other values, on "
                  f"{int(flips.any(dim=-1).sum())} of {fx.shape[0]} tokens; the runs' inputs "
                  f"differ there by at most {xdiff.max().item():.3g} (largest |x| "
                  f"{fx.abs().max().item():.3g}); the flipped blocks' 4th-5th magnitude gap: "
                  f"max {gap.max().item():.3g}, median {gap.median().item():.3g}; "
                  f"{int((gap <= near).sum())} of {n_flip} within their block's input "
                  f"difference")
            prev = [(fwd[i][0] - torch.cat([steps[t * sites + i][0]
                                             for t in range(fx.shape[0])])).abs().max().item()
                    for i in range(c)]
            if prev:
                print(f"  the {c} sites before it: no flip, inputs differ by at most "
                      f"{max(prev):.3g}")
    print(f"all {sites} sites: {total_flips} of {total_blocks} blocks kept other values")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt", type=int, default=512, help="prompt tokens (chunks of 256)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true", help="the smoke config (CPU checks)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ssd_duality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import native, ops
    from repro_torch.models import lm

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        native.build_all()
        card = torch.cuda.get_device_name(0)
    else:
        card = "host CPU"
    base = configs.get_config("mamba2_130m", smoke=args.smoke)
    base = dataclasses.replace(base, dtype="float32")
    prompt = torch.tensor(np.random.default_rng(9).integers(0, base.vocab, (1, args.prompt)),
                          dtype=torch.int32, device=args.device)
    for mode in ("wdbb", "awdbb"):
        cfg = dataclasses.replace(base, sparsity=dataclasses.replace(base.sparsity, mode=mode))
        params = lm.init_params(cfg, torch.Generator(device=args.device).manual_seed(0),
                                args.device, wire_dtype="native")
        full, stepped, fwd, steps = run(lm, ops, params, cfg, prompt, args.device)
        v = cfg.vocab
        diff = (full - stepped)[..., :v].abs().max().item()
        scale = full[..., :v].abs().max().item()
        print(f"mamba2 {cfg.name} f32 native wire {mode}, {args.prompt} tokens (chunks of "
              f"{cfg.ssm.chunk}), {card}: max |dlogit| {diff:.3g}, largest |logit| {scale:.3g} "
              f"({diff / scale:.3g} of the scale); {len(fwd)} DAP calls chunked, "
              f"{len(steps)} stepped")
        if mode == "awdbb":
            compare_sites(fwd, steps, cfg.n_layers, cfg.sparsity.bz)
        del params, fwd, steps
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher (port of ``repro.launch.serve``): batched greedy
generation, optionally over DBB-packed weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_8b \\
        --smoke --batch 4 --prompt-len 16 --gen 32 --pack [--device cpu]

Serves on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.trainer import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--pack", action="store_true",
                    help="serve with DBB-packed (compressed) weights")
    ap.add_argument("--sparsity", default="awdbb")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, smoke=args.smoke, sparsity_mode=args.sparsity)
    if cfg.family == "encdec":
        raise SystemExit("use the LM archs for this launcher")
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                            wire_dtype=None)
    engine = Engine(params, cfg, ServeConfig(max_seq=args.prompt_len + args.gen + 8,
                                             pack_weights=args.pack), device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) packed={args.pack}")
    print("sample:", out[0, :24].tolist())
    return out


if __name__ == "__main__":
    main()

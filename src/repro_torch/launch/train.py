"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt [--device cpu]

Trains on the card unless ``--device cpu`` is given: the W-DBB schedule
(``--wdbb-end``), DAP training (the arch's sparsity, or ``--sparsity``),
checkpoint and restart.  The stream's vocabulary is capped at 2048, as
the reference's launcher caps it (a Markov table is vocab x vocab in
float64).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.core import dbb
from repro_torch.core.schedule import WDBBSchedule
from repro_torch.data.pipeline import MarkovLM, Prefetcher
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sparsity", default=None, help="dense|wdbb|awdbb")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--wdbb-end", type=int, default=None,
                    help="enable progressive W-DBB pruning ending this step")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, smoke=args.smoke, sparsity_mode=args.sparsity)
    cfg = dataclasses.replace(cfg, vocab=min(cfg.vocab, 2048))
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} family={cfg.family} sparsity={cfg.sparsity.mode} "
          f"params~{cfg.param_count() / 1e6:.1f}M device={where}")

    data = Prefetcher(MarkovLM(cfg.vocab, args.batch, args.seq, seed=0))
    wdbb = None
    if args.wdbb_end:
        wdbb = WDBBSchedule(target=dbb.DBBConfig(cfg.sparsity.w_nnz, cfg.sparsity.bz),
                            begin_step=0, end_step=args.wdbb_end, update_every=10)
    try:
        trainer = Trainer(
            cfg,
            OptimizerConfig(lr=args.lr, warmup_steps=max(10, args.steps // 10),
                            total_steps=args.steps),
            TrainerConfig(total_steps=args.steps, log_every=10, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, wdbb=wdbb),
            data, device=device,
        )
        hist = trainer.run(args.steps)
    finally:
        data.close()
    print(f"final loss {hist[-1]['loss']:.4f} acc {hist[-1]['acc']:.3f}")
    return hist


if __name__ == "__main__":
    main()

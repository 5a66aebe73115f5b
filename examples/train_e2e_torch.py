"""End-to-end training on the PyTorch port: a ~110M-parameter GQA
transformer trained for a few hundred steps on the synthetic Markov LM
stream, with the paper's full DBB workflow: dense warmup -> progressive
W-DBB pruning -> joint A/W-DBB (DAP) training -> checkpoint -> resume.

    PYTHONPATH=src python examples/train_e2e_torch.py --steps 300
    PYTHONPATH=src python examples/train_e2e_torch.py --tiny --steps 60 --device cpu

Runs on the card unless ``--device cpu`` is given (and raises without
one); DAP is kernel #5's dense form there.  ``--tiny`` shrinks the model
(granite's smoke config, vocabulary 256); the default config is ~110M
parameters (granite family: 12L x d768 x ff2048, vocabulary 8192), f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch import configs
from repro_torch.core import dbb
from repro_torch.core.schedule import WDBBSchedule
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import MarkovLM, Prefetcher
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, resolve_device


def model_config(tiny: bool):
    """``(cfg, batch, seq)`` of the example."""
    if tiny:
        cfg = configs.get_config("granite_3_8b", smoke=True)
        return dataclasses.replace(cfg, vocab=256, dtype="float32"), 8, 64
    cfg = dataclasses.replace(
        configs.get_config("granite_3_8b", smoke=True),
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab=8192,
        dtype="float32", sparsity=SparsityConfig(mode="awdbb", w_nnz=4, a_nnz=4),
    )
    return cfg, 8, 256


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, batch, seq = model_config(args.tiny)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"model: {cfg.n_layers}L d{cfg.d_model} ~{cfg.param_count() / 1e6:.0f}M params, "
          f"sparsity={cfg.sparsity.mode}, device={where}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_e2e_")
    wdbb = WDBBSchedule(
        target=dbb.DBBConfig(cfg.sparsity.w_nnz, cfg.sparsity.bz),
        begin_step=args.steps // 10,
        end_step=args.steps // 2,
        update_every=10,
    )
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=args.steps // 10, total_steps=args.steps)
    data = Prefetcher(MarkovLM(cfg.vocab, batch, seq, seed=0))
    try:
        trainer = Trainer(
            cfg, opt_cfg,
            TrainerConfig(total_steps=args.steps, log_every=max(1, args.steps // 15),
                          ckpt_every=args.steps // 2, ckpt_dir=ckpt_dir, wdbb=wdbb),
            data, device=device,
        )
        hist = trainer.run(args.steps)
    finally:
        data.close()
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # the W-DBB bound holds on the trained weights
    w = trainer.params["layers"][0]["mlp"]["up"]["w"]
    ok = bool(dbb.satisfies(w.transpose(-2, -1),
                            dbb.DBBConfig(cfg.sparsity.w_nnz, cfg.sparsity.bz)))
    print("W-DBB bound on trained weights:", ok)

    # resume from the checkpoint (a simulated preemption recovery)
    data2 = Prefetcher(MarkovLM(cfg.vocab, batch, seq, seed=0))
    try:
        t2 = Trainer(cfg, opt_cfg,
                     TrainerConfig(total_steps=args.steps, log_every=0, ckpt_dir=ckpt_dir),
                     data2, device=device)
    finally:
        data2.close()
    print(f"restart recovered step {t2.step} from {ckpt_dir}")
    return dict(history=hist, wdbb_ok=ok, resumed_step=t2.step)


if __name__ == "__main__":
    main()

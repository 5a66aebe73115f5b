"""Host-side training loop (port of ``repro.train.trainer``): data, the
W-DBB pruning schedule, checkpoints, the step timer and preemption-safe
resume, on one device.

``Trainer(cfg, opt_cfg, tcfg, data_it, generator=None, device=None,
params=None)`` trains on ``"cuda"`` unless the caller passes
``device="cpu"``, and raises without a card (as ``Engine`` does).  Its
parameters are drawn from ``generator`` by ``lm.init_params(...,
wire_dtype=None)`` (``encdec.init_params`` for whisper), or handed in
(``convert.params_from_numpy`` of the reference's) and moved to the
device.

A restored trainer, like the reference's, recomputes its W-DBB masks at
the resume step (checkpoints hold params, moments and the data position,
not masks): an uninterrupted run equals a resumed one when the resume
step is a mask-refresh step or no schedule is set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import schedule as wdbb_schedule, tree
from repro_torch.models import encdec, lm
from repro_torch.runtime.monitor import PreemptionGuard, StepTimer
from repro_torch.train import optimizer, train_step as ts


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    wdbb: Optional[wdbb_schedule.WDBBSchedule] = None


def resolve_device(device) -> torch.device:
    """``device``, or ``"cuda"`` when None; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' (--device cpu) to run on "
                               "the CPU with the kernels' plain versions")
        device = "cuda"
    return torch.device(device)


def _to_device(t, device):
    if isinstance(t, torch.Tensor):
        return t.to(device)
    return torch.from_numpy(np.array(t)).to(device)


class Trainer:
    def __init__(self, cfg, opt_cfg: optimizer.OptimizerConfig, tcfg: TrainerConfig, data_it,
                 generator: Optional[torch.Generator] = None, *, device=None, params=None):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.data = data_it
        self.device = resolve_device(device)
        if params is None:
            gen = generator
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(0)
            if cfg.family == "encdec":
                params = encdec.init_params(cfg, gen, self.device)
            else:
                params = lm.init_params(cfg, gen, self.device, wire_dtype=None)
        self.params = tree.tree_map(lambda p: p.to(self.device), params)
        self.opt_state = optimizer.init(self.params)
        self.step = 0
        self.guard = PreemptionGuard()
        self.timer = StepTimer()
        self.masks = None
        self._stepper = ts.make_train_step(cfg, opt_cfg)
        if tcfg.ckpt_dir and ckpt.latest_step(tcfg.ckpt_dir) is not None:
            self.restore()

    # ------------------------------------------------------------- wdbb
    def _refresh_masks(self):
        sched = self.tcfg.wdbb
        if sched is None:
            return
        if not sched.should_update(self.step) and self.masks is not None:
            return
        self.masks = wdbb_schedule.wdbb_masks(self.params, sched.cfg_at(self.step),
                                              predicate=self._prune_predicate)

    @staticmethod
    def _prune_predicate(path: str, w) -> bool:
        """The reference's: spare the embedding, the router and the norms
        (``path`` is ``layers/<i>/...`` for a per-layer leaf)."""
        return not any(s in path for s in ("embed", "router", "norm", "ln"))

    # ------------------------------------------------------------- steps
    def _batch(self, raw: dict) -> dict:
        return {k: _to_device(v, self.device) for k, v in raw.items()}

    def run(self, n_steps: Optional[int] = None):
        """``n_steps`` (or ``total_steps``) steps, stopping early when the
        preemption guard is signalled; returns one metrics dict a step
        (read once a step, the step time included)."""
        n = n_steps if n_steps is not None else self.tcfg.total_steps
        history = []
        target = self.step + n
        while self.step < target and not self.guard.should_stop:
            self._refresh_masks()
            batch = self._batch(next(self.data))
            self.timer.start()
            self.params, self.opt_state, metrics = self._stepper(
                self.params, self.opt_state, batch, self.masks)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time"] = self.timer.stop()
            self.step += 1
            history.append(metrics)
            if self.tcfg.log_every and self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:6d} loss {metrics['loss']:.4f} "
                      f"acc {metrics['acc']:.3f} gnorm {metrics['grad_norm']:.2f} "
                      f"lr {metrics['lr']:.2e} {metrics['step_time'] * 1e3:.0f}ms")
            if self.tcfg.ckpt_dir and self.tcfg.ckpt_every and self.step % self.tcfg.ckpt_every == 0:
                self.save()
        if self.tcfg.ckpt_dir and self.guard.should_stop:
            self.save()  # preemption-safe final checkpoint
        return history

    # -------------------------------------------------------------- ckpt
    def _state(self) -> dict:
        s = self.opt_state
        return {"params": self.params, "opt": {"step": s.step, "mu": s.mu, "nu": s.nu}}

    def save(self):
        ckpt.save(self.tcfg.ckpt_dir, self.step, self._state(),
                  extra={"data_step": getattr(self.data, "_step", self.step)},
                  keep=self.tcfg.keep_ckpts)

    def restore(self):
        """The latest checkpoint back on the trainer's device, ``OptState``
        rebuilt, the data stream ``seek``-ed to the saved position."""
        restored, manifest = ckpt.restore(self.tcfg.ckpt_dir, self._state())
        self.params = tree.tree_map(lambda a: _to_device(a, self.device), restored["params"])
        opt = restored["opt"]
        self.opt_state = optimizer.OptState(
            step=_to_device(opt["step"], "cpu"),
            mu=tree.tree_map(lambda a: _to_device(a, self.device), opt["mu"]),
            nu=tree.tree_map(lambda a: _to_device(a, self.device), opt["nu"]),
        )
        self.step = manifest["step"]
        if hasattr(self.data, "seek"):
            self.data.seek(manifest["extra"].get("data_step", self.step))
        print(f"restored checkpoint at step {self.step}")

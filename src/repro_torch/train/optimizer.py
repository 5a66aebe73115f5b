"""AdamW (decoupled weight decay) with warmup and a cosine schedule (port
of ``repro.train.optimizer``): f32 moments over (possibly bf16) params,
global-norm clipping.

The update runs in f32 in the reference's order and is cast to each
param's dtype.  The reference decays a leaf of rank >= 2, judged on its
*stacked* leaf: every per-layer leaf (norm scales and biases included,
``[L, d]`` there) is decayed, while ``final_norm`` (``[d]``) is not.  The
port's per-layer pieces are judged by that stacked rank, their own plus
one (``core/tree.py``).

``OptState.step`` and the schedule's scalars (learning rate, bias
corrections) live on the CPU and are computed in f32 there, as the
reference computes them in f32; the corrections reach the params' device
as 0-d tensors, so the divisions are true divisions on either device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import tree


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the CPU
    mu: dict
    nu: dict


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to ``min_lr_ratio``
    of it at ``total_steps`` (f32)."""
    step = step.to(torch.float32)
    warm = step / _f32(max(1.0, cfg.warmup_steps))
    decay_steps = _f32(max(1.0, cfg.total_steps - cfg.warmup_steps))
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(_f32(math.pi) * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32),
                    mu=tree.tree_map(zeros, params), nu=tree.tree_map(zeros, params))


def global_norm(t) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32; a stacked group's
    squares summed first, the groups then added in the reference's leaf
    order."""
    sq = []
    for g in tree.groups(t):
        parts = [torch.sum(torch.square(p.float())) for p in g.pieces]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        sq.append(total)
    return torch.sqrt(sum(sq))


def update(cfg: OptimizerConfig, grads, state: OptState, params):
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds
    ``grad_norm`` (on the params' device) and ``lr`` (on the CPU)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(torch.full_like(gnorm, cfg.clip_norm) / (gnorm + 1e-9), 1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.b1), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2), stepf)
    dev = gnorm.device
    lr_d, b1c_d, b2c_d = lr.to(dev), b1c.to(dev), b2c.to(dev)

    def upd(g, m, v, p, decay):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c_d
        vhat = v / b2c_d
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        new_p = pf - lr_d * (delta + decay * pf)
        return new_p.to(p.dtype), m, v

    new_p, new_m, new_v = [], [], []
    for gg, mg, vg, pg in zip(tree.groups(grads), tree.groups(state.mu), tree.groups(state.nu),
                              tree.groups(params)):
        rank = pg.pieces[0].ndim + (1 if pg.stacked else 0)
        decay = cfg.weight_decay if rank >= 2 else 0.0  # no decay on final_norm
        outs = [upd(g, m, v, p, decay)
                for g, m, v, p in zip(gg.pieces, mg.pieces, vg.pieces, pg.pieces)]
        new_p.append([o[0] for o in outs])
        new_m.append([o[1] for o in outs])
        new_v.append([o[2] for o in outs])
    new_state = OptState(step, tree.rebuild(params, new_m), tree.rebuild(params, new_v))
    return tree.rebuild(params, new_p), new_state, {"grad_norm": gnorm, "lr": lr}

"""The paper's accuracy experiment (Table 3, §8.1) on the PyTorch port:
train a small CNN, apply W-DBB, A-DBB (DAP) and both, fine-tune, and
print the accuracy table.

    PYTHONPATH=src python examples/cnn_dap_finetune_torch.py [--device cpu]
        [--steps-base 300] [--steps-ft 150] [--seed 0]

Runs on the card unless ``--device cpu`` is given (and raises without
one).  The procedure is ``examples/cnn_dap_finetune.py``'s, whose code
lives in ``benchmarks/table3_accuracy.py``; it is kept here whole:

  baseline        dense training (SGD, lr 1e-2) on ``SyntheticVision``
  A-DBB 2/8       the baseline evaluated under DAP 2/8, no fine-tune
  W-DBB 4/8       block-local magnitude pruning, then fine-tuning with
                  the masks re-applied after every step (``c1`` excluded)
  A-DBB 4/8       DAP 4/8 with its straight-through gradient, fine-tuned
  A/W-DBB 4/8     both at once; the W-DBB bound is then checked on ``d``

The parameters keep the reference's layout, conv weights HWIO ``[3, 3,
Cin, Cout]`` and ``d`` ``[128, 10]``, so the W-DBB rules block axis -2,
the input channels; activations are NHWC where DAP prunes them (the
channel axis) and where they are flattened before ``d``.  The
convolutions and the dense layer are plain PyTorch, as they are plain XLA
in the reference; DAP is kernel #5's dense form on the card.  TF32 is
off while the CNN runs, so the card computes in f32 as the reference
does.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dbb
from repro_torch.core.dap import dap
from repro_torch.core.schedule import apply_masks, prune_weights, wdbb_masks
from repro_torch.data.pipeline import SyntheticVision
from repro_torch.train.trainer import resolve_device

IMG = (10, 10, 8)
N_CLASSES = 10
CFG_W = dbb.DBBConfig(4, 8)
# the fine-tunes in the reference's order: (row, W-DBB masks, DAP nnz)
FINE_TUNES = (("W-DBB 4/8 +ft", True, None), ("A-DBB 4/8 +ft", False, 4),
              ("A/W-DBB 4/8 +ft", True, 4))


@contextlib.contextmanager
def f32_only():
    """cuDNN and cuBLAS in f32, not TF32, for the block (restored after)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def init_cnn(generator: torch.Generator) -> dict:
    """Seeded weights on the generator's device, the reference's shapes
    and scales."""
    def draw(shape, scale):
        return torch.randn(shape, generator=generator, device=generator.device) * scale

    return {
        "c1": draw((3, 3, IMG[2], 16), 0.2),
        "c2": draw((3, 3, 16, 32), 0.15),
        "d": draw((2 * 2 * 32, N_CLASSES), 0.05),
    }


def _conv_relu_pool(h_nhwc: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 SAME convolution, ReLU, 2x2 max-pool of stride 2 (VALID):
    NHWC in, NCHW out."""
    h = F.conv2d(h_nhwc.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), padding="same")
    return F.max_pool2d(F.relu(h), 2, 2)


def forward(params: dict, x: torch.Tensor, a_nnz: int | None) -> torch.Tensor:
    """``x [B, H, W, C]`` -> logits ``[B, 10]``; DAP on the channel axis
    of the input and of the first pooled map when ``a_nnz`` is given."""
    def maybe_dap(h):
        if a_nnz is not None and h.shape[-1] % 8 == 0:
            return dap(h, a_nnz, 8)
        return h

    with f32_only():
        h = _conv_relu_pool(maybe_dap(x), params["c1"])  # 10 -> 5
        h = maybe_dap(h.permute(0, 2, 3, 1))
        h = _conv_relu_pool(h, params["c2"])  # 5 -> 2
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flattened as (h, w, c)
        return h @ params["d"]


def loss_fn(params: dict, batch: dict, a_nnz: int | None):
    """``(cross entropy, accuracy)`` of one batch, 0-d tensors."""
    logits = forward(params, batch["x"], a_nnz)
    onehot = F.one_hot(batch["y"], N_CLASSES).to(logits.dtype)
    ce = -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * onehot, dim=-1))
    acc = torch.mean((torch.argmax(logits, dim=-1) == batch["y"]).to(torch.float32))
    return ce, acc


def train_step(params: dict, batch: dict, masks: dict | None, a_nnz: int | None = None,
               lr: float = 1e-2):
    """One SGD step, the W-DBB masks re-applied after it when given:
    ``(params, ce, acc)``, the metrics as 0-d tensors (no host sync)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    ce, acc = loss_fn(leaves, batch, a_nnz)
    with f32_only():
        grads = torch.autograd.grad(ce, list(leaves.values()))
    new = {k: (p - lr * g).detach() for (k, p), g in zip(leaves.items(), grads)}
    if masks is not None:
        new = apply_masks(new, masks)
    return new, ce.detach(), acc


def to_batch(raw: dict, device) -> dict:
    """A ``SyntheticVision`` batch on ``device`` (labels as int64)."""
    return {"x": torch.from_numpy(raw["x"]).to(device),
            "y": torch.from_numpy(raw["y"]).to(device=device, dtype=torch.int64)}


def evaluate(params: dict, data, a_nnz: int | None, n: int = 20) -> float:
    """Mean accuracy over the next ``n`` batches of ``data``."""
    device = params["d"].device
    accs = []
    with torch.no_grad():
        for _ in range(n):
            _, acc = loss_fn(params, to_batch(next(data), device), a_nnz)
            accs.append(float(acc))
    return float(np.mean(accs))


def _spare_first_layer(path: str, w) -> bool:
    return "c1" not in path  # paper: the first layer is excluded


def prepare(params: dict, wdbb: bool):
    """A fine-tune's start: ``(params, masks)``, W-DBB pruned with its
    masks when ``wdbb``, else the params as they are and no masks."""
    if not wdbb:
        return dict(params), None
    pruned = prune_weights(params, CFG_W, predicate=_spare_first_layer)
    return pruned, wdbb_masks(pruned, CFG_W, predicate=_spare_first_layer)


def fit(params: dict, data, steps: int, masks: dict | None = None,
        a_nnz: int | None = None) -> dict:
    """``steps`` of :func:`train_step` over the next batches of ``data``."""
    device = params["d"].device
    for _ in range(steps):
        params, _, _ = train_step(params, to_batch(next(data), device), masks, a_nnz)
    return params


def run(steps_base: int = 400, steps_ft: int = 200, seed: int = 0, device=None,
        params: dict | None = None):
    """The Table 3 rows and the joint A/W-DBB delta against the baseline.
    ``params``: the initial weights (``init_cnn`` seeded with ``seed`` on
    ``device`` when None)."""
    device = resolve_device(device)
    data = SyntheticVision(N_CLASSES, IMG, batch=128, seed=seed)
    # held-out split: the same class templates, disjoint noise draws
    test = SyntheticVision(N_CLASSES, IMG, batch=256, seed=seed)
    test._step = 1_000_000
    if params is None:
        params = init_cnn(torch.Generator(device=device).manual_seed(seed))
    params = fit({k: v.to(device) for k, v in params.items()}, data, steps_base)
    base_acc = evaluate(params, test, None)
    rows = [{"config": "baseline (dense)", "acc": round(base_acc, 4)},
            {"config": "A-DBB 2/8 no-finetune", "acc": round(evaluate(params, test, 2), 4)}]
    for name, wdbb, a_nnz in FINE_TUNES:
        p, masks = prepare(params, wdbb)
        p = fit(p, data, steps_ft, masks, a_nnz)
        rows.append({"config": name, "acc": round(evaluate(p, test, a_nnz), 4)})
    # the W-DBB bound holds on the joint fine-tune's weights
    if not bool(dbb.satisfies(p["d"].transpose(-2, -1), CFG_W)):
        raise RuntimeError("W-DBB bound violated on d after the joint fine-tune")
    derived = rows[-1]["acc"] - base_acc
    return rows, derived


def format_table(rows, derived) -> str:
    w = max(len(r["config"]) for r in rows)
    lines = [f"{'config':<{w}}  accuracy"] + [f"{r['config']:<{w}}  {r['acc']:.4f}" for r in rows]
    lines.append(f"\njoint A/W-DBB vs baseline: {derived:+.4f} "
                 "(paper: ~1% loss, recovered by fine-tuning)")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-base", type=int, default=300)
    ap.add_argument("--steps-ft", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows, derived = run(args.steps_base, args.steps_ft, args.seed, device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {where}")
    print(format_table(rows, derived))
    return rows, derived


if __name__ == "__main__":
    main()

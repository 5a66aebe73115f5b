"""Quickstart on the PyTorch port: the DBB structured-sparsity API in six
steps, on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--smoke] [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
one).  ``--smoke`` shrinks the end-to-end model section (fewer layers, a
shorter sequence).  Section 5 launches the native W-DBB matmul (kernel
#1) and holds it against its plain version in ``kernels/ref.py``; under
``--device cpu`` it says it needs the card and runs nothing.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import dbb
from repro_torch.core.dap import dap
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.train.trainer import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- 1. DBB format: bound the non-zeros per 8-wide channel block -------
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).to(device)
    cfg = dbb.DBBConfig(nnz=4, bz=8)  # "4/8" in the paper's notation
    pruned = dbb.prune(x, cfg)  # top-4 magnitude per block
    print("density after 4/8 prune:", float((pruned != 0).float().mean()))
    if not bool(dbb.satisfies(pruned, cfg)):
        raise RuntimeError("prune left a block past its bound")

    # --- 2. Wire format: packed values + positional bitmask (Fig. 5) -------
    vals, mask = dbb.pack_bitmask(x, cfg)
    print("packed shapes:", tuple(vals.shape), tuple(mask.shape), "(vs dense", tuple(x.shape), ")")
    if not torch.equal(dbb.expand_bitmask(vals, mask, cfg), pruned):
        raise RuntimeError("the bitmask wire does not round-trip")

    # --- 3. DAP: dynamic activation pruning with straight-through grads ----
    a = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((dap(a, 4, 8) ** 2).sum(), a)
    print("DAP STE grad nonzeros:", float((grad != 0).float().mean()))  # == density

    # --- 4. The W-DBB matmul: weights stream compressed ---------------------
    w = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)).to(device)
    wv, wm = ops.pack_weight(w, cfg)
    y = ops.dbb_matmul(x, wv, wm, cfg)  # kernel #1 on the card, its plain version on the CPU
    dense_bytes = w.numel() * 4
    packed_bytes = wv.numel() * 4 + wm.numel()
    print(f"weight bytes: dense {dense_bytes} -> packed {packed_bytes} "
          f"({dense_bytes / packed_bytes:.2f}x smaller)")

    # --- 5. The same matmul on the card's kernel, held against ref.py -------
    if device.type == "cuda":
        y_ref = ref.dbb_matmul_ref(x, wv, wm, cfg)
        err = (y - y_ref).abs().max().item()
        if err > 1e-4:
            raise RuntimeError(f"kernel #1 differs from its plain version by {err}")
        print(f"cuda kernel matches plain version: OK (max abs err {err:.3g})")
    else:
        print("cuda kernel check: needs the card (run without --device cpu); skipped")

    # --- 6. A DBB-sparse model end to end -----------------------------------
    cfg_m = configs.get_config("granite_3_8b", smoke=True)  # awdbb by default
    if args.smoke:  # tiny model, short sequence
        cfg_m = dataclasses.replace(cfg_m, vocab=64, d_model=64, d_ff=128, n_layers=2)
    seq = 8 if args.smoke else 32
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(cfg_m, gen, device, wire_dtype=None)
    tokens = torch.from_numpy(rng.integers(0, cfg_m.vocab, size=(2, seq)).astype(np.int64))
    with torch.no_grad():
        logits = lm.forward(params, tokens.to(device), cfg_m)
    if not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError("the model's logits are not finite")
    print("model forward with joint A/W-DBB:", tuple(logits.shape))
    print("quickstart OK")
    return logits


if __name__ == "__main__":
    main()

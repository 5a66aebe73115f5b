"""The bf16 gate's departures, measured (CPU; the JAX reference beside the
port, ``tests/test_torch_bf16_gate.py``'s cases and bound).

For every case of the gate, ``|port - ref_bf16|`` over the compared
logits against the gate's bound, with the reference run five ways:

  * ``gate``: jitted, ``--xla_allow_excess_precision=false``, XLA's
    algebraic simplifier off, LLVM's optimizations off, fused paged
    attention (the gate's own reference);
  * ``fold``: the same with the algebraic simplifier on (it folds the
    int8 scales' ``amax / 127`` into a multiply);
  * ``optimized``: the gate's with LLVM's optimizations on (XLA's
    vectorized f32 sums);
  * ``xla_default``: jitted with XLA's defaults (simplified, optimized,
    and a fusion keeps its bf16 intermediates in f32);
  * ``eager``: op by op (``jax.disable_jit``) with XLA's defaults, every
    bf16 operation rounded as written (a single operation has no fusion
    to keep excess precision in, nor a constant to fold).

The reference engine's own CPU configuration (its gather path, jitted
with XLA's default) is not among them: XLA's CPU runtime refuses a
bf16 x bf16 -> f32 dot on that path ("Unsupported element type for
DotThunk") in some cases.

``n_diff`` counts the logits that differ at all.  Each way runs the
cases in ``--procs`` processes side by side.  Run from the repo root:
``PYTHONPATH=src python scripts/bf16_gate_departures.py [--ways
gate,fold,optimized,xla_default,eager] [--procs 6]`` (eager takes minutes).
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import _torch_bf16_gate as gate  # noqa: E402

WAYS = {
    "gate": dict(),
    "fold": dict(simplify=True),
    "optimized": dict(fast_compile=False),
    "xla_default": dict(excess_precision=True, simplify=True, fast_compile=False),
    "eager": dict(eager=True, excess_precision=True, simplify=True, fast_compile=False),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ways", default=",".join(WAYS))
    ap.add_argument("--procs", type=int, default=6)
    args = ap.parse_args()
    ways = args.ways.split(",")
    groups = [gate.CASES[i::args.procs] for i in range(args.procs)]
    runs = {}
    with tempfile.TemporaryDirectory() as work:
        for way in ways:
            sub = Path(work) / way
            sub.mkdir()
            runs[way] = gate.run_groups(groups, sub, timeout=3000, **WAYS[way])
    print("case | gate's bound (|ref_bf16 - ref_f32|) | "
          + " | ".join(f"{w}: |port - ref_bf16| (n_diff), its own bound" for w in ways)
          + " | positions compared by the gate")
    for case in gate.CASES:
        key = gate.case_key(*case)
        cells = []
        for w in ways:
            got, want, want32 = (runs[w][f"{key}/{side}"] for side in ("port", "ref_bf16",
                                                                     "ref_f32"))
            err, bound, ref_gap, sure = gate.gate_report(got, want, want32)
            if w == ways[0]:
                head = f"{key} | {bound:.4g} ({ref_gap:.4g})"
                tail = f"{int(sure.sum())} of {len(sure)}"
            cells.append(f"{err:.4g} ({int((got != want).sum())}), {bound:.4g}"
                         + (" OVER" if err > bound else ""))
        print(" | ".join([head] + cells + [tail]))


if __name__ == "__main__":
    main()

"""Where a bf16 serving case of the card twin first departs from the CPU
port, site by site (``tests/test_torch_cuda.py::test_bf16_gate_card_twin``).

Runs the case on the CPU, recording every call of the hooked functions
(their tensor inputs and outputs, in call order), then on the card with
each hooked call fed the CPU's recorded inputs and handing on the CPU's
output, so that every site is compared at equal inputs and a difference
never spreads (``_torch_bf16_gate.SiteReplay``).  Hooked: whisper's
sinusoidal table, the layer norms, every linear and inside it DAP, the
kernel wrappers and the dense linear's activation, and attention's
``mha``.  Prints each site whose card output differs (call index, shape,
elements apart, largest difference in ulps of its largest output) and, per
function, the calls that differ; the innermost first site names the
operation.  The card and its power limit first.

Needs a card; run from the repo root:
``python scripts/encdec_card_sites.py [--arch whisper_base] [--wire
native|int8|unpacked] [--kv native|int8]`` (``--device cpu`` replays on
the CPU instead: every site equal, a rehearsal of the hooks).
"""

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import torch  # noqa: E402

import _torch_bf16_gate as gate  # noqa: E402
import test_torch_cuda as twin  # noqa: E402  (the card twin's configs and weights)
from repro_torch.models import encdec, lm  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="whisper_base")
    ap.add_argument("--wire", default="native")
    ap.add_argument("--kv", default="native")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    cfg = twin._gate_twin_cfg(args.arch)
    init = encdec.init_params if cfg.family == "encdec" else lm.init_params
    params = twin._with_biases(init(cfg, torch.Generator().manual_seed(0), "cpu",
                                    wire_dtype=None), 7)
    if (args.arch, args.wire, args.kv) in gate.FAMILY_CASES:
        params = gate.nonzero_extras(params, 8)
    served, scfg = twin._gate_twin_served(params, cfg, args.wire, args.kv)
    sites = gate.SiteReplay(args.device)
    sites.install()
    want, fed = gate.port_run(served, scfg, "cpu")
    sites.replay()
    got, _ = gate.port_run(twin._tree_map(lambda t: t.to(args.device), served), scfg,
                           args.device, fed)
    print(f"{args.arch} {args.wire} wire {args.kv} KV: {len(sites.rec)} hooked calls, "
          f"{len(sites.diffs)} differ at equal inputs; logits (CPU outputs handed on) "
          f"{float(abs(got - want).max()):.4g} apart")
    for i, label, n, worst in sites.diffs[:20]:
        shape = tuple(gate._tensors(sites.rec[i][2])[0].shape)
        print(f"  call {i} {label} {shape}: {n} elements apart, largest {worst:.3g} ulps")
    per = {}
    for label, _, _ in sites.rec:
        per.setdefault(label, [0, 0])[0] += 1
    for _, label, _, _ in sites.diffs:
        per[label][1] += 1
    print("  per function (calls, differing):",
          ", ".join(f"{k} {c} {d}" for k, (c, d) in per.items()))


if __name__ == "__main__":
    main()

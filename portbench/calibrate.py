"""The readings a correctness limit is set from: the program's widest
gap on many seeds, and the control's on some of them, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1] [--seconds 0]

Each seed is a run of the cell (its own weights, engine and rounds; at
``--seconds 0`` one round) whose served tokens the reference compares;
on a control seed the reference is also computed one precision step
below the configuration's (``pb_reference.control``) and read at the
tokens that puts first.  Every seed also reads the served tokens with
one request's answer altered (``pb_harness.reference_gaps``).  Each
reading is held to the cell's limits (``checks/<cell>.json``): one JSON
line a seed, with ``correct`` for the program's tokens and
``control_correct`` and ``fault_correct`` for the others, which a sound
limit reads false.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    import torch

    import pb_harness
    import pb_reference
    import pb_spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = pb_spec.workload(pb_spec.benchmark(), args.workload)
    cfg, mix = pb_spec.config(cell["config"]), pb_spec.traffic(cell["traffic"])
    limits = {k: v["limit"] for k, v in pb_spec.load_json(
        HERE / "checks" / f"{args.workload}.json").items()}

    def correct(readings):
        return all(v <= lim for v, lim in pb_harness.compared(readings, limits).values())

    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(x) for x in args.seeds.split(",")):
        controls = [pb_reference.control(cfg)] if s in ctl else []
        out = pb_harness.run_cell(cfg, mix, s, args.seconds, False, "cuda", limits,
                                  controls=controls, fault_one_request=True)
        line = dict(seed=s, workload=args.workload, attempted=out["attempted"],
                    failed=out["failed"], correct=out["correct"], **out["readings"],
                    checks={k: v[0] for k, v in out["checks"].items()})
        line["fault_correct"] = correct(line["fault_one_request"])
        if controls:
            line["control"] = line.pop("control_0")
            line["control_correct"] = correct(line["control"])
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

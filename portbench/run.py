"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<name>.json``) and traffic mix
(``portbench/traffic/<name>.json``); ``portbench/checks/<cell>.json``
holds the limits of its correctness comparison.  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer ones, read by
``portbench/metrics/<name>.py``.  The last line of standard output is the
result as JSON; the numbers compared, each with its limit, are the last
lines of standard error and the result's last key.  Without a CUDA
device, or with JAX or the JAX package loaded, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch

    import pb_spec

    bench = pb_spec.benchmark(ROOT)
    cell = pb_spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import pb_harness

    cfg = pb_spec.config(cell["config"])
    mix = pb_spec.traffic(cell["traffic"])
    limits = {k: v["limit"] for k, v in pb_spec.load_json(
        HERE / "checks" / f"{args.workload}.json").items()}
    out = pb_harness.run_cell(cfg, mix, args.seed, args.seconds, bool(args.trace), "cuda",
                              limits)
    found = pb_harness.loaded_jax()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 4
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in pb_spec.metrics_for(bench, args.workload, section):
        value = pb_spec.reader(m["name"])(out["data"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = out["device"]
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        sl = out["data"].slice
        if sl is not None and sl.events:
            import pb_trace

            device["busy_s"] = pb_trace.busy_s(sl.events, sl.t0, sl.t1)
            device["window_s"] = sl.t1 - sl.t0
        br = pb_harness.breakdown(out["data"])
        if br:
            result["breakdown"] = br
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

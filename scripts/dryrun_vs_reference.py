"""The port's dry-run beside the reference's, cell by cell, on the CPU.

For each cell the reference's ``repro.launch.dryrun.lower_cell`` runs in a
process of its own (it fixes 512 XLA host devices at import, and lowers
and compiles the cell with GSPMD) and the port's
``repro_torch.launch.dryrun.trace_cell`` in another (its fake process
group is process-global).  Both report one device's program; the script
prints their counts side by side: flops, HBM bytes, collective bytes by
kind and call counts, argument bytes.  The reference's times use its TPU
constants and the port's the H100's, so only the counts are compared.

    PYTHONPATH=src python scripts/dryrun_vs_reference.py [--out DIR]
        [--cell granite_3_8b:decode_32k:single ...]

Each cell's two result dicts go to ``DIR/<cell>.{reference,port}.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the reference fails to lower granite-moe's train_4k under jax 0.9.0; its
# decode_32k is the MoE cell both sides trace
CELLS = ("granite_3_8b:decode_32k:single", "granite_moe_1b_a400m:train_4k:single",
         "granite_moe_1b_a400m:decode_32k:single", "starcoder2_15b:long_500k:single")

_RUN = """
import json, sys
from repro.launch import dryrun
arch, shape, mesh, path = sys.argv[1:5]
json.dump(dryrun.lower_cell(arch, shape, mesh == "multi"), open(path, "w"))
"""
_RUN_PORT = (_RUN.replace("from repro.launch", "from repro_torch.launch")
             .replace("dryrun.lower_cell", "dryrun.trace_cell"))


def _run(code, cell, path, env):
    """``(result dict or None, seconds, the error's last line)``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, *cell.split(":"), path], env=env,
                          capture_output=True, text=True)
    if proc.returncode:
        lines = [ln for ln in proc.stderr.splitlines() if "Error" in ln] or [
            f"exit {proc.returncode}"]
        return None, time.perf_counter() - t0, lines[-1]
    with open(path) as f:
        return json.load(f), time.perf_counter() - t0, ""


def _fmt(x):
    return "-" if x is None else f"{x:.4g}" if isinstance(x, float) else str(x)


def _rows(ref, port):
    """``(count, reference, port)`` rows; ``ref`` None (its lowering
    failed) leaves the reference's column empty."""
    def get(res, *keys):
        for k in keys:
            if res is None:
                return None
            res = res[k]
        return res

    rows = [(name, get(ref, "roofline", key), get(port, "roofline", key)) for name, key in (
        ("flops / device", "flops_per_device"), ("HBM bytes / device", "bytes_per_device"),
        ("collective bytes / device", "collective_bytes_per_device"))]
    for kind in port["roofline"]["coll_breakdown"]:
        def calls(res):
            b = get(res, "roofline", "coll_breakdown", kind)
            return None if b is None else (
                f"{_fmt(float(b))} ({get(res, 'roofline', 'coll_counts', kind)})")
        rows.append((f"  {kind} bytes (calls)", calls(ref), calls(port)))
    rows += [("argument bytes / device", get(ref, "memory", "argument_bytes"),
              get(port, "memory", "argument_bytes")),
             ("model flops / device", get(ref, "model_flops_per_device"),
              get(port, "model_flops_per_device")),
             ("useful / counted flops", get(ref, "useful_flops_ratio"),
              get(port, "useful_flops_ratio")),
             ("bottleneck (own constants)", get(ref, "roofline", "bottleneck"),
              get(port, "roofline", "bottleneck"))]
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", default=None,
                    help="arch:shape:single|multi (default: CELLS)")
    ap.add_argument("--out", default="chiprun_out/dryrun_vs_reference")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    for cell in args.cell or CELLS:
        stem = os.path.join(args.out, cell.replace(":", "_"))
        ref, t_ref, ref_err = _run(_RUN, cell, stem + ".reference.json", env)
        port, t_port, port_err = _run(_RUN_PORT, cell, stem + ".port.json", env)
        if port is None:
            raise SystemExit(f"{cell}: the port's trace failed: {port_err}")
        print(f"\n## {cell} (reference: GSPMD on 512 XLA host devices, {t_ref:.1f} s; "
              f"port: DTensor on a fake group, {t_port:.1f} s; CPU)\n")
        if ref is None:
            print(f"reference failed: {ref_err}\n")
        print("| count | reference | port | port / reference |")
        print("|---|---|---|---|")
        for name, a, b in _rows(ref, port):
            ratio = (f"{b / a:.3g}" if isinstance(a, (int, float)) and isinstance(b, (int, float))
                     and not isinstance(a, bool) and a else "")
            print(f"| {name} | {_fmt(a)} | {_fmt(b)} | {ratio} |")


if __name__ == "__main__":
    main()

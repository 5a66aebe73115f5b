"""Render the roofline table from the dry-run's JSON cells (port of
``repro.launch.report``): one table a mesh, then the worst cells by
roofline fraction and the most collective-bound.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import PEAK_FLOPS


def load_cells(d):
    cells = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_fraction(c):
    """Useful-compute time / bound time: how close the cell would run to
    the compute roofline if the dominant term were eliminated down to the
    useful-FLOPs floor (the H100's ``PEAK_FLOPS``)."""
    r = c["roofline"]
    t_useful = c["model_flops_per_device"] / PEAK_FLOPS
    t_bound = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
    return t_useful / t_bound if t_bound else 0.0


def table(cells, mesh):
    rows = []
    hdr = ("| arch | shape | t_compute | t_memory | t_collective | bottleneck "
           "| useful/HLO | roofline-frac | mem/dev |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for c in cells:
        if c["mesh"] != mesh or c.get("tags"):
            continue
        r = c["roofline"]
        mem = c["memory"]["temp_bytes"] or 0
        arg = c["memory"]["argument_bytes"] or 0
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['t_compute_s'])} "
            f"| {fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} "
            f"| {r['bottleneck']} "
            f"| {c['useful_flops_ratio']:.3f} "
            f"| {roofline_fraction(c):.3f} "
            f"| {(arg+mem)/2**30:.2f} GiB |"
        )
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=None,
                    help="single|multi (default: every mesh the cells hold)")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    meshes = [args.mesh] if args.mesh else sorted({c["mesh"] for c in cells})
    for mesh in meshes:
        print(f"\n## mesh {mesh}\n")
        print(table(cells, mesh))
        # worst cells by roofline fraction / most collective bound
        scored = [
            (roofline_fraction(c), c) for c in cells
            if c["mesh"] == mesh and not c.get("tags")
        ]
        scored.sort(key=lambda x: x[0])
        print("\nworst roofline fraction:")
        for f, c in scored[:5]:
            print(f"  {c['arch']}/{c['shape']}: {f:.4f} ({c['roofline']['bottleneck']})")
        coll = [
            (c["roofline"]["t_collective_s"] / max(1e-12, c["roofline"]["t_compute_s"]), c)
            for _, c in scored
        ]
        coll.sort(key=lambda x: -x[0])
        print("most collective-bound (t_coll / t_comp):")
        for f, c in coll[:5]:
            print(f"  {c['arch']}/{c['shape']}: {f:.2f}x")


if __name__ == "__main__":
    main()

"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` (at the repository root) names each cell's
configuration and traffic mix; the configuration is
``configs/<name>.json``, the mix ``traffic/<name>.json`` and each metric's
reader ``metrics/<name>.py`` (a module with ``read(run) -> float | None``).
A new model, mix or metric is a new file here and a new entry there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those without a ``workloads`` key, and those whose
    list names it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


_readers: dict = {}


def reader(name: str):
    """``metrics/<name>.py``'s ``read`` function."""
    if name not in _readers:
        path = HERE / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[name] = mod.read
    return _readers[name]

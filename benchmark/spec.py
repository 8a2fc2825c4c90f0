"""``BENCHMARK.json`` and everything it names, found by name: a cell's
configuration file, its traffic file (``benchmark/traffic/<name>.json``),
the limits of its check of ``correct`` (``benchmark/limits/<cell>.json``)
and each metric's reader (``benchmark/metrics/<metric>.py``, a module with
``read(ctx)`` that returns a number, or None where it finds nothing to
read).  A new configuration, traffic mix, cell or metric is new files and
entries; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell: str, here: Path = HERE) -> dict:
    with open(here / "limits" / f"{cell}.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, bench: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return _reports(e2e[moves], cell, bench)


def metrics(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with tracing its per-layer metrics."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if _reports(m, cell, bench)]


_readers: Dict[str, Callable] = {}


def reader(name: str, here: Path = HERE) -> Callable:
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    if name not in _readers:
        path = here / "metrics" / f"{name}.py"
        mod_spec = importlib.util.spec_from_file_location(
            "benchmark.metrics." + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _readers[name] = mod.read
    return _readers[name]

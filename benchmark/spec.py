"""``BENCHMARK.json`` and everything it names, found by name: a cell's
configuration file, the generator architecture that the configuration
names (``benchmark/architectures/<name>/``), its traffic file
(``benchmark/traffic/<name>.json``), the limits of its check of
``correct`` (``benchmark/limits/<cell>.json``) and each metric's reader
(``benchmark/metrics/<metric>.py``, a module with ``read(ctx)`` that
returns a number, or None where it finds nothing to read).  A new
architecture, configuration, traffic mix, cell or metric is new files and
entries; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from types import ModuleType
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


def architecture(config: dict, here: Path = HERE) -> ModuleType:
    """The package ``benchmark/architectures/<config["architecture"]>/``.
    The harness calls an architecture only through these names:

    * ``make_params(seed, config, device)``: the weights from ``--seed``,
      a dict of float32 tensors on ``device``;
    * ``System(config, params, device, lr_shape, calib)``: the system under
      test (the architecture's ``program.py``, its only module that imports
      the program), with ``archive(clip_u8, chunk, sink)``,
      ``stream_init()``, ``stream_step(state, frame_u8) -> (state,
      uint8 SR frame)``, ``stream_carry(state)`` and ``close()``; ``calib``
      is the calibration clip, or None where the configuration's
      ``calibration_frames`` is 0;
    * ``hooks(config, params, calib, control)``: the plain reference's
      precision hooks, or with ``control`` its control's, handed as they
      are to the two functions below;
    * ``run_clip(params, config, lr_u8, hooks, keep=None)``: the reference's
      free recurrence over a (B, T, H, W, 3) uint8 clip from frame 0,
      yielding ``(t, uint8 SR frame)`` for each ``t`` in ``keep``;
    * ``frame(params, config, lr, prev_frame, prev_lr, hooks)``: one
      reference step from the previous SR frame and LR frame (None for
      frame 0), float32 in [0, 1];
    * ``carry_to_frame(carry)``: the previous SR frame, float32, from what
      ``System.stream_carry`` returns;
    * ``frame_peak_s(config, h, w)``: a frame's model operations at LR
      (h, w) over the peak of the precision each runs in (``mfu.archive``).

    A configuration without the ``architecture`` key is refused."""
    if "architecture" not in config:
        raise KeyError(f"configuration {config.get('name')!r} has no 'architecture' key: "
                       "name its directory under benchmark/architectures/")
    name = config["architecture"]
    mod_name = "benchmark.architectures." + name.replace(".", "_")
    if mod_name not in sys.modules:
        path = here / "architectures" / name / "__init__.py"
        mod_spec = importlib.util.spec_from_file_location(
            mod_name, path, submodule_search_locations=[str(path.parent)])
        mod = importlib.util.module_from_spec(mod_spec)
        sys.modules[mod_name] = mod
        try:
            mod_spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[mod_name]
            raise
    return sys.modules[mod_name]


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

"""A configuration names its generator architecture
(``benchmark/architectures/<name>/``), and the harness calls it only
through ``spec.architecture``'s interface.

* ``tecogan_df`` draws the same weights, computes the same reference
  frames and counts the same operations as the harness did before it was
  moved into its own directory: the pinned values were computed at commit
  2bf756f, on the CPU, with the harness's own functions of that commit.
* A new architecture is new files only: a toy written into a copy of the
  checkout, with its configuration, cells, traffic and limits, runs
  through ``run.run_cell`` with no harness file changed, comes out
  correct with every number compared exactly 0, and comes out not
  correct with its served frames altered as ``faults.altered_answer``
  alters the port's.
"""

import hashlib
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import faults, inputs, run, spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = spec.load()
CONFIGS = {c["name"]: spec.config(BENCH, c["name"]) for c in BENCH["configs"]}
INTERFACE = ("make_params", "System", "hooks", "run_clip", "frame", "carry_to_frame",
             "frame_peak_s")


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sha(items) -> str:
    d = hashlib.sha256()
    for key, t in items:
        d.update(repr(key).encode())
        d.update(t.contiguous().cpu().numpy().tobytes())
    return d.hexdigest()


# ---------------------------------------------------------------- found by name


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_configuration_names_an_architecture_with_the_interface(name):
    arch = spec.architecture(CONFIGS[name])
    assert CONFIGS[name]["architecture"] == "tecogan_df"
    assert all(callable(getattr(arch, f)) for f in INTERFACE)


def test_a_configuration_without_an_architecture_is_refused():
    cfg = {k: v for k, v in CONFIGS["tecogan-g16-bf16"].items() if k != "architecture"}
    with pytest.raises(KeyError, match="'architecture'"):
        spec.architecture(cfg)


# ---------------------------------------------------------------- the parent's values

PARAMS_SHA = {0: "38c4ead3867a7f264ea147d9b12ab027ea5a43dc782c398eb75bdc34d455eba7",
              7: "58fd9581fcd57d7190c73f423efcd11bee59f806b42cc210bce42093574d2272"}
CLIP_SHA = {"none": "0bb5f9cd87863d88828fd71139f99fb7a0d3847b4c19d76c15d80ba88d21cd6a",
            "int8": "46fc7c37905d6e3a43715890cb459ff2e2ca88d7e6eb5f5213dec2989e2c1fb0",
            "fp8": "8b496bb22e583980cb03537be2897edbe601d5e9ffd3759daddd75b974e8f445",
            "int4": "492c60bc0dfad7b86fa45637eba6648ddaff61de539174eae4e404813e0bccfe"}
MFU = {"tecogan-g16-bf16": 26.42832193411105, "tecogan-g16-int8": 13.386021898784712}


@pytest.mark.parametrize("seed", list(PARAMS_SHA))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_weights_are_the_parents(name, seed):
    cfg = CONFIGS[name]
    assert _sha(spec.architecture(cfg).make_params(seed, cfg, "cpu").items()) == PARAMS_SHA[seed]


@pytest.mark.parametrize("hooks", list(CLIP_SHA))
def test_reference_frames_are_the_parents(hooks, two_threads):
    """A 3-frame 16 x 24 clip through the reference: with no hooks, the
    int8 hooks, the fp8 control and the int4 control."""
    cfg = CONFIGS["tecogan-g16-int8" if hooks in ("int8", "int4") else "tecogan-g16-bf16"]
    arch = spec.architecture(cfg)
    params = arch.make_params(5, cfg, "cpu")
    clip = inputs.make_clip(5, ("test",), 3, 16, 24, 76, "cpu")
    calib = inputs.make_clip(5, ("calibration",), 8, 16, 24, 76, "cpu")
    with torch.no_grad():
        h = arch.hooks(cfg, params, calib, control=hooks in ("fp8", "int4"))
        assert _sha(arch.run_clip(params, cfg, clip[None], h)) == CLIP_SHA[hooks]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mfu_archive_is_the_parents(name):
    cfg = CONFIGS[name]
    ctx = SimpleNamespace(mode="archive", config=cfg, arch=spec.architecture(cfg),
                          traffic={"height": 270, "width": 480}, run={"frames": 960},
                          trace={"window_s": 4.02})
    assert spec.reader("mfu.archive")(ctx) == MFU[name]


# ---------------------------------------------------------------- a new architecture

TOY = "toy2conv"
TOY_FILES = {
    "__init__.py": '''"""A toy recurrent 4x generator of two convs, for the harness's tests."""

from benchmark import inputs

from .program import System  # noqa: F401
from .reference import carry_to_frame, frame, hooks, run_clip  # noqa: F401


def make_params(seed, config, device):
    c = config["channels"]
    shapes = [("a.weight", (c, 51, 3, 3), 51), ("a.bias", (c,), 51),
              ("b.weight", (48, c, 3, 3), c), ("b.bias", (48,), c)]
    return inputs.uniform_params(seed, shapes, config["weight_gain"], device)


def frame_peak_s(config, h, w):
    return 2.0 * 9 * (51 + 48) * config["channels"] * h * w / 67e12
''',
    "reference.py": '''"""The toy's plain reference: the LR frame and the previous SR frame
packed space-to-depth, a conv and ReLU, a conv to 48 channels, depth to
space and a sigmoid."""

import torch
import torch.nn.functional as F

from benchmark.reference.frames import dequant, to_u8


def hooks(config, params, calib, control):
    return (lambda x: x.to(torch.bfloat16).to(torch.float32)) if control else None


def frame(params, config, lr, prev_frame, prev_lr, hooks):
    q = hooks or (lambda x: x)
    x = lr.permute(0, 3, 1, 2)
    if prev_frame is None:
        fb = torch.zeros((x.shape[0], 48) + x.shape[2:], dtype=x.dtype, device=x.device)
    else:
        fb = F.pixel_unshuffle(prev_frame.permute(0, 3, 1, 2), 4)
    y = F.conv2d(q(torch.cat([x, fb], 1)), q(params["a.weight"]), params["a.bias"], padding=1)
    y = F.conv2d(q(F.relu(y)), q(params["b.weight"]), params["b.bias"], padding=1)
    return torch.sigmoid(F.pixel_shuffle(y, 4)).permute(0, 2, 3, 1)


def run_clip(params, config, lr_u8, hooks, keep=None):
    prev = prev_lr = None
    for t in range((lr_u8.shape[1] - 1 if keep is None else max(keep)) + 1):
        lr = dequant(lr_u8[:, t])
        prev = frame(params, config, lr, prev, prev_lr, hooks)
        prev_lr = lr
        if keep is None or t in keep:
            yield t, to_u8(prev)


def carry_to_frame(carry):
    return carry
''',
    "program.py": '''"""The toy's system under test: its own plain reference, served."""

import torch

from benchmark.reference.frames import dequant, to_u8

from .reference import frame


class System:
    def __init__(self, config, params, device, lr_shape, calib):
        self.config, self.params, self.device = config, params, torch.device(device)

    def archive(self, clip_u8, chunk, sink):
        prev = prev_lr = None
        for pos in range(0, clip_u8.shape[1], chunk):
            out = []
            for t in range(pos, min(pos + chunk, clip_u8.shape[1])):
                lr = dequant(clip_u8[:, t].to(self.device))
                prev = frame(self.params, self.config, lr, prev, prev_lr, None)
                prev_lr = lr
                out.append(to_u8(prev).cpu())
            sink(torch.stack(out, 1))

    def stream_init(self):
        return None, None

    def stream_step(self, state, frame_u8):
        lr = dequant(frame_u8.to(self.device))
        sr = frame(self.params, self.config, lr, state[0], state[1], None)
        return (sr, lr), to_u8(sr)

    @staticmethod
    def stream_carry(state):
        return state[0]

    def close(self):
        del self.params
''',
}
TOY_TRAFFIC = {
    "toy-archive16": {"mode": "archive", "batch": 1, "height": 16, "width": 16, "clip_frames": 24,
                      "chunk": 8, "pool_clips": 2, "warm_frames": 8, "max_level": 76,
                      "trace_seconds": 1},
    "toy-live16": {"mode": "live", "batch": 1, "height": 16, "width": 16, "streams": 2,
                   "rates_fps": [24, 25], "limit_ms": 33.3, "warm_frames": 3,
                   "check_frames_per_stream": 2, "max_level": 76, "trace_seconds": 1},
}
TOY_LIMITS = {"archive": ("frame_mae_worst", "far8_pct_worst"),
              "live": ("start_mae_worst", "step_mae_worst", "step_far8_pct_worst",
                       "handoff_mae_worst")}


def _tree(base: Path) -> dict:
    return {str(p.relative_to(base)): p.read_bytes() for p in sorted(base.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _toy_checkout(root: Path) -> dict:
    """Copies the checkout's benchmark to ``root`` and adds the toy's files
    and entries.  Returns the BENCHMARK.json written there."""
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "benchmark"
    (here / "architectures" / TOY).mkdir()
    for name, text in TOY_FILES.items():
        (here / "architectures" / TOY / name).write_text(text)
    cfg = {"name": "toy2conv-f32", "architecture": TOY, "channels": 8, "weight_gain": 1.0,
           "calibration_frames": 0}
    (here / "configs" / "toy2conv-f32.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": cfg["name"], "source": "https://arxiv.org/abs/1811.09393",
                             "file": "benchmark/configs/toy2conv-f32.json", "reduced": [],
                             "why": "a toy of two convs"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for mode, metric in (("archive", "archive_fps"), ("live", "live_p95_ms")):
        cell, traffic = f"toy-{mode}", f"toy-{mode}16"
        bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": traffic,
                                   "chips": 1, "why": "the toy"})
        e2e[metric]["workloads"].append(cell)
        (here / "traffic" / f"{traffic}.json").write_text(json.dumps(TOY_TRAFFIC[traffic]))
        (here / "limits" / f"{cell}.json").write_text(json.dumps(
            {k: {"limit": 0.0} for k in TOY_LIMITS[mode]}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@pytest.fixture
def toy_modules():
    yield
    for name in [m for m in sys.modules if m.startswith(f"benchmark.architectures.{TOY}")]:
        del sys.modules[name]


@pytest.mark.parametrize("fault", ["sound", "altered_answer"])
@pytest.mark.parametrize("mode", ["archive", "live"])
def test_a_new_architecture_is_new_files_only(mode, fault, tmp_path, monkeypatch, two_threads,
                                              toy_modules):
    root = tmp_path / "checkout"
    bench = _toy_checkout(root)
    here = root / "benchmark"
    before = _tree(HERE)
    cell = spec.workload(bench, f"toy-{mode}")
    if fault == "altered_answer":
        program = spec.architecture(spec.config(bench, cell["config"], root), here).program
        real = program.to_u8
        monkeypatch.setattr(program, "to_u8", lambda x: faults.brighten_top(real(x)))
    result, lines = run.run_cell(bench, cell, 2**31 + 5, 1.0, False, "cpu", root=root)

    after = _tree(here)
    assert all(after[k] == v for k, v in before.items())
    assert {k.split("/")[0] for k in set(after) - set(before)} == {
        "architectures", "configs", "traffic", "limits"}
    assert set(result["checks"]) == set(TOY_LIMITS[mode])
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"archive_fps" if mode == "archive" else "live_p95_ms",
                                      "setup_s"}
    if fault == "sound":
        assert result["correct"] is True, "\n".join(lines)
        assert all(c["value"] == 0.0 for c in result["checks"].values()), "\n".join(lines)
    else:
        assert result["correct"] is False, "\n".join(lines)

"""Whole runs of each cell on the CPU at a small size (8 x 12 LR, the
published depth), past the harness's look for a card: a sound run comes
out correct, and a run with the timed path broken underneath comes out
not correct, for each fault a cell can have: a step that returns its
state unchanged, and an answer altered where it is produced.  (Each cell
serves one stream at a time on one card: no batch to halve, no exchange
between cards.)"""

import math

import pytest
import torch

from benchmark import faults, run, spec

BENCH = spec.load()


def _small(cell_name):
    cell = spec.workload(BENCH, cell_name)
    cfg = spec.config(BENCH, cell["config"])
    tr = dict(spec.traffic(cell["traffic"]), height=8, width=12)
    if tr["mode"] == "archive":
        tr.update(clip_frames=32, pool_clips=2, warm_frames=16)
        seconds = 4.0
    else:
        tr.update(streams=2, rates_fps=[4, 5])
        seconds = 3.0
    return cell, cfg, tr, seconds


CASES = {"sound": None, **faults.FAULTS}


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("fault", list(CASES))
@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch, two_threads):
    torch.manual_seed(0)
    if CASES[fault] is not None:
        CASES[fault](monkeypatch.setattr)
    cell, cfg, tr, seconds = _small(cell_name)
    result, lines = run.run_cell(BENCH, cell, 2**31 + 7, seconds, False, "cpu",
                                 config=cfg, traffic=tr)
    assert result["correct"] is (fault == "sound"), "\n".join(lines)
    assert result["failed"] == 0 and result["attempted"] > 0
    # every number read, none left infinite by a clip that never completed
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())

"""The readings that a cell's limits are set from: the numbers of the
check of ``correct`` on many seeds, from sound runs of the program and from
the control put in its place (the architecture's ``hooks(...,
control=True)``), in one process on the card.  Each seed is a whole run of the cell (set-up, a
window at the cell's own load, the check); the control reads the same
run's inputs and the program's carries.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2 --seconds 4 [--fault stale_state] [--out readings.json]

Prints a JSON line a seed and, at the end, each number's largest reading
over the program's seeds and smallest over the control's.  ``--fault``
plants a fault of benchmark/faults.py in the program for the whole
process, so that the program's readings are the fault's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", default=None, help="plant a fault of benchmark/faults.py")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from . import faults, run, spec

    run.steady_allocator()

    if not torch.cuda.is_available():
        print("readings: no CUDA GPU", file=sys.stderr)
        return 3
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    lim = {k: {"limit": float("inf")} for k in spec.limits(cell["name"])}
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds + sorted(ctl - set(seeds)):
        t = time.perf_counter()
        res, _ = run.run_cell(bench, cell, seed, args.seconds, False, torch.device("cuda", 0),
                              limits=lim, t_start=t, control=seed in ctl)
        row = {"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()},
               "control": res.get("control"),
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "seconds": time.perf_counter() - t}
        if seed not in seeds:
            row["program"] = None
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for k in lim:
        prog = [r["program"][k] for r in rows if r["program"]]
        cont = [r["control"][k] for r in rows if r["control"]]
        summary[k] = {"program_max": max(prog) if prog else None,
                      "control_min": min(cont) if cont else None}
    print(json.dumps({"workload": cell["name"], "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

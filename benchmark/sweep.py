"""The knee of a live cell: the highest frame rate its serving loop
sustains without a growing backlog, found by offering more streams (the
traffic file's rates, taken in turn) on one card.

    python3 -m benchmark.sweep --workload <live cell> --streams 4,5,6,8 \\
        --seed <n> --seconds 6

For each stream count, one window: the offered rate, the rate served
inside the window, the p95 latency, and how fast the lateness grew (a
least-squares slope of start minus due time over due time, ms a second).
A cell's stream count is the largest whose offered rate is at most 0.8
of the knee.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)

    import torch

    from . import drive, run, spec

    run.steady_allocator()

    if not torch.cuda.is_available():
        print("sweep: no CUDA GPU", file=sys.stderr)
        return 3
    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    arch = spec.architecture(cfg)
    dev = torch.device("cuda", 0)
    params = arch.make_params(args.seed, cfg, dev)
    calib = run.calibration(cfg, spec.traffic(cell["traffic"]), args.seed, dev)
    for n in [int(s) for s in args.streams.split(",")]:
        tr = dict(spec.traffic(cell["traffic"]), streams=n)
        system = arch.System(cfg, params, dev, (1, tr["height"], tr["width"], 3), calib)
        data = drive.live_inputs(tr, args.seed, args.seconds, dev)
        warm = drive.live_warm(system, tr, data)
        run = drive.live(system, tr, data, warm, args.seconds, drive.Spans(False))
        recs = run["records"]
        t_end = run["t0"] + args.seconds
        lat = [(r[5] - r[2]) * 1e3 for r in recs] + [float("inf")] * (run["offered"] - len(recs))
        x = [r[2] - run["t0"] for r in recs]
        y = [(r[3] - r[2]) * 1e3 for r in recs]
        mx, my = sum(x) / len(x), sum(y) / len(y)
        slope = (sum((a - mx) * (b - my) for a, b in zip(x, y))
                 / max(sum((a - mx) ** 2 for a in x), 1e-12))
        print(json.dumps({
            "streams": n, "offered_fps": sum(s["fps"] for s in data["streams"]),
            "served_in_window_fps": sum(1 for r in recs if r[5] <= t_end) / args.seconds,
            "p50_ms": sorted(lat)[len(lat) // 2], "p95_ms": drive.p95(lat),
            "lateness_slope_ms_per_s": slope,
            "service_ms_mean": sum(r[5] - r[3] for r in recs) / len(recs) * 1e3,
            "issue_ms_mean": sum(r[4] - r[3] for r in recs) / len(recs) * 1e3,
            "card": torch.cuda.get_device_name(dev)}), flush=True)
        system.close()
        del system, data, warm, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

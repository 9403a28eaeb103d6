"""The highest tick rate a live cell's node sustains, by a sweep on the card:

    python3 -m mcl_bench.sweep --workload <cell> --rates 200 400 ... --seconds 4

The program is built once; each rate runs a window of the cell's own
open-loop traffic at that rate from a fresh episode. A rate is sustained
when the last tenth of its ticks is no later, at the median, than the
first tenth plus one tick period: the backlog does not grow. One JSON
line a rate. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mcl_bench import spec


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="mcl_bench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.benchmark(), args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    session = spec.driver(traffic).Session(cfg, traffic, args.seed, device, spec.data_path)
    session.warm()
    for hz in args.rates:
        session.traffic = dict(traffic, tick_hz=hz)
        w = session.run(args.seconds)
        lat = w["latency_s"] * 1e3
        tenth = max(1, len(lat) // 10)
        head, tail = float(np.median(lat[:tenth])), float(np.median(lat[-tenth:]))
        print(json.dumps(dict(
            tick_hz=hz, ticks=len(lat), failed=w["failed"], p50_ms=float(np.median(lat)),
            p95_ms=float(np.percentile(lat, 95)), update_p50_ms=float(np.median(w["update_s"]) * 1e3),
            head_ms=head, tail_ms=tail, sustained=tail <= head + 1e3 / hz)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's limits are set from, in one process on the card:

    python3 -m mcl_bench.calibrate --workload <cell> --seeds <n> [<n> ...] --seconds <s>

For each seed it runs a short window of the cell's own traffic on the
program (built once), then compares the sampled calls as a run does
(``check.py``), and compares the control on the same calls: the
reference in bfloat16 put in the program's place. One JSON line a seed,
then the largest sound reading and the smallest control reading of each
number. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mcl_bench import spec
from mcl_bench.generator import SAMPLED_CALLS, SAMPLED_STARTS, Reservoir, Session


def reseed(session: Session, seed: int) -> None:
    """The node and the recorder as a fresh run on ``seed`` has them."""
    session.seed = seed
    session.node.rng = np.random.default_rng(seed)
    session.episodes = 0
    rng = np.random.default_rng([seed, 1])
    session.recorder.calls = Reservoir(SAMPLED_CALLS, rng)
    session.recorder.starts = Reservoir(SAMPLED_STARTS, rng)


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="mcl_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    drv = spec.driver(traffic)
    session = drv.Session(cfg, traffic, args.seeds[0], device, spec.data_path)
    session.warm()
    cmp_ = drv.Comparison(cfg, traffic["mode"], args.seeds[0], device, spec.data_path)
    sound, control = {}, {}
    for seed in args.seeds:
        reseed(session, seed)
        window = session.run(args.seconds)
        records, starts = session.samples()
        cmp_.node_seed = seed
        line = dict(seed=seed, attempted=window["attempted"], failed=window["failed"],
                    calls=len(records), numbers=cmp_.numbers(records, starts))
        if not args.no_control:
            line["control"] = cmp_.numbers(records, starts, control=True)
        print(json.dumps(line), flush=True)
        for k, v in line["numbers"].items():
            sound[k] = max(sound.get(k, 0.0), v)
        for k, v in line.get("control", {}).items():
            control[k] = min(control.get(k, float("inf")), v)
    print(json.dumps(dict(workload=args.workload, seeds=len(args.seeds),
                          sound_max=sound, control_min=control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

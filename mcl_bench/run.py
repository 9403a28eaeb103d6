"""One run of one benchmark cell on the card.

    python3 -m mcl_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It builds the program for the cell's
configuration (``mcl_bench/configs``) through the driver its traffic mix
names (``mcl_bench/traffic``, ``mcl_bench/drivers``), warms up every shape
the cell's traffic uses, measures for ``--seconds``, checks a sample of
what the window produced against the plain reference (the driver's
``Comparison``, limits in ``mcl_bench/limits``) and prints, as its last
line of standard output, one JSON object: the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics (``mcl_bench/metrics``), read
from a profiled segment of the same traffic after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from mcl_bench import spec  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "monte_carlo_localization_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's name only begins with it)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="mcl_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, device: str, cfg: dict, traffic: dict) -> tuple:
    """Set-up, window and (with ``--trace``) the traced segment. Returns
    (run data, sampled calls, sampled starts, memory peak)."""
    import torch

    torch.set_num_threads(1)
    t_build = time.perf_counter()
    session = spec.driver(traffic).Session(cfg, traffic, args.seed, device, spec.data_path)
    t_warm = time.perf_counter()
    session.warm()
    setup_s = time.perf_counter() - T_START
    print(f"set-up: {t_build - T_START:.3f} s to the program's build (imports, CUDA context), "
          f"{t_warm - t_build:.3f} s build (map, LUT, node), "
          f"{T_START + setup_s - t_warm:.3f} s warm-up and capture", file=sys.stderr)
    window = session.run(args.seconds)
    prof = session.profiled() if args.trace else None
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    run = SimpleNamespace(mode=traffic["mode"], window=window, setup_s=setup_s, profile=prof,
                          **session.facts(spec.data_path))
    records, starts = session.samples()
    del session
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return run, records, starts, peak


def main(argv=None, *, require_card: bool = True, device: str = "cuda", root=spec.ROOT) -> int:
    args = parse(argv)
    bench = spec.benchmark(root)
    cell = spec.cell(bench, args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])["limits"]

    import numpy as np
    import torch

    from mcl_bench.card import card
    from mcl_bench.check import verdict
    from mcl_bench.devtrace import breakdown

    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        info = card(0)
    else:
        info = dict(kind="cpu", count=0, power_limit_w=None)
    print(f"card: {info['kind']}, count {info['count']}, power limit {info['power_limit_w']} W",
          flush=True)

    run, records, starts, peak = measure(args, device, cfg, traffic)
    print("graphs (warm-up ms, capture ms): " + ", ".join(
        f"{s['warmup_ms']:.1f}/{s['capture_ms']:.1f}" for s in getattr(run, "graph_stats", [])),
        file=sys.stderr)
    if "latency_s" in run.window:
        lat = np.asarray(run.window["latency_s"]) * 1e3
        print("latency ms: " + ", ".join(f"p{q} {np.percentile(lat, q):.4f}" for q in (50, 90, 95, 99))
              + f", max {lat.max():.4f}, over twice the median {np.mean(lat > 2 * np.median(lat)):.4f}"
              + f"; update p50 {np.median(run.window['update_s']) * 1e3:.4f}", file=sys.stderr)
    comparison = spec.driver(traffic).Comparison(cfg, traffic["mode"], args.seed, device,
                                                  spec.data_path)
    numbers = comparison.numbers(records, starts)
    ok, lines = verdict(numbers, limits)
    found = forbidden_modules()
    if found:
        print(f"loaded modules that must not be: {found}", file=sys.stderr)
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], kind):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = int(run.window["failed"])
    device_info = {"platform": "gpu" if device != "cpu" else "cpu", "kind": info["kind"],
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok and failed == 0), "attempted": int(run.window["attempted"]),
           "failed": failed, "metrics": metrics, "device": device_info}
    if run.profile:
        device_info.update(busy_s=run.profile["busy_s"], window_s=run.profile["window_s"])
        out["breakdown"] = breakdown(run.profile)
    out["checks"] = {name: {"value": numbers[name], "limit": limit}
                     for name, limit in limits.items()}
    out["checks"]["failed"] = {"value": failed, "limit": 0}
    for line in lines + [f"failed {failed} limit 0"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

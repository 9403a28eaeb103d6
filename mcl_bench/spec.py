"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration, traffic mix and metrics;
each lives in a file of its own under this folder:

* ``configs/<config>.json``: the deployment (map, trace, start, MCL
  settings, source, what was assumed);
* ``traffic/<traffic>.json``: the mix's parameters, read by its driver;
* ``drivers/<driver>.py``: what builds and drives the program for a mix
  (``Session``) and decides ``correct`` (``Comparison``); a mix names it
  under ``driver``, and ``node`` (``generator.py`` and ``check.py``) is
  the default;
* ``limits/<cell>.json``: each number the comparison takes, with its
  limit and the readings it was set from;
* ``metrics/<metric>.py``: a ``read(run)`` that returns the per-layer
  metric, or None where the run has nothing to read.
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


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def data_path(rel: str) -> Path:
    """A map or trace a configuration names, from the checkout's root
    (``maps/``, ``traces/``: files from before the port)."""
    return ROOT / rel


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
    that list it, and those with no ``workloads`` key."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def _module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mcl_bench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    return _module("metrics", metric).read


def driver(traffic: dict):
    """``drivers/<driver>.py`` of a mix: its ``Session`` and ``Comparison``."""
    return _module("drivers", traffic.get("driver", "node"))

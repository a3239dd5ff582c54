"""What a run reads: `BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by its name:
- `benchmark/configs/<config>.json`: the configuration (its `file` in
  `BENCHMARK.json`);
- `benchmark/traffic/<traffic>.json`: the traffic mix, whose `kind` names
  the traffic module that reads it (`benchmark/drivers/<kind>.py`);
- `benchmark/cells/<workload>.json`: the limits of the cell's comparison
  with the reference, and the readings they were set from;
- `benchmark/metrics/<metric>.py`: the reader of one per-layer metric,
  `read(readings) -> float | None`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


@dataclass
class Cell:
    """One run of one cell."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    chips: int = 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell(root: Path, spec: dict, name: str, seed: int, seconds: float, trace: bool, device,
         t0: float) -> Cell:
    """The cell `name` of `spec`, its files read from under `root`."""
    w = workload(spec, name)
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = root / BENCH_DIR.name
    return Cell(name=name, config=load_json(root / conf["file"]),
                traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(bench / "cells" / f"{name}.json")["limits"],
                seed=seed, seconds=seconds, trace=trace, device=device, t0=t0,
                chips=w["chips"])


def metrics_of(spec: dict, name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that the workload reports."""
    return [m for m in spec[kind] if "workloads" not in m or name in m["workloads"]]


def reader(root: Path, metric: str):
    """The `read` function of `benchmark/metrics/<metric>.py`."""
    path = root / BENCH_DIR.name / "metrics" / f"{metric}.py"
    name = "benchmark_metric_" + metric.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read

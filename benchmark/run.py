"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix and
limits are found by name through `BENCHMARK.json` (`benchmark/spec.py`);
its traffic's `kind` names the module (`benchmark/drivers/<kind>.py`) that
builds the program under test from the seed, warms up the cell's shapes,
measures for `--seconds` and holds what the timed path produced against
the plain reference. With `--trace 0` the result's metrics are the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, each read by
`benchmark/metrics/<metric>.py` from the traced run.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit (also the last
lines of standard error). A run exits non-zero and prints no result when
there is no CUDA card or fewer than the cell asks for, when a module of
JAX or of the JAX package was loaded, and when a traced run's steady
stretch saw no operation on the card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pixel_heal_thyself_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """Run the cell on `device` and return its result object."""
    import torch

    from benchmark import spec as specs

    bench = specs.benchmark(root)
    cell = specs.cell(root, bench, name, seed, seconds, trace, torch.device(device), t0)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    out = driver.run(cell)
    if trace and cell.device.type == "cuda" and not (out["trace"] or {}).get("busy_s"):
        raise SystemExit("the traced steady stretch saw no operation on the card")
    if trace:
        metrics = {}
        for m in specs.metrics_of(bench, name, "per_layer"):
            value = specs.reader(root, m["name"])(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out["end_to_end"], "setup_s": out["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in specs.metrics_of(bench, name, "end_to_end")}
    checks = {k: {"value": out["checks"][k], "limit": limit} for k, limit in cell.limits.items()}
    correct = out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = torch.device(device)
    result = {
        "correct": correct, "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace and out["trace"]:
        tr = out["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr.get("idle_gaps", [])}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()

    import torch

    from benchmark import spec as specs

    chips = specs.workload(specs.benchmark(root), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

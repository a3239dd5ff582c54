"""The harness: its contract, what it loads, what it refuses, what it finds.

- `BENCHMARK.json` keeps the benchmark's contract, and every name in it has
  its file (configuration, traffic, cell limits, metric reader, driver);
- a run loads no module whose top-level name is `jax`, `jaxlib`, `flax` or
  the JAX package's `pixel_heal_thyself_tpu` (compared whole: the port's
  `pixel_heal_thyself_tpu_torch` passes), and the reference loads nothing
  of the program either;
- a new configuration, traffic mix, cell and metric are picked up from new
  files and `BENCHMARK.json` entries alone;
- with no card a run exits non-zero and prints no result, as it does in a
  directory that holds only the benchmark.
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.tests.tiny import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TINY = ["afgsa_prod_tiny.serve_512_tiny", "mamba_prod_tiny.serve_512_tiny",
        "afgsa_prod_tiny.train_b8_tiny", "mamba_prod_tiny.train_b8_tiny"]


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 × 90 s of compiling a cell and 1200 s spare, in 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and (REPO / c["file"]).is_file()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert (REPO / "benchmark/metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and line(w["why"])
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((REPO / "benchmark/traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "benchmark/drivers" / f"{traffic['kind']}.py").is_file()
        limits = json.loads((REPO / "benchmark/cells" / f"{w['name']}.json").read_text())
        assert limits["limits"]
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in b["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2 and layer
        # a per-layer metric's cells report the end-to-end metric it moves
        for m in layer:
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchmark/reference").glob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top in {"__future__", "contextlib", "math", "numpy", "torch", "benchmark"}, \
                (path.name, mod)
            assert top != "benchmark" or mod.startswith("benchmark.reference"), (path.name, mod)
    code = ("import sys, torch; from benchmark import reference; "
            "from benchmark.reference.nn import Arith; "
            "c = {'widths': dict(model='mamba', input_channels=3, aux_input_channels=7, base_ch=8,"
            " enc_ch=4, num_blocks=1, d_state=4, d_conv=4, expansion=2, headdim=4),"
            " 'padding_mode': 'replicate'}; "
            "m = reference.generator(c, 'cpu'); "
            "m(torch.rand(1, 16, 16, 3), torch.rand(1, 16, 16, 7), Arith()); "
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & {"pixel_heal_thyself_tpu_torch", "pixel_heal_thyself_tpu", "jax", "flax"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole run, in its own process: the port loads, nothing of JAX or
    of the JAX package does."""
    root = tiny_root(tmp_path)
    code = ("import sys, time, torch; torch.set_num_threads(2); "
            "from pathlib import Path; from benchmark import run; "
            f"r = run.run_cell(Path('.'), {TINY[2]!r}, 3, 0.5, False, 'cpu', time.perf_counter()); "
            "assert r['correct'], r; "
            "print(run.forbidden_modules(), "
            "'pixel_heal_thyself_tpu_torch' in {m.split('.')[0] for m in sys.modules})")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": f"{root}:{REPO}"}, check=True).stdout
    assert out.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "pixel_heal_thyself_tpu_torch_probe", object())
    assert "pixel_heal_thyself_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pixel_heal_thyself_tpu.probe", object())
    assert "pixel_heal_thyself_tpu" in run.forbidden_modules()


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def run_tiny(root: Path, name: str, trace: bool = False, seed: int = 2**31 + 7) -> dict:
    import time

    from benchmark import run

    return run.run_cell(root, name, seed, 0.5, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", TINY)
def test_new_files_are_picked_up(tmp_path, two_threads, monkeypatch, name):
    """The tiny configurations, mixes and cells exist only as new files and
    entries in the copy's BENCHMARK.json; so does one more metric."""
    root = tiny_root(tmp_path)
    kind = "serve" if "serve" in name else "train"
    (root / f"benchmark/metrics/extra_probe.{kind}.py").write_text(
        f"def read(readings):\n    return 1.5 if readings.get('kind') == '{kind}' else None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": f"extra_probe.{kind}", "unit": "%", "better": "higher",
                           "source": "host_clock", "layer": "device",
                           "moves": "peak_mem_gib", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.chdir(root)
    plain = run_tiny(root, name)
    assert set(plain["metrics"]) == {m["name"] for m in b["end_to_end"]
                                     if name in m.get("workloads", [name])}
    traced = run_tiny(root, name, trace=True)
    assert traced["metrics"][f"extra_probe.{kind}"]["value"] == 1.5
    assert list(traced)[-1] == "checks"
    assert all(math.isfinite(c["value"]) for c in plain["checks"].values())


def _cli(cwd: Path, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "afgsa_prod.serve_512", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True)


def test_no_card_no_result():
    done = _cli(REPO, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0 and done.stdout.strip() == ""


@pytest.mark.cuda
def test_hidden_card_no_result():
    """On a machine with a card: hide it, and the run refuses rather than
    fall back to the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    done = _cli(REPO, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is missing, and the run fails before any result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time; from pathlib import Path; from benchmark import run; "
            "print(run.run_cell(Path('.'), 'afgsa_prod.serve_512', 1, 1, False, 'cpu', 0.0))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "pixel_heal_thyself_tpu_torch" in done.stderr


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_idle_share_takes_the_untraced_pace(kind):
    """idle_pct.* holds the traced stretch's busy seconds per item against
    the untraced window's seconds per item, not the stretch's own wall
    (which tracing lengthens); a stretch that saw nothing on the card gives
    nothing."""
    from benchmark import spec

    read = spec.reader(REPO, f"idle_pct.{kind}")
    trace = {"window_s": 2.0, "busy_s": 0.92, "items": 10, "item_s": 0.117}
    assert read({"kind": kind, "trace": trace}) == pytest.approx(100 * (1 - 0.092 / 0.117))
    assert read({"kind": kind, "trace": {**trace, "busy_s": 0.0}}) is None
    other = "train" if kind == "serve" else "serve"
    assert read({"kind": other, "trace": trace}) is None


def test_pace_is_taken_before_any_profiler(monkeypatch):
    """The traced run's pace (`Schedule.rate`, behind idle_pct.* and mfu.*)
    is that of the items before the first stretch: a profiler session slows
    the host's later items too."""
    from benchmark import trace

    clock = [0.0]
    monkeypatch.setattr(trace.time, "perf_counter", lambda: clock[0])
    sched = trace.Schedule(True, 3, 2, 1)
    for k in range(8):
        sched.before(k)
        clock[0] += 0.1 if k < 3 else 0.5
        sched.after(k)
    sched.finish()
    assert sched.rate(8, clock[0]) == pytest.approx(10.0)
    assert trace.Schedule(False, 3, 2, 1).rate(8, 2.0) == pytest.approx(4.0)

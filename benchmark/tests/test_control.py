"""The comparison that decides `correct` fails what it should, on the CPU.

Each cell's limits (`benchmark/cells/<cell>.json`) are used as they stand:
- the control, the reference put in the program's place one precision
  below the configuration's (the generator's products in fp8, the float32
  critic's in bfloat16), fails at least one limit of each cell, at the
  configuration's widths on small frames and patches;
- a whole run (the card check skipped) with the timed path broken
  underneath comes out not correct, once for each fault the cell can
  have, at narrow widths with the program in float32 (where sound runs
  read 1e-7 to 1e-3 and come out correct). Serving: one window's answer
  replaced by its input where the model produces it; half of each batch
  of windows left out. Training: a step that leaves the state unchanged;
  half of each batch left out, the loss taken over the rest; one sample's
  generator output replaced by its input. (No cell spans chips, so none
  can leave out an exchange.)
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import control, program, run, spec
from benchmark.tests.tiny import tiny_root

SERVE = ["afgsa_prod_tiny.serve_512_tiny", "mamba_prod_tiny.serve_512_tiny"]
TRAIN = ["afgsa_prod_tiny.train_b8_tiny", "mamba_prod_tiny.train_b8_tiny"]


@pytest.fixture
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def _root(tmp: Path, narrow: bool, monkeypatch) -> Path:
    r = tiny_root(tmp, narrow=narrow)
    if narrow:
        for f in r.glob("benchmark/configs/*_tiny.json"):
            c = json.loads(f.read_text())
            c["program"]["trainer"]["precision"] = "fp32"
            f.write_text(json.dumps(c))
    monkeypatch.chdir(r)
    return r


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_fails(tmp_path, monkeypatch, threads, name):
    root = _root(tmp_path, False, monkeypatch)
    limits = spec.cell(root, spec.benchmark(root), name, 31, 0.0, False, torch.device("cpu"),
                       time.perf_counter()).limits
    out = control.readings(root, name, 31, "cpu", True)
    numbers = out["control"]
    assert any(numbers[k] > limit for k, limit in limits.items() if k in numbers), numbers
    assert all(out["program"][k] <= limit for k, limit in limits.items()), out["program"]


def run_once(root: Path, name: str) -> dict:
    return run.run_cell(root, name, 2**31 + 11, 0.5, False, "cpu", time.perf_counter())


def _wrap_forward(model, fault: str):
    forward = model.forward

    def broken(x, aux, *args, **kwargs):
        if fault == "half_batch":
            h = len(x) // 2
            out = forward(x[:h], aux[:h], *args, **kwargs)
            return torch.cat([out, x[h:].to(out.dtype)])
        out = forward(x, aux, *args, **kwargs)
        return torch.cat([x[:1].to(out.dtype), out[1:]])

    model.forward = broken
    return model


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_serving_faults(tmp_path, monkeypatch, threads, name, fault):
    root = _root(tmp_path, True, monkeypatch)
    assert run_once(root, name)["correct"]
    real = program.serving_model
    monkeypatch.setattr(program, "serving_model",
                        lambda *a, **k: _wrap_forward(real(*a, **k), fault))
    assert not run_once(root, name)["correct"]


class _Broken(program.Training):
    fault = None

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.fault == "unchanged_state":
            self.step.g_opt.step = self.step.d_opt.step = lambda *a, **k: None
        elif self.fault == "altered_answer":
            _wrap_forward(self.g, self.fault)

    def batches(self):
        feed = super().batches()
        if self.fault != "repeated_batch":
            yield from feed
        first = next(feed)
        while True:
            yield {k: v.clone() for k, v in first.items()}

    def __call__(self, batch: dict) -> dict:
        if self.fault == "half_batch":
            batch = {k: v[:len(v) // 2] for k, v in batch.items()}
        if self.fault != "unchanged_vectors":
            return super().__call__(batch)
        vectors = [p for m in (self.g, self.d) for p in m.parameters() if p.dim() == 1]
        kept = [p.detach().clone() for p in vectors]
        out = super().__call__(batch)
        with torch.no_grad():
            for p, p0 in zip(vectors, kept):
                p.copy_(p0)
        return out


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "unchanged_vectors", "half_batch",
                                   "altered_answer", "repeated_batch"])
def test_training_faults(tmp_path, monkeypatch, threads, name, fault):
    root = _root(tmp_path, True, monkeypatch)
    assert run_once(root, name)["correct"]
    monkeypatch.setattr(_Broken, "fault", fault)
    monkeypatch.setattr(program, "Training", _Broken)
    assert not run_once(root, name)["correct"]

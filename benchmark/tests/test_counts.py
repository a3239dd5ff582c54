"""The benchmark's operation counts against FlopCounterMode over the reference.

At narrow widths and at `-cn ci` widths (the prod widths at 32²) on the
CPU: the generator's forward per window, one block's forward and backward,
and one WGAN-GP + L1 step per sample, each equal to what
`torch.utils.flop_counter.FlopCounterMode` counts over
`benchmark/reference/`. And every configuration file's recorded counts are
`counts.config_counts` of its widths.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, reference, weights
from benchmark.reference.critic import GanStep
from benchmark.reference.nn import Arith
from benchmark.tests.tiny import WIDTHS

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


class _Global:
    """FlopCounterMode's module tracker, reduced to one "Global" entry: its
    hooks refuse the gradient penalty's `autograd.grad(inputs=...)`."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args) -> None:
        pass


def flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _Global()
    with counter:
        fn()
    return counter.get_total_flops()


def config(name: str, narrow: bool, side: int) -> dict:
    c = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())
    if narrow:
        c["widths"].update(WIDTHS[name])
    c["critic"]["input_size"] = side
    return c


def models(c: dict) -> tuple:
    g, d = reference.generator(c, CPU), reference.critic(c, CPU)
    g.load_state_dict(weights.model_state(g, torch.Generator().manual_seed(0), CPU))
    d.load_state_dict(weights.model_state(d, torch.Generator().manual_seed(1), CPU))
    return g, d


CASES = [("afgsa_prod", True, 32), ("mamba_prod", True, 16), ("afgsa_prod", False, 32),
         ("mamba_prod", False, 32)]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name,narrow,side", CASES)
def test_generator_forward(name, narrow, side):
    c = config(name, narrow, side)
    g, _ = models(c)
    x, a = torch.rand(2, side, side, 3), torch.rand(2, side, side, 7)
    with torch.no_grad():
        got = flops(lambda: g(x, a, Arith()))
    assert got == 2 * counts.g_fwd_flops(c["widths"], side)


@pytest.mark.parametrize("name,narrow,side", CASES)
def test_block_forward_backward(name, narrow, side):
    c = config(name, narrow, side)
    g, _ = models(c)
    ch = c["widths"]["base_ch"]
    x = torch.rand(2, side, side, ch, requires_grad=True)
    a = torch.rand(2, side, side, ch, requires_grad=True)

    def fwd_bwd():
        out, _ = g.blocks[0](x, a, Arith())
        out.sum().backward()

    p = 2 * side * side
    assert flops(fwd_bwd) == counts.block_fwd_flops(c["widths"], p) * 3


@pytest.mark.parametrize("name,narrow,side", CASES[:2])
def test_step(name, narrow, side):
    c = config(name, narrow, side)
    g, d = models(c)
    o = c["optimizer"]
    opt = dict(lr_g=o["lr_g"], lr_d=o["lr_d"], betas=o["betas"], eps=o["eps"], gamma=o["gamma"],
               milestone_epochs=[2], steps_per_epoch=50)
    step = GanStep(g, d, opt, c["losses"], Arith(), Arith())
    batch = {"noisy": torch.rand(2, side, side, 3), "gt": torch.rand(2, side, side, 3),
             "aux": torch.rand(2, side, side, 7) * 2 - 1}
    got = flops(lambda: step(batch, torch.rand(2, 1, 1, 1)))
    assert got == 2 * counts.step_flops(c["widths"], c["critic"], side)


@pytest.mark.parametrize("name", ["afgsa_prod", "mamba_prod"])
def test_recorded_counts(name):
    c = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())
    recorded = {k: v for k, v in c["counts"].items() if k != "method"}
    assert recorded == counts.config_counts(c["widths"], c["critic"], 128, 8)

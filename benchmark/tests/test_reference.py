"""The plain reference against the program's plain route, on the CPU.

At `-cn ci` widths (the prod widths, 32² patches, batch 2, float32): both
generators' forward, the critic's forward, and one WGAN-GP + L1 step with
its Adams; and a served frame through both tilers at narrow widths. The
reference takes the same seeded weights as the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import program, reference, weights
from benchmark.reference.critic import GanStep
from benchmark.reference.frames import denoise_frame
from benchmark.reference.nn import Arith

REPO = Path(__file__).resolve().parents[2]
CONFIGS = ("afgsa_prod", "mamba_prod")
CPU = torch.device("cpu")


def ci_config(name: str) -> dict:
    """The configuration at `-cn ci`: 32² patches, float32."""
    c = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())
    c["program"]["trainer"]["precision"] = "fp32"
    c["program"]["data"]["patches"]["patch_size"] = 32
    c["critic"]["input_size"] = 32
    return c


def seeded(model, seed: int) -> dict:
    return weights.model_state(model, weights.stream(seed, weights.GENERATOR, CPU), CPU)


def batch(seed: int, b: int = 2, side: int = 32) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"noisy": torch.rand(b, side, side, 3, generator=g) * 4,
            "gt": torch.rand(b, side, side, 3, generator=g) * 4,
            "aux": torch.rand(b, side, side, 7, generator=g) * 2 - 1}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_forward(name):
    c = ci_config(name)
    ref = reference.generator(c, CPU)
    state = seeded(ref, 1)
    ref.load_state_dict(state)
    prog = program.serving_model(program.config(c, 1), state, CPU)
    b = batch(2)
    with torch.no_grad():
        x, a = torch.log1p(b["noisy"]), b["aux"]
        want = ref(x, a, Arith())
        got = prog(x, a)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_critic_forward():
    c = ci_config("afgsa_prod")
    ref = reference.critic(c, CPU)
    state = seeded(ref, 3)
    ref.load_state_dict(state)
    from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG

    prog = DiscriminatorVGG(in_nc=3, base_nf=64, input_size=32)
    prog.load_state_dict(state)
    x = batch(4)["gt"]
    with torch.no_grad():
        torch.testing.assert_close(prog(x), ref(x, Arith()), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step(name):
    """One step through the program's `make_train_step` (plain route,
    float32) and the reference's `GanStep` from the same weights, batch and
    interpolation weights: equal losses and gradients, the critic's element
    by element, the generator's by the norm of their difference (not the
    updated parameters: Adam's first step moves each by ±lr whatever its
    gradient's size, so a gradient at rounding level may flip its sign, and
    the generator's gradient is taken through the critic so updated)."""
    from benchmark.drivers import train as drv

    c = ci_config(name)
    cfg = program.config(c, 5)
    g_ref, d_ref = reference.generator(c, CPU), reference.critic(c, CPU)
    g_state = seeded(g_ref, 5)
    d_state = weights.model_state(d_ref, weights.stream(5, weights.CRITIC, CPU), CPU)
    g_ref.load_state_dict(g_state)
    d_ref.load_state_dict(d_state)
    store = {k: v.numpy() for k, v in batch(6, b=4).items()}
    tr = program.Training(cfg, g_state, d_state, store, 5,
                          torch.Generator().manual_seed(9), CPU)
    b = batch(7)
    got = tr(b)
    o = c["optimizer"]
    opt = dict(lr_g=o["lr_g"], lr_d=o["lr_d"], betas=o["betas"], eps=o["eps"], gamma=o["gamma"],
               milestone_epochs=drv.milestones(o), steps_per_epoch=tr.steps_per_epoch)
    step = GanStep(g_ref, d_ref, opt, c["losses"], Arith(), Arith())
    want = step(b, torch.rand((2, 1, 1, 1), generator=torch.Generator().manual_seed(9)))
    assert float(got["g_loss"]) == pytest.approx(want["g_loss"], rel=1e-4)
    assert float(got["d_loss"]) == pytest.approx(want["d_loss"], rel=1e-4)
    # a bias under batch norm takes a gradient at rounding level
    scale = max(float(r.grad.abs().max()) for r in d_ref.parameters())
    for (n, p), r in zip(tr.d.named_parameters(), d_ref.parameters()):
        torch.testing.assert_close(p.grad, r.grad, rtol=1e-3, atol=1e-6 * scale,
                                   msg=lambda m, n=n: f"{n}: {m}")
    for (n, p), r in zip(tr.g.named_parameters(), g_ref.parameters()):
        if r.grad is None:   # the Mamba generator's unused aux branch
            assert p.grad is None, n
        else:
            assert float((p.grad - r.grad).norm() / r.grad.norm()) < 1e-3, n


@pytest.mark.parametrize("name", CONFIGS)
def test_served_frame(name):
    """A 64×96 frame through the program's fused tiler and the reference's,
    at narrow widths (tile 32, margin 16, batch 4: 6 windows, 2 of them the
    program's wrap-around padding)."""
    from benchmark.tests.tiny import PROGRAM, WIDTHS

    c = ci_config(name)
    c["widths"].update(WIDTHS[name])
    c["program"]["model"].update(PROGRAM[name])
    ref = reference.generator(c, CPU)
    state = seeded(ref, 8)
    ref.load_state_dict(state)
    prog = program.serving_model(program.config(c, 8), state, CPU)
    g = torch.Generator().manual_seed(9)
    noisy, aux = torch.rand(64, 96, 3, generator=g) * 4, torch.rand(64, 96, 7, generator=g) * 2 - 1
    serve = program.frame_server(prog, (64, 96), 32, 16, 4, CPU)
    got = serve({"noisy": noisy.numpy(), "aux": aux.numpy()})
    want = denoise_frame(ref, noisy, aux, tile=32, margin=16, batch=4, arith=Arith())
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=1e-4, atol=1e-4)

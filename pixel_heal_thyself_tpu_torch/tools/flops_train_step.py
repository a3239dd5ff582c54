"""FLOP counts of the full GAN train step, per sample.

Port of the JAX package's `tools/flops_train_step.py`: for either prod
generator at the JAX tool's geometry (AFGSA batch 8, Mamba batch 4, 128²
patches, DiscriminatorVGG, WGAN-GP + L1, Adam), the FLOP of one whole train
step, of one G forward and of one G forward + backward (to the
parameters), each per sample. Where the JAX tool reads XLA's
`cost_analysis()["flops"]`, this one counts with
`torch.utils.flop_counter.FlopCounterMode`, which counts the products and
convolutions (forward and backward) and no elementwise operation; XLA
counts those too, so at a narrow width this count is 0.93–0.97 of the JAX
tool's for G (tests/test_torch_port_tools.py holds the ratio).

The hand kernels launch through ctypes (`_build.py`), so the dispatcher
never sees their work: the tool counts the plain route (`use_kernels`
off), which computes the same function, and says so
(`"counted_route": "plain"`). Beside the counts it prints the FLOP share of
the card's dense bf16 peak (`measure.PEAK_FLOPS`, 989 TFLOP/s) that a
measured step rate implies: TFLOP/sample × patches/s ÷ peak. The rate is
`--patches-per-sec` when given; else, on the card, the tool times the
kernel route's step itself (same weights; 5 steps after 2 warm-up steps).

    python -m pixel_heal_thyself_tpu_torch.tools.flops_train_step \
        [--model afgsa|mamba] [--patches-per-sec R] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

PATCH = 128
BATCH = {"afgsa": 8, "mamba": 4}
STEPS = 5  # kernel-route steps timed (after 2 warm-up steps) when no rate is given


class _GlobalOnly:
    """A stand-in for `FlopCounterMode`'s module tracker that attributes
    every count to "Global": the tracker's global module hooks put backward
    hooks on tensors that `torch.autograd.grad(..., inputs)` refuses, and
    the GP's critic input gradient is such a call."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args) -> None:
        pass


def count(fn) -> int:
    """FLOP of `fn()` by `FlopCounterMode` (products and convolutions,
    forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _GlobalOnly()
    with counter:
        fn()
    return counter.get_total_flops()


def _batch(b: int, p: int, device) -> dict[str, torch.Tensor]:
    z3 = torch.zeros(b, p, p, 3, device=device)
    return {"noisy": z3, "gt": z3, "aux": torch.zeros(b, p, p, 7, device=device)}


def _step(g, d):
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    spec = make_optimizer(1e-4, [2], 0.5, 100)
    return make_train_step(g, d, LossesConfig(), False, spec, spec)


def run(g, d, batch: int, patch: int = PATCH, device="cuda") -> dict:
    """FLOP of `g` (its forward; forward + backward to its parameters) and
    of one train step of `g` against `d` at `batch` × `patch`², in TFLOP
    per sample. Counted in that order: the step updates both models."""
    device = torch.device(device)
    data = _batch(batch, patch, device)
    params = [p for p in g.parameters() if p.requires_grad]

    def g_fwd():
        with torch.no_grad():
            g(data["noisy"], data["aux"])

    def g_fwd_bwd():
        loss = torch.mean(torch.abs(g(data["noisy"], data["aux"]) - data["gt"]))
        torch.autograd.grad(loss, params, allow_unused=True)  # Mamba: the aux encoder is unused

    step = _step(g, d)
    alpha = torch.rand(batch, 1, 1, 1, generator=torch.Generator().manual_seed(7)).to(device)
    fwd, fwd_bwd = count(g_fwd), count(g_fwd_bwd)
    full = count(lambda: step(data, alpha=alpha))
    return {"batch": batch, "patch": patch,
            "full_step_tflop_per_sample": full / batch / 1e12,
            "g_fwd_tflop_per_sample": fwd / batch / 1e12,
            "g_fwd_bwd_tflop_per_sample": fwd_bwd / batch / 1e12}


def flop_share(tflop_per_sample: float, patches_per_sec: float) -> float:
    """The share of the card's dense bf16 peak that `patches_per_sec` of a
    step of `tflop_per_sample` implies."""
    from pixel_heal_thyself_tpu_torch.measure import PEAK_FLOPS

    return tflop_per_sample * 1e12 * patches_per_sec / PEAK_FLOPS[torch.bfloat16]


def step_rate(g, d, batch: int, patch: int, device, steps: int, warmup: int = 2) -> float:
    """Patches/s of `steps` train steps of `g` against `d` (host clock,
    ending in a copy of the last loss to the host)."""
    step, data = _step(g, d), _batch(batch, patch, device)
    for _ in range(warmup):
        step(data)["g_loss"].item()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step(data)
    out["g_loss"].item()
    return batch * steps / (time.perf_counter() - t0)


def models(model: str, device, use_kernels: bool):
    """The prod generator (`use_kernels` selects its kernel route) and
    DiscriminatorVGG(128, bf16), seeded, in train mode."""
    from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG
    from pixel_heal_thyself_tpu_torch.tools import prod_generator, seeded

    route = (dict(use_kernels=use_kernels, use_megakernel=use_kernels) if model == "mamba"
             else dict(use_kernels=use_kernels, use_block_kernel=use_kernels))
    g = prod_generator(model, device, **route).train()
    d = seeded(DiscriminatorVGG, dict(in_nc=3, base_nf=64, input_size=PATCH,
                                      dtype=torch.bfloat16), device, seed=1).train()
    return g, d


def main(argv=None) -> dict:
    from pixel_heal_thyself_tpu_torch.tools import card_line, resolve_device

    ap = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.flops_train_step")
    ap.add_argument("--model", choices=("afgsa", "mamba"), default="afgsa")
    ap.add_argument("--patches-per-sec", type=float, default=None,
                    help="a measured step rate to turn into a FLOP share")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "flops_train_step")
    card = card_line(device)
    b = BATCH[args.model]
    g, d = models(args.model, device, use_kernels=False)
    out = {"model": args.model, "backend": device.type, "counted_route": "plain",
           **run(g, d, b, PATCH, device)}
    rate = args.patches_per_sec
    if rate is None and device.type == "cuda":
        gk, dk = models(args.model, device, use_kernels=True)
        rate = step_rate(gk, dk, b, PATCH, device, STEPS)
    out["patches_per_sec"] = rate
    out["full_step_mfu_bf16_dense"] = (None if rate is None else
                                       flop_share(out["full_step_tflop_per_sample"], rate))
    out["card"] = card
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

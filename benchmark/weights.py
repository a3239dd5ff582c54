"""Seeded weights and inputs, made on the device in a few large calls.

Every stream the benchmark draws comes from `--seed` through `stream`:
one `torch.Generator` on the run's device per purpose, so the same seed
gives the same weights, frames, patches and interpolation weights on every
run, and the program under test and the reference take the same values.
"""

from __future__ import annotations

import math

import torch

# purposes of the seeded streams
GENERATOR, CRITIC, FRAMES, PATCHES, GP_ALPHA, LOADER, SAMPLE = range(7)


def stream(seed: int, purpose: int, device) -> torch.Generator:
    """The generator of one purpose of one seed (any seed below 2**62)."""
    return torch.Generator(device=device).manual_seed((seed * 7919 + purpose) % 2**62)


def subseed(seed: int, purpose: int) -> int:
    """A host seed below 2**31 for the program's own settings (its config
    seed, its loader's epoch order)."""
    return (seed * 7919 + purpose) % (2**31 - 1)


def seeded_state(rules: dict, shapes: dict, gen: torch.Generator, device) -> dict:
    """{name: float32 tensor} for each parameter, drawn by its rule
    (`benchmark.reference.nn`) from one uniform draw of every value."""
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=gen, device=device)
    state, at = {}, 0
    for name, rule in rules.items():
        n = math.prod(shapes[name])
        x = u[at:at + n].view(shapes[name])
        at += n
        kind = rule[0]
        if kind == "uniform":
            v = (2.0 * x - 1.0) * rule[1]
        elif kind == "const":
            v = torch.full_like(x, rule[1])
        elif kind == "log_uniform":
            v = torch.log(rule[1] + (rule[2] - rule[1]) * x)
        elif kind == "inv_softplus_log_uniform":
            lo, hi, floor = rule[1:]
            dt = torch.exp(x * (math.log(hi) - math.log(lo)) + math.log(lo)).clamp_min(floor)
            v = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"unknown draw rule {rule!r}")
        state[name] = v
    return state


def model_state(model, gen: torch.Generator, device) -> dict:
    """The seeded state of a reference model (`benchmark.reference`)."""
    from benchmark.reference.nn import rules

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return seeded_state(rules(model), shapes, gen, device)

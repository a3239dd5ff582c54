"""Command-line tools of the port, run with `python -m`.

The measuring tools (`bench_inference`, `bench_serving`, `bench_pipeline`,
`flops_train_step`) run on the card unless `--device cpu` (or
`device="cpu"`) is given, and print the card's `nvidia-smi` name and power
limit beside their numbers (`card_line`).
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(name: str, tool: str) -> torch.device:
    """`name` as a device; a card that is asked for and missing raises
    (the tools never fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device is available (pass --device cpu for the CPU)")
    return device


def card_line(device) -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` on a
    card, None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def seeded(net, kwargs: dict, device, seed: int = 0) -> torch.nn.Module:
    """`net(**kwargs)` on `device` with weights drawn from `seed`."""
    return net(**kwargs, device=device, generator=torch.Generator().manual_seed(seed))


def prod_generator(model: str, device, **overrides) -> torch.nn.Module:
    """The prod-width generator (`-cn prod`, bf16, num_gcp 0) with seeded
    weights: `afgsa` (AFGSANet) or `mamba` (MambaDenoiserNet)."""
    if model == "mamba":
        from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs

        return seeded(MambaDenoiserNet, dict(mamba_prod_kwargs(), **overrides), device)
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs

    return seeded(AFGSANet, dict(afgsa_prod_kwargs(), **overrides), device)


def prod_critic(device, seed: int = 1) -> torch.nn.Module:
    """The prod WGAN-GP critic as training builds it, DiscriminatorVGG(128,
    64) in `models.discriminators.GP_CRITIC_DTYPE`, with seeded weights."""
    from pixel_heal_thyself_tpu_torch.models.discriminators import (
        GP_CRITIC_DTYPE,
        DiscriminatorVGG,
    )

    return seeded(DiscriminatorVGG, dict(in_nc=3, base_nf=64, input_size=128,
                                         dtype=GP_CRITIC_DTYPE), device, seed)

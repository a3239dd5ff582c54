"""Profile one steady step of the port's prod GAN training step.

    python -m pixel_heal_thyself_tpu_torch.profile_training --model mamba [--multiscale]
    python -m pixel_heal_thyself_tpu_torch.profile_training --model afgsa [--film] [--multiscale]

Runs on one CUDA card (no JAX). Builds chip_smoke's phase 5 / phase 8 step
(`training.train_step.make_train_step`, WGAN-GP + L1, Adam with the
MultiStep schedule): the prod-width generator (`-cn prod`, `model=afgsa`
or `model=mamba`; seeded random weights, bf16, replicate padding) in train
mode against the prod critic (`tools.prod_critic`: DiscriminatorVGG(128,
64) in `models.discriminators.GP_CRITIC_DTYPE`, TF32 on as the trainer
sets it at bf16), batch 8 of 128² numpy patches; or phase 12's: `--film` the AFGSA generator with FiLM (the
literal route), `--multiscale` the multiscale spectral-norm critic (bf16)
with RaHinge, MS-SSIM and LPIPS on random weights. Times 8 steps unprofiled (the first 2 are warm-up), then profiles
2 more with `torch.profiler` and prints: the unprofiled steady s/step and
peak memory, the profiled steps' wall and device busy time, and device
time per step by kernel group (`profile_serving.GROUPS`), the port's
kernels by launch. For Mamba it also profiles K8 alone at the prod
training shape (8 × 16,384 tokens, bf16), per launch (`k8_stages`, which
chip_smoke's phase 8 prints too), and the body its launches took. The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch.profile_serving import group, mamba_layer_inputs, per_launch

PATCH, BATCH, WARMUP, TIMED, PROFILED = 128, 8, 2, 6, 2


def k8_stages(device) -> None:
    """K8's launches at the prod training shape: device time per call, at
    the states K7's emit variant saves for these inputs."""
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
        fused_mamba_chain_bwd_cuda,
        fused_mamba_chain_emit_cuda,
    )

    zx, params, dims = mamba_layer_inputs(device)
    _, states = fused_mamba_chain_emit_cuda(zx, *params, **dims)
    dy = torch.randn(zx.shape[0], zx.shape[1], dims["d_inner"], device=device,
                     generator=torch.Generator(device=device).manual_seed(1)).bfloat16()
    rows = per_launch(lambda: fused_mamba_chain_bwd_cuda(zx, *params, states, dy, **dims))
    print(f"[k8] per call at 8 × 16,384 tokens, bf16: total {sum(rows.values()):.4f} ms; "
          f"bodies {fused_mamba_chain_bwd_cuda.body_launches}")
    for label, ms in rows.items():
        print(f"[k8]   {label}: {ms:.4f} ms")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=["afgsa", "mamba"], default="mamba")
    parser.add_argument("--film", action="store_true", help="AFGSA with FiLM")
    parser.add_argument("--multiscale", action="store_true",
                        help="the multiscale critic with MS-SSIM and LPIPS (random weights)")
    args = parser.parse_args()
    if args.film and args.model != "afgsa":
        parser.error("--film is an AFGSA option")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = True  # as the trainer sets them at bf16
    torch.backends.cudnn.allow_tf32 = True
    from pixel_heal_thyself_tpu_torch.models.discriminators import MultiScaleDiscriminator
    from pixel_heal_thyself_tpu_torch.models.lpips import random_lpips_params
    from pixel_heal_thyself_tpu_torch.tools import prod_critic
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    if args.model == "mamba":
        from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet as Net
        from pixel_heal_thyself_tpu_torch.models.mamba import mamba_prod_kwargs as prod_kwargs
    else:
        from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet as Net
        from pixel_heal_thyself_tpu_torch.models.afgsa import afgsa_prod_kwargs as prod_kwargs
    kwargs = dict(prod_kwargs(), **({"use_film": True} if args.film else {}))
    g = Net(**kwargs, device=device, generator=torch.Generator().manual_seed(0)).train()
    d_gen = torch.Generator().manual_seed(1)
    if args.multiscale:
        d = MultiScaleDiscriminator(in_nc=3, patch_size=PATCH, dtype=torch.bfloat16,
                                    device=device, generator=d_gen).train()
    else:
        d = prod_critic(device, seed=1).train()
    rng = np.random.default_rng(0)
    data = {key: torch.from_numpy(val.astype(np.float32)).to(device) for key, val in {
        "noisy": np.abs(rng.standard_normal((BATCH, PATCH, PATCH, 3))),
        "gt": np.abs(rng.standard_normal((BATCH, PATCH, PATCH, 3))),
        "aux": rng.standard_normal((BATCH, PATCH, PATCH, 7)),
    }.items()}
    spec = make_optimizer(1e-4, [2], 0.5, 100)
    if args.multiscale:
        step = make_train_step(g, d, LossesConfig(use_ssim_loss=True, use_lpips_loss=True), True,
                               spec, spec, lpips_params=random_lpips_params(0, device=device))
    else:
        step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    gen = torch.Generator(device=device).manual_seed(7)

    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(WARMUP + TIMED):
        t0 = time.perf_counter()
        [val.item() for val in step(data, generator=gen).values()]  # syncs
        secs.append(time.perf_counter() - t0)
    steady = float(np.mean(secs[WARMUP:]))
    name = args.model + ("+film" if args.film else "") + ("+multiscale" if args.multiscale else "")
    print(f"[step] {name}: unprofiled s/step {[round(s, 4) for s in secs]}; steady "
          f"{steady:.4f} s/step = {BATCH / steady:.3f} patches/s; peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            [val.item() for val in step(data, generator=gen).values()]
        wall = (time.perf_counter() - t0) / PROFILED
    rows, launches = defaultdict(float), defaultdict(int)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.device_time_total > 0:
            rows[group(evt.key)] += evt.device_time_total / 1e3 / PROFILED
            launches[group(evt.key)] += evt.count
    busy = sum(rows.values())
    print(f"[step] profiled: wall {wall * 1e3:.1f} ms per step, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of the profiled wall)")
    for label, ms in sorted(rows.items(), key=lambda r: -r[1]):
        print(f"[step]   {label}: {ms:.2f} ms ({100 * ms / busy:.1f}%), "
              f"{launches[label] / PROFILED:g} launches per step")
    if args.model == "mamba" and not args.multiscale:
        k8_stages(device)


if __name__ == "__main__":
    main()

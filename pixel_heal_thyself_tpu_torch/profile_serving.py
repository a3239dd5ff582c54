"""Profile one steady 512² frame of the port's tiled serving path.

    python -m pixel_heal_thyself_tpu_torch.profile_serving --model mamba

Runs on one CUDA card (no JAX). Builds the prod-width generator (`-cn
prod`, `model=afgsa` or `model=mamba`; seeded random weights, bf16,
replicate padding), denoises chip_smoke's 3 synthetic 512² frames through
`inference.make_fused_frame_apply` (tile 64 + margin 32, batch 8) and
times them unprofiled (the first is warm-up), then profiles the last one
again with `torch.profiler` and prints: the unprofiled steady s/frame, the
profiled frame's wall time and device busy time, and device time by
kernel, the port's kernels grouped by launch. For Mamba it also profiles
K7 alone at the prod serving shape (8 × 16,384 tokens), per launch
(`per_launch`, which chip_smoke's phase 7 prints too), and the body its
launches took. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch

# kernel-name fragment → group, first match wins
GROUPS = [
    # K9/K10 (conv_silu.cu) and K11 (ssd_scan.cu): their names hold "conv"
    # and "chunk" too
    ("conv_silu_fwd", "K9 conv1d + SiLU"), ("conv_silu_bwd", "K10 main"),
    ("sum_tiles", "K10 tap/bias sums"), ("scan_cum", "K11 cum"),
    ("scan_chunk_state", "K11 chunk state"), ("scan_state_pass", "K11 state pass"),
    ("scan_state_tc", "K11 chunk state + carry"), ("scan_chunk_output", "K11 chunk output"),
    ("scan_output_tc", "K11 chunk output"),
    # K8's launches first: their names hold "conv" and "norm" too (the
    # chunk output and prologue K8 recomputes carry K7's names). Both bodies
    # share a label where they do the same work; the tensor-core body's
    # fused intra and head rest (ssd_intra_rest_tc_kernel) has its own
    ("ssd_norm_bwd", "K8 norm backward"), ("ssd_dstate_local", "K8 dstate local"),
    ("ssd_dstate_reverse", "K8 reverse state pass"), ("ssd_intra_rest", "K8 intra + head rest"),
    ("ssd_intra_bwd", "K8 intra"), ("ssd_head_bwd", "K8 head rest"),
    ("ssd_bc_bwd", "K8 dB/dC"), ("ssd_bc_tc", "K8 dB/dC"),
    ("ssd_conv_bwd", "K8 conv backward"), ("ssd_conv_transpose", "K8 conv transpose"),
    ("ssd_sum_parts", "K8 parameter sums"),
    ("ssd_chunk_output", "K7 chunk output"), ("ssd_chunk_state", "K7 chunk state"),
    ("ssd_state_pass", "K7 state pass"), ("ssd_prologue", "K7 prologue"),
    ("gated_rmsnorm", "K7 gated RMSNorm"),
    # K1 and K4: the tensor-core bodies (attention_fwd_tc_kernel,
    # attention_bwd_tc_kernel), the float32 and general ones, K4's gather
    # and bias reduce
    ("attention_fwd", "K1 attention"), ("attention_bwd", "K4 attention backward"),
    ("attention_bias_reduce", "K4 attention backward"),
    # K5: its Hopper body (conv3x3_dgrad_sm90_kernel) and general body, its
    # fold pre-pass; the ReLU gate pass that K5 and K6 run
    ("conv3x3_dgrad", "K5 conv3x3 dgrad"), ("dgrad_fold", "K5 fold pre-pass"),
    ("weight_grad", "K6 weight gradient"),
    ("sum_splits", "K6 weight gradient"), ("wgrad_kernel", "K6 weight gradient"),
    ("mask_kernel", "K5/K6 gate pass"), ("conv3x3_kernel", "K3 conv3x3"),
    # K2's Hopper body; its general body, and K3's for widths 8 does not
    # divide (cuBLAS names hold "gemm_bf16")
    ("pointwise_gemm", "K2 GEMM"), ("gemm_bf16_kernel", "K2 GEMM"),
    ("fprop", "cuDNN conv"), ("implicit", "cuDNN conv"), ("conv", "cuDNN conv"),
    ("cudnn", "cuDNN conv"), ("gemm", "cuBLAS GEMM"), ("Kernel2", "cuBLAS GEMM"),
    ("reduce", "reductions"),
    ("Memcpy", "copies"), ("elementwise", "elementwise"), ("index", "gather/scatter"),
]


def group(name: str, groups=GROUPS) -> str:
    for frag, label in groups:
        if frag.lower() in name.lower():
            return label
    return "other"


def per_launch(run, calls: int = 5, groups=GROUPS) -> dict:
    """Device time per call of `run` by label of `groups` (torch.profiler
    over `calls` calls after 2 warm-up calls), largest first."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    rows = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rows[group(evt.key, groups)] += evt.device_time_total / 1e3 / calls
    return dict(sorted(rows.items(), key=lambda r: -r[1]))


def mamba_layer_inputs(device, seed: int = 0) -> tuple:
    """(bf16 zxbcdt, f32 parameters, dims) of one prod Mamba2 layer call at
    8 × 16,384 tokens (d_inner 1024, d_state 64, 16 heads, chunk 128)."""
    b, l, di, n, h, q = 8, 16384, 1024, 64, 16, 128
    g = torch.Generator(device=device).manual_seed(seed)
    zx = (torch.randn(b, l, 2 * di + 2 * n + h, generator=g, device=device) * 0.5).bfloat16()
    params = (torch.randn(4, di + 2 * n, generator=g, device=device) * 0.2,
              torch.randn(di + 2 * n, generator=g, device=device) * 0.1,
              torch.full((h,), -2.5, device=device), -torch.ones(h, device=device),
              torch.ones(h, device=device), torch.ones(di, device=device))
    return zx, params, dict(d_inner=di, d_state=n, headdim=di // h, chunk=q)


def k7_stages(device) -> None:
    """K7's five launches at the prod serving shape: device time per call."""
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_cuda

    zx, params, dims = mamba_layer_inputs(device)
    rows = per_launch(lambda: fused_mamba_chain_cuda(zx, *params, **dims))
    print(f"[k7] per call at 8 × 16,384 tokens, bf16: total {sum(rows.values()):.4f} ms; "
          f"bodies {fused_mamba_chain_cuda.body_launches}")
    for label, ms in rows.items():
        print(f"[k7]   {label}: {ms:.4f} ms")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=["afgsa", "mamba"], default="mamba")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    device = torch.device("cuda")
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame_fused, make_fused_frame_apply
    from pixel_heal_thyself_tpu_torch.measure import synthetic_frames

    if args.model == "mamba":
        from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet as Net
        from pixel_heal_thyself_tpu_torch.models.mamba import mamba_prod_kwargs as prod_kwargs
    else:
        from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet as Net
        from pixel_heal_thyself_tpu_torch.models.afgsa import afgsa_prod_kwargs as prod_kwargs
    frames = synthetic_frames(3, 512)
    model = Net(**prod_kwargs(), device=device, generator=torch.Generator().manual_seed(0)).eval()
    fused = make_fused_frame_apply(model, (512, 512), device=device)
    secs = []
    for data in frames:
        t0 = time.perf_counter()
        denoise_frame_fused(fused, data, device=device)
        secs.append(time.perf_counter() - t0)
    steady = sum(secs[1:]) / len(secs[1:])
    print(f"[frame] {args.model}: unprofiled s/frame {secs}; steady {steady:.4f}")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        denoise_frame_fused(fused, frames[-1], device=device)
        wall = time.perf_counter() - t0
    rows, launches = defaultdict(float), defaultdict(int)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.device_time_total > 0:
            rows[group(evt.key)] += evt.device_time_total / 1e3
            launches[group(evt.key)] += evt.count
    busy = sum(rows.values())
    print(f"[frame] profiled wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of the profiled wall)")
    for label, ms in sorted(rows.items(), key=lambda r: -r[1]):
        print(f"[frame]   {label}: {ms:.2f} ms ({100 * ms / busy:.1f}%), {launches[label]} launches")
    if args.model == "mamba":
        k7_stages(device)


if __name__ == "__main__":
    main()

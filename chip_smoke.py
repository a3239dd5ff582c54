#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc.
It imports torch, numpy, scipy and the port (`pixel_heal_thyself_tpu_torch`
plus the JAX package's jax-free host modules), never JAX, and fails loudly:
any mismatch or exception exits non-zero. Phases:

1. Device: the card's name and `nvidia-smi` name/power limit.
2. Build: compile `pixel_heal_thyself_tpu_torch/csrc/*.cu` into
   `build/kernels/` (or load the library built from the same sources).
3. Kernels against their plain PyTorch versions at the prod shapes
   (8 × 128² × 256, 4 heads, halo 3): attention K1 in bf16 and fp32, the
   pointwise GEMM K2, the 3×3 conv K3, and the whole TransformerBlock in
   the three padding modes, with TF32 off. Prints deviations and CUDA-event
   times of kernel and plain version.
4. The slice: three synthetic 512² frame pairs denoised by the prod-width
   AFGSANet (seeded random weights, bf16, replicate padding) through
   `preprocess_data` and the device tiler (tile 64, margin 32, batch 8),
   the path `inference.run_inference` takes. Checks the outputs, that every
   block of every batch went through K1, K2 and K3 (launch counters), and
   frame 0 against the model's plain path on the card.

Before the last line it prints one JSON line of per-kernel results; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import subprocess
import tempfile
import time

import numpy as np
import torch

SHAPE = (8, 128, 128, 256)  # prod: 8 tiles of 128² at base_ch 256
BS, HALO, HEADS = 8, 3, 4
MODES = ("replicate", "reflect", "zeros")
# kernel vs plain, relative to the plain output's largest magnitude:
# fp32 attention differs only in f32 summation order; a bf16 kernel may
# round an f32 sum that sits on a rounding boundary the other way (two
# bf16 ulps = 2**-7); a whole block carries such flips through the bf16
# probabilities and two convs (the single-block golden bounds of
# tests/test_block_mega.py)
TOL = {"fp32": (1e-5, 1e-6), "bf16": (2**-7, 2e-3), "block": (3e-2, 4e-3)}
# frame 0, kernel path vs plain path on the card: held to the same bounds
# as one block, i.e. the five blocks, encoders and decoder together may
# drift from the plain path no more than one TPU block kernel drifts from
# its XLA chain (measured on the H100: 3.7e-3 max, 2.6e-4 rms, PERF.md)
FRAME_TOL = (3e-2, 4e-3)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def deviation(got: torch.Tensor, ref: torch.Tensor) -> dict:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel output")
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    return {
        "max_abs_err": err.max().item(),
        "max_rel": err.max().item() / scale,
        "rms_rel": err.pow(2).mean().sqrt().item() / scale,
    }


def check(name: str, dev: dict, tol: tuple) -> None:
    if dev["max_rel"] > tol[0] or dev["rms_rel"] > tol[1]:
        raise AssertionError(f"{name}: {dev} exceeds (max_rel, rms_rel) ≤ {tol}")


def phase_kernels(device) -> dict:
    from pixel_heal_thyself_tpu_torch.ops.attention import block_halo_attention_torch
    from pixel_heal_thyself_tpu_torch.ops.attention_cuda import block_halo_attention_cuda
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
        conv3x3_cuda,
        conv3x3_torch,
        pointwise_gemm_cuda,
        pointwise_gemm_torch,
        transformer_block_fwd,
        transformer_block_torch,
    )

    g = torch.Generator(device=device).manual_seed(1234)
    bf = torch.bfloat16
    b, h, w, c = SHAPE
    window = BS + 2 * HALO

    def rand(shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    x, a = rand(SHAPE), rand(SHAPE)
    q, k, v = rand(SHAPE), rand(SHAPE), rand(SHAPE)
    wts = dict(
        wcat=rand((2 * c, c), (2 * c) ** -0.5), bcat=rand((c,), 0.1),
        wq=rand((c, c), c**-0.5), wk=rand((c, c), c**-0.5), wv=rand((c, c), c**-0.5),
        rel_h=rand((window, c // HEADS // 2), dtype=torch.float32),
        rel_w=rand((window, c // HEADS // 2), dtype=torch.float32),
        w1=rand((9 * c, c), (9 * c) ** -0.5), b1=rand((c,), 0.1),
        w2=rand((9 * c, c), (9 * c) ** -0.5), b2=rand((c,), 0.1),
    )
    att = dict(block_size=BS, halo_size=HALO, num_heads=HEADS)

    def compare(name, kernel, plain, tol, iters=10, plain_iters=3):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        dev = deviation(got, ref)
        check(name, dev, tol)
        ms, plain_ms = cuda_ms(kernel, iters), cuda_ms(plain, plain_iters, warmup=1)
        log(f"[kernels] {name}: max_abs_err {dev['max_abs_err']:.6g} "
            f"max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        return {**dev, "ms": ms, "plain_ms": plain_ms}

    res_k1 = compare(
        "K1 attention bf16",
        lambda: block_halo_attention_cuda(q, k, v, wts["rel_h"], wts["rel_w"], **att),
        lambda: block_halo_attention_torch(q, k, v, wts["rel_h"], wts["rel_w"], **att),
        TOL["bf16"],
    )
    qf, kf, vf = q.float(), k.float(), v.float()
    compare(
        "K1 attention fp32",
        lambda: block_halo_attention_cuda(qf, kf, vf, wts["rel_h"], wts["rel_w"], **att),
        lambda: block_halo_attention_torch(qf, kf, vf, wts["rel_h"], wts["rel_w"], **att),
        TOL["fp32"],
    )
    nx = (x, wts["wcat"][:c], a, wts["wcat"][c:], wts["bcat"], True)
    res_k2 = compare(
        "K2 pointwise GEMM (n_aux: [x;a]·Wcat + b, relu)",
        lambda: pointwise_gemm_cuda(*nx), lambda: pointwise_gemm_torch(*nx), TOL["bf16"],
    )
    cv = (x, wts["w1"], wts["b1"], "replicate", True, a)
    res_k3 = compare(
        "K3 conv3x3 (replicate, relu, residual)",
        lambda: conv3x3_cuda(*cv), lambda: conv3x3_torch(*cv), TOL["bf16"],
    )
    for mode in MODES:
        blk = dict(att, padding_mode=mode)
        compare(
            f"TransformerBlock {mode} (K2→K1→K3→K3)",
            lambda: transformer_block_fwd(x, a, **wts, **blk),
            lambda: transformer_block_torch(x, a, **wts, **blk),
            TOL["block"], iters=5, plain_iters=2,
        )
    # keyed by the wrapper whose `launches` counts the kernel
    return {
        "block_halo_attention_cuda": dict(
            name="block_halo_attention_fwd (K1)", route="cuda",
            source="pixel_heal_thyself_tpu_torch/csrc/attention_fwd.cu",
            replaces="pixel_heal_thyself_tpu/ops/attention_pallas.py:217", res=res_k1),
        "pointwise_gemm_cuda": dict(
            name="pointwise_gemm (K2)", route="cuda",
            source="pixel_heal_thyself_tpu_torch/csrc/block_fwd.cu",
            replaces="pixel_heal_thyself_tpu/ops/block_mega.py:413", res=res_k2),
        "conv3x3_cuda": dict(
            name="conv3x3 (K3)", route="cuda",
            source="pixel_heal_thyself_tpu_torch/csrc/block_fwd.cu",
            replaces="pixel_heal_thyself_tpu/ops/block_mega.py:413", res=res_k3),
    }


def phase_slice(device) -> dict:
    from pixel_heal_thyself_tpu.data.preprocessing import preprocess_data
    from pixel_heal_thyself_tpu.data.synthetic import generate_dataset
    from pixel_heal_thyself_tpu_torch.inference import (
        denoise_frame_fused,
        find_frame_pairs,
        make_fused_frame_apply,
    )
    from pixel_heal_thyself_tpu_torch.models.afgsa import (
        AFGSANet,
        afgsa_prod_kwargs,
        count_params,
    )
    from pixel_heal_thyself_tpu_torch.ops.attention_cuda import block_halo_attention_cuda
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import conv3x3_cuda, pointwise_gemm_cuda

    size, n_frames, tile, margin, batch = 512, 3, 64, 32, 8
    kwargs = afgsa_prod_kwargs()
    model = AFGSANet(**kwargs, device=device, generator=torch.Generator().manual_seed(0)).eval()
    with tempfile.TemporaryDirectory() as tmp:
        generate_dataset(tmp, scenes=[f"scene{i}_0" for i in range(n_frames)],
                         height=size, width=size, seed=0)
        frames = [preprocess_data(n, g) for _, n, g in find_frame_pairs(tmp, 32, 1024)]
    log(f"[slice] AFGSANet prod width: {count_params(model)} params, "
        f"{n_frames} synthetic {size}² frames, tile {tile} + margin {margin}, batch {batch}")

    fused = make_fused_frame_apply(model, (size, size), tile=tile, margin=margin,
                                   batch_tiles=batch, device=device)
    counters = (block_halo_attention_cuda, pointwise_gemm_cuda, conv3x3_cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    outs, secs = [], []
    for data in frames:
        t0 = time.perf_counter()
        outs.append(denoise_frame_fused(fused, data, device=device))  # syncs: copies to host
        secs.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()

    n_batches = math.ceil((size // tile) ** 2 / batch)
    need = kwargs["num_sa"] * n_batches * n_frames
    for out in outs:
        if out.shape != (size, size, 3) or not np.isfinite(out).all():
            raise AssertionError(f"bad frame output {out.shape}, finite={np.isfinite(out).all()}")
    for name, count in launches.items():
        if count < need:
            raise AssertionError(f"{name} launched {count} times < {need} (5 blocks × batches × frames)")
    log(f"[slice] launches {launches} (need ≥ {need} each)")
    steady = float(np.mean(secs[1:]))
    log(f"[slice] seconds per frame {[round(s, 4) for s in secs]} (first includes warm-up); "
        f"steady {steady:.4f} s/frame = {1 / steady:.3f} frames/s; "
        f"peak memory {peak} B ({peak / 2**30:.3f} GiB)")

    plain = AFGSANet(**dict(kwargs, use_kernels=False), device=device).eval()
    plain.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    ref = denoise_frame_fused(
        make_fused_frame_apply(plain, (size, size), tile=tile, margin=margin,
                               batch_tiles=batch, device=device),
        frames[0], device=device,
    )
    plain_s = time.perf_counter() - t0
    dev = deviation(torch.from_numpy(outs[0]), torch.from_numpy(ref))
    log(f"[slice] frame 0 kernel path vs plain path on the card: "
        f"max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} "
        f"(bound {FRAME_TOL}); plain path {plain_s:.4f} s/frame")
    check("frame 0", dev, FRAME_TOL)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pixel_heal_thyself_tpu_torch import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {kind}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {_build.library_path().name}: {time.perf_counter() - t0:.2f} s "
        "(nvcc build or load)")

    kernels = phase_kernels(device)
    launches = phase_slice(device)
    line = []
    for fn_name, k in kernels.items():
        res = k.pop("res")
        line.append({**k, "launches": launches[fn_name], "max_abs_err": res["max_abs_err"],
                     "ms": res["ms"], "plain_ms": res["plain_ms"]})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc.
It imports torch, numpy, scipy and the port (`pixel_heal_thyself_tpu_torch`),
never JAX or the JAX package, and fails loudly: any mismatch or exception
exits non-zero. Phases:

1. Device: the card's name and `nvidia-smi` name/power limit.
2. Build: compile `pixel_heal_thyself_tpu_torch/csrc/*.cu` into
   `build/kernels/` (or load the library built from the same sources).
3. Kernels against their plain PyTorch versions at the prod shapes
   (8 × 128² × 256, 4 heads, halo 3), with TF32 off: attention K1 in bf16
   and fp32 (and at halo 8, its key-chunked path), the pointwise GEMM K2,
   the 3×3 conv K3, the whole TransformerBlock forward in the three
   padding modes; the attention backward K4 (bf16, fp32), the conv input
   gradient K5, the weight gradient K6 (9 taps and 1 tap) and the whole
   block backward in the three padding modes. Prints deviations and
   CUDA-event times of kernel and plain version.
4. Serving: three synthetic 512² frame pairs denoised by the prod-width
   AFGSANet (seeded random weights, bf16, replicate padding) through
   `preprocess_data` and the device tiler (tile 64, margin 32, batch 8),
   the path `inference.run_inference` takes. Checks the outputs, that every
   block of every batch went through K1, K2 and K3 (launch counters), and
   frame 0 against the model's plain path on the card.
5. Training: the prod GAN step (`training.train_step.make_train_step`,
   WGAN-GP + L1, Adam with the MultiStep schedule) on the prod-width
   AFGSANet in train mode and DiscriminatorVGG(128, 64, bf16), seeded
   random weights, batch 8 of 128² numpy patches: 2 warm-up and 5 timed
   steps. Checks finite losses, that every block of every step ran its
   backward through K4, K5 and K6 (launch counters), prints patches/s and
   peak memory, then one step from identical state (with a float32
   critic, see STEP_LOSS_TOL, and cuDNN's deterministic algorithms)
   through the kernel route and the plain route on the card, beside the
   witnesses of the bf16 flip floor that set STEP_GRAD_TOL.
6. A small fp32 literal-route step (2 blocks, 64² patches, batch 2): K1
   fp32 forward and K4 backward through `BlockHaloAttentionFn`, against
   the plain route.
7. Mamba serving: the fused Mamba2 interior K7 against its plain version
   at the prod serving shape (8 windows of 128² = 16,384 tokens, d_inner
   1024, d_state 64, 16 heads, chunk 128) in bf16 and fp32, beside a
   control that the bf16 bound must fail (the plain chain with xBC and y
   rounded to bf16, which the TPU kernel never does); then three
   synthetic 512² frames denoised by the prod-width MambaDenoiserNet
   (seeded random weights, bf16, replicate padding) through the device
   tiler. Checks the outputs, that every layer of every batch went through
   K7 (launch counter), and frame 0 against the model's plain path.

Every kernel row states its bound (the least time the card could take:
the larger of the bytes its function must move over 3.35 TB/s and its
operations over the peak rate of their type, `measure.bound` of the
port) and, where one PyTorch call
computes the same function, that call's time. Before the last line it
prints one JSON line of per-kernel results; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

SHAPE = (8, 128, 128, 256)  # prod: 8 tiles of 128² at base_ch 256
BS, HALO, HEADS = 8, 3, 4
# phase 5: bench.py:_bench_afgsa geometry; phase 6: a small fp32 step
TRAIN = dict(patch=128, batch=8, warmup=2, timed=5)
LITERAL = dict(patch=64, batch=2, num_sa=2)
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
# weight gradients (K6): f32 sums of bf16 products, which are exact in f32;
# only the summation order differs, but over K = 131,072 pixels an f32 sum
# carries about sqrt(K) * 2**-24 = 2e-5 relative error per element
WGRAD_TOL = (1e-4, 1e-5)
# whole-block gradients, and the generator's gradients of a training step,
# kernel route vs plain route: the bounds of tests/test_block_mega.py:
# 238-260 (images max 1e-1, rms 8e-3; weights rms 2.5e-2, total-mass
# fingerprint 2e-2): a bf16 pre-activation within one ulp of zero may land
# on the other side of a ReLU and move a full-size contribution
IMAGE_GRAD_TOL = (1e-1, 8e-3)
PARAM_GRAD_TOL = (2.5e-2, 2e-2)
# a prod training step, kernel route vs plain route: losses within 1e-2
# relative (the bf16 forward rounds at the same points; flips move it).
# The pair runs with a float32 critic: through the bf16 critic the GP's
# double backward re-rolls bf16 rounding for any change of its input, and
# d_loss moved 2.7% between the routes while a route repeated gave the
# same bits (H100 run, PERF.md Findings), which would test the critic, not
# the generator's kernels
STEP_LOSS_TOL = 1e-2
# ... and the generator's gradients of that step: rms 2.5e-2 (the block
# bound) for every one; total mass 5e-2. Through 5 blocks, encoders and
# decoder, the mass of the cancelling-sum gradients (rel-pos embeddings,
# biases, q/k projections: sums over every pixel or key) moves more than
# one block's. The kernel route reads worst mass 2.27e-2
# (blocks.4.attention.rel_w), rms 1.71e-2; two witnesses of what bf16
# rounding alone does, each against the plain route, read about as much
# or more: the plain literal route (other rounding points) worst mass
# 2.0e-2, rms 1.64e-2; the plain route with every input one bf16 ulp up
# worst mass 5.5e-2, rms 3.1e-2, rel_w 3.4e-2; the same route repeated
# reads mass 4e-4 (H100 runs, PERF.md Findings). So the single-block 2e-2 sits below
# the flip floor of a whole model, and 5e-2, at that floor, still fails a
# gradient that is missing, doubled or misplaced. Phase 5 prints the
# witnesses and the repeat beside the kernel route's reading
STEP_GRAD_TOL = (2.5e-2, 5e-2)
# the fp32 literal-route step (phase 6): K1/K4 differ from their plain
# versions only in f32 summation order (3.7e-7 in phase 3). The generator
# gradient passes through the updated critic, and Adam's first step moves
# every critic weight by ±lr whatever its gradient's size, so noise in a
# near-zero critic gradient moves the generator's: with cuDNN's
# nondeterministic weight gradients two runs read max_rel 3.0e-4 and
# 1.09e-3; with its deterministic algorithms (`deterministic_cudnn`)
# 1.4e-6 and 1.6e-6, rms 2.4e-7, against a same-route floor of 1.5e-6
# (H100 runs, PERF.md Findings). Losses 1e-4; gradients max 1e-3, rms 1e-4
FP32_STEP_TOL = (1e-4, (1e-3, 1e-4))
# K7 (the fused Mamba2 interior) against its plain version: both keep every
# intermediate in f32 and round once, at the output. In fp32 only the
# summation order differs. In bf16 an f32 value next to a rounding boundary
# may round the other way (max: two bf16 ulps of the largest output, 8e-3);
# such flips are rare, so the rms stays small: 3.9e-7 at the prod shape,
# while the plain chain with xBC and y rounded to bf16 (which the TPU kernel
# never does) reads about 1e-4 (H100 runs, PERF.md Findings). The rms bound
# 1e-5 sits between, and phase 7 fails if that control passes it
MAMBA_TOL = {"bf16": (8e-3, 1e-5), "fp32": (1e-4, 1e-5)}
# phase 7: 8 windows of 128² = 16,384 tokens per Mamba2 layer call
MAMBA = dict(batch=8, tokens=128 * 128)
_SRC = "pixel_heal_thyself_tpu_torch/csrc/"
_TPU = "pixel_heal_thyself_tpu/ops/"
# kernel → (name, source, TPU kernel it replaces)
KERNELS = {
    "K1": ("block_halo_attention_fwd (K1)", _SRC + "attention_fwd.cu",
           _TPU + "attention_pallas.py:217"),
    "K2": ("pointwise_gemm (K2)", _SRC + "block_fwd.cu", _TPU + "block_mega.py:413"),
    "K3": ("conv3x3 (K3)", _SRC + "block_fwd.cu", _TPU + "block_mega.py:413"),
    "K4": ("block_halo_attention_bwd (K4)", _SRC + "attention_bwd.cu",
           _TPU + "attention_pallas.py:383"),
    "K5": ("conv3x3_dgrad (K5)", _SRC + "block_bwd.cu", _TPU + "block_mega.py:662"),
    "K6": ("weight_grad (K6)", _SRC + "block_bwd.cu", _TPU + "block_mega.py:662"),
    "K7": ("fused_mamba_chain (K7)", _SRC + "ssd_fwd.cu", _TPU + "ssd_mega.py:256"),
}
KERNEL_NAMES = tuple(KERNELS)


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


def deviation(got, ref) -> dict:
    """Worst deviation over one output or a tuple of outputs, each relative
    to its reference's largest magnitude."""
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    worst = {"max_abs_err": 0.0, "max_rel": 0.0, "rms_rel": 0.0}
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        if not torch.isfinite(g).all():
            raise AssertionError("non-finite kernel output")
        err = (g - r).abs()
        scale = r.abs().max().item() + 1e-30
        dev = {"max_abs_err": err.max().item(), "max_rel": err.max().item() / scale,
               "rms_rel": err.pow(2).mean().sqrt().item() / scale}
        worst = {k: max(worst[k], dev[k]) for k in worst}
    return worst


def check(name: str, dev: dict, tol: tuple) -> None:
    if dev["max_rel"] > tol[0] or dev["rms_rel"] > tol[1]:
        raise AssertionError(f"{name}: {dev} exceeds (max_rel, rms_rel) ≤ {tol}")


def check_grads(name: str, got, ref, image: tuple) -> dict:
    """Gradients against a reference at the whole-block bounds: `image[i]`
    says whether output i is an image gradient (max/rms bounds) or a
    weight gradient (rms/total-mass bounds). Returns the worst deviation."""
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}[{i}]: non-finite gradient")
        scale = r.abs().max().item() + 1e-30
        err = g - r
        rms = err.pow(2).mean().sqrt().item() / scale
        if image[i]:
            mx = err.abs().max().item() / scale
            if mx > IMAGE_GRAD_TOL[0] or rms > IMAGE_GRAD_TOL[1]:
                raise AssertionError(f"{name}[{i}]: max {mx:.3e} rms {rms:.3e} > {IMAGE_GRAD_TOL}")
        else:
            mass = abs(g.abs().sum().item() - r.abs().sum().item()) / (r.abs().sum().item() + 1e-30)
            if rms > PARAM_GRAD_TOL[0] or mass > PARAM_GRAD_TOL[1]:
                raise AssertionError(f"{name}[{i}]: rms {rms:.3e} mass {mass:.3e} > {PARAM_GRAD_TOL}")
    return deviation(got, ref)


def counters() -> dict:
    """The launch-counting kernel wrappers, by kernel name."""
    from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
        block_halo_attention_bwd_cuda,
        block_halo_attention_cuda,
    )
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
        conv3x3_cuda,
        conv3x3_dgrad_cuda,
        pointwise_gemm_cuda,
        weight_grad_cuda,
    )
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_cuda

    return dict(zip(KERNEL_NAMES, (block_halo_attention_cuda, pointwise_gemm_cuda,
                                   conv3x3_cuda, block_halo_attention_bwd_cuda,
                                   conv3x3_dgrad_cuda, weight_grad_cuda,
                                   fused_mamba_chain_cuda)))


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def nbytes(*tensors) -> int:
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def compare(name, kernel, plain, tol, iters=10, plain_iters=3, grads=None, work=None,
            library=None):
    """A kernel against its plain version on the same inputs: deviation
    (checked against `tol`, or the gradient bounds), CUDA-event times of
    both, the bound from `work` = (bytes, flops, dtype) and the time of
    `library`, one PyTorch call computing the same function."""
    from pixel_heal_thyself_tpu_torch.measure import bound

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    if grads is None:
        dev = deviation(got, ref)
        check(name, dev, tol)
    else:
        dev = check_grads(name, got, ref, grads)
    del got, ref
    ms, plain_ms = cuda_ms(kernel, iters), cuda_ms(plain, plain_iters, warmup=1)
    res = {**dev, "ms": ms, "plain_ms": plain_ms, "library_ms": None}
    if work is not None:
        res.update(bound(*work))
    if library is not None:
        res["library_ms"] = cuda_ms(library, iters)
    log(f"[kernels] {name}: max_abs_err {dev['max_abs_err']:.6g} "
        f"max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        + (f", bound {res['bound_ms']:.4f} ms ({res['bound_by']})" if work else "")
        + (f", library {res['library_ms']:.4f} ms" if library else ""))
    return res


def phase_kernels(device) -> dict:
    """Phase 3. Returns {kernel name: its first row's result}."""
    from pixel_heal_thyself_tpu_torch.ops.attention import (
        block_halo_attention_bwd_torch,
        block_halo_attention_torch,
    )
    from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
        block_halo_attention_bwd_cuda,
        block_halo_attention_cuda,
    )
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
        PARAM_NAMES,
        conv3x3_cuda,
        conv3x3_dgrad_cuda,
        conv3x3_dgrad_torch,
        conv3x3_torch,
        pointwise_gemm_cuda,
        pointwise_gemm_torch,
        transformer_block_bwd,
        transformer_block_bwd_torch,
        transformer_block_fwd,
        transformer_block_torch,
        weight_grad_cuda,
        weight_grad_torch,
    )
    from pixel_heal_thyself_tpu_torch.ops.padding import pad2d

    g = torch.Generator(device=device).manual_seed(1234)
    bf = torch.bfloat16
    b, h, w, c = SHAPE
    window = BS + 2 * HALO

    def rand(shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    x, a = rand(SHAPE), rand(SHAPE)
    q, k, v, do = rand(SHAPE), rand(SHAPE), rand(SHAPE), rand(SHAPE)
    wts = dict(
        wcat=rand((2 * c, c), (2 * c) ** -0.5), bcat=rand((c,), 0.1),
        wq=rand((c, c), c**-0.5), wk=rand((c, c), c**-0.5), wv=rand((c, c), c**-0.5),
        rel_h=rand((window, c // HEADS // 2), dtype=torch.float32),
        rel_w=rand((window, c // HEADS // 2), dtype=torch.float32),
        w1=rand((9 * c, c), (9 * c) ** -0.5), b1=rand((c,), 0.1),
        w2=rand((9 * c, c), (9 * c) ** -0.5), b2=rand((c,), 0.1),
    )
    att = dict(block_size=BS, halo_size=HALO, num_heads=HEADS)
    pixels = b * h * w
    conv_flops = 2 * pixels * 9 * c * c  # one 3×3 conv, its dgrad or wgrad
    attn_flops = 2 * 2 * pixels * window**2 * c  # q·k and p·v over every window
    # the library yardsticks (never called by the port): NCHW views of the
    # NHWC tensors (channels-last memory) for cuDNN
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    oihw = lambda wt: wt.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(  # noqa: E731
        memory_format=torch.channels_last)
    xa = torch.cat([x, a], dim=-1).reshape(pixels, 2 * c)
    xp = pad2d(x, 1, "replicate")
    w1k, w2k = oihw(wts["w1"]), oihw(wts["w2"])

    res = {}
    res["K1"] = compare(
        "K1 attention bf16",
        lambda: block_halo_attention_cuda(q, k, v, wts["rel_h"], wts["rel_w"], **att),
        lambda: block_halo_attention_torch(q, k, v, wts["rel_h"], wts["rel_w"], **att),
        TOL["bf16"], work=(nbytes(q, k, v, wts["rel_h"], wts["rel_w"], q), attn_flops, bf),
    )
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    compare(
        "K1 attention fp32",
        lambda: block_halo_attention_cuda(qf, kf, vf, wts["rel_h"], wts["rel_w"], **att),
        lambda: block_halo_attention_torch(qf, kf, vf, wts["rel_h"], wts["rel_w"], **att),
        TOL["fp32"],
    )
    # halo 8 at head_ch 64: the one-stage plan exceeds 227 KB in both
    # dtypes, so K1 walks the keys in chunks
    big = dict(att, halo_size=8)
    rel8 = [rand((BS + 16, c // HEADS // 2), dtype=torch.float32) for _ in range(2)]
    for dt, tol, (qq, kk, vv) in (("bf16", TOL["bf16"], (q, k, v)),
                                  ("fp32", TOL["fp32"], (qf, kf, vf))):
        compare(
            f"K1 attention {dt} halo 8 (key-chunked)",
            lambda qq=qq, kk=kk, vv=vv: block_halo_attention_cuda(qq, kk, vv, *rel8, **big),
            lambda qq=qq, kk=kk, vv=vv: block_halo_attention_torch(qq, kk, vv, *rel8, **big),
            tol, iters=3, plain_iters=1,
        )
    nx = (x, wts["wcat"][:c], a, wts["wcat"][c:], wts["bcat"], True)
    res["K2"] = compare(
        "K2 pointwise GEMM (n_aux: [x;a]·Wcat + b, relu)",
        lambda: pointwise_gemm_cuda(*nx), lambda: pointwise_gemm_torch(*nx), TOL["bf16"],
        work=(nbytes(x, a, wts["wcat"], wts["bcat"], x), 2 * pixels * 2 * c * c, bf),
        library=lambda: torch.addmm(wts["bcat"], xa, wts["wcat"]),
    )
    cv = (x, wts["w1"], wts["b1"], "replicate", True, a)
    res["K3"] = compare(
        "K3 conv3x3 (replicate, relu, residual)",
        lambda: conv3x3_cuda(*cv), lambda: conv3x3_torch(*cv), TOL["bf16"],
        work=(nbytes(x, wts["w1"], wts["b1"], a, x), conv_flops, bf),
        library=lambda: F.conv2d(nchw(xp), w1k, wts["b1"]),
    )
    for mode in MODES:
        blk = dict(att, padding_mode=mode)
        compare(
            f"TransformerBlock {mode} (K2→K1→K3→K3)",
            lambda: transformer_block_fwd(x, a, **wts, **blk),
            lambda: transformer_block_torch(x, a, **wts, **blk),
            TOL["block"], iters=5, plain_iters=2,
        )
    # ---- backward kernels -------------------------------------------------
    ab = (wts["rel_h"], wts["rel_w"])
    res["K4"] = compare(
        "K4 attention backward bf16 (dq, dk, dv, drel_h, drel_w)",
        lambda: block_halo_attention_bwd_cuda(q, k, v, *ab, do, **att),
        lambda: block_halo_attention_bwd_torch(q, k, v, *ab, do, **att),
        TOL["bf16"], iters=5, plain_iters=2,
        # five window products: logits, dP, dV, dQ, dK
        work=(nbytes(q, k, v, do, *ab) + nbytes(q, k, v, *ab), attn_flops * 5 // 2, bf),
    )
    compare(
        "K4 attention backward fp32",
        lambda: block_halo_attention_bwd_cuda(qf, kf, vf, *ab, dof, **att),
        lambda: block_halo_attention_bwd_torch(qf, kf, vf, *ab, dof, **att),
        TOL["fp32"], iters=5, plain_iters=2,
    )
    dg = (do, a, wts["w2"], "replicate", x)
    res["K5"] = compare(
        "K5 conv3x3 input gradient (replicate, ReLU mask, residual)",
        lambda: conv3x3_dgrad_cuda(*dg), lambda: conv3x3_dgrad_torch(*dg), TOL["bf16"],
        work=(nbytes(do, a, wts["w2"], x, x), conv_flops, bf),
        library=lambda: torch.nn.grad.conv2d_input(tuple(nchw(xp).shape), w2k, nchw(do)),
    )
    wg9 = dict(taps=9, padding_mode="replicate", colsum=True)
    res["K6"] = compare(
        "K6 weight gradient, 9 taps (replicate, ReLU mask, db)",
        lambda: weight_grad_cuda(x, do, a, **wg9), lambda: weight_grad_torch(x, do, a, **wg9),
        WGRAD_TOL,
        work=(nbytes(x, do, a) + 4 * (9 * c * c + c), conv_flops, bf),
        library=lambda: torch.nn.grad.conv2d_weight(nchw(xp), w1k.shape, nchw(do)),
    )
    compare(
        "K6 weight gradient, 1 tap ([x; a]ᵀ·dz, db)",
        lambda: weight_grad_cuda(x, do, None, a, colsum=True),
        lambda: weight_grad_torch(x, do, None, a, colsum=True),
        WGRAD_TOL,
    )
    blk = dict(att, padding_mode="replicate")
    _, x1, f1, f2 = transformer_block_torch(x, a, **wts, **blk, emit=True)
    image = (True, True) + (False,) * len(PARAM_NAMES)
    for mode in MODES:
        blk = dict(att, padding_mode=mode)
        compare(
            f"TransformerBlock backward {mode} (K6/K5→K6/K5→K4→K6/K2)",
            lambda: transformer_block_bwd(x, a, x1, f1, f2, do, **wts, **blk),
            lambda: transformer_block_bwd_torch(x, a, x1, f1, f2, do, **wts, **blk),
            None, iters=3, plain_iters=1, grads=image,
        )
    return res


SERVE = dict(size=512, frames=3, tile=64, margin=32, batch=8)


def serve(device, frames, net, kwargs, layers: int, names: tuple, tag: str) -> dict:
    """Denoise `frames` with `net(**kwargs)` (seeded random weights) through
    the device tiler, the path `inference.run_inference` takes: checks the
    outputs, that each kernel in `names` ran for every one of `layers`
    layers of every batch (launch counters), and frame 0 against the
    model's plain path on the card. Returns the launch counts."""
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame_fused, make_fused_frame_apply
    from pixel_heal_thyself_tpu_torch.models.afgsa import count_params

    size, tile, margin, batch = (SERVE[k] for k in ("size", "tile", "margin", "batch"))
    model = net(**kwargs, device=device, generator=torch.Generator().manual_seed(0)).eval()
    log(f"[{tag}] {net.__name__} prod width: {count_params(model)} params, "
        f"{len(frames)} synthetic {size}² frames, tile {tile} + margin {margin}, batch {batch}")

    fused = make_fused_frame_apply(model, (size, size), tile=tile, margin=margin,
                                   batch_tiles=batch, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, secs = [], []
    for data in frames:
        t0 = time.perf_counter()
        outs.append(denoise_frame_fused(fused, data, device=device))  # syncs: copies to host
        secs.append(time.perf_counter() - t0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    n_batches = math.ceil((size // tile) ** 2 / batch)
    need = layers * n_batches * len(frames)
    for out in outs:
        if out.shape != (size, size, 3) or not np.isfinite(out).all():
            raise AssertionError(f"bad frame output {out.shape}, finite={np.isfinite(out).all()}")
    for name in names:
        if launches[name] < need:
            raise AssertionError(f"{name} launched {launches[name]} times < {need} "
                                 f"({layers} layers × {n_batches} batches × {len(frames)} frames)")
    log(f"[{tag}] launches {launches} (need ≥ {need} each of {', '.join(names)})")
    steady = float(np.mean(secs[1:]))
    log(f"[{tag}] seconds per frame {[round(s, 4) for s in secs]} (first includes warm-up); "
        f"steady {steady:.4f} s/frame = {1 / steady:.3f} frames/s; "
        f"peak memory {peak} B ({peak / 2**30:.3f} GiB)")

    plain = net(**dict(kwargs, use_kernels=False), device=device).eval()
    plain.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    ref = denoise_frame_fused(
        make_fused_frame_apply(plain, (size, size), tile=tile, margin=margin,
                               batch_tiles=batch, device=device),
        frames[0], device=device,
    )
    plain_s = time.perf_counter() - t0
    dev = deviation(torch.from_numpy(outs[0]), torch.from_numpy(ref))
    log(f"[{tag}] frame 0 kernel path vs plain path on the card: "
        f"max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} "
        f"(bound {FRAME_TOL}); plain path {plain_s:.4f} s/frame")
    check("frame 0", dev, FRAME_TOL)
    return launches


def phase_serving(device, frames) -> dict:
    """Phase 4. Returns the launch counts of the serving run."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs

    kwargs = afgsa_prod_kwargs()
    return serve(device, frames, AFGSANet, kwargs, kwargs["num_sa"], ("K1", "K2", "K3"), "slice")


def bf16_intermediates_chain(zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
                             d_inner, d_state, headdim, chunk):
    """The plain fused chain with xBC and y rounded to bf16 between its
    stages: the precision loss K7's bf16 bound must catch."""
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import chain_norm, chain_prologue, chain_scan

    zx = zxbcdt.float()
    xbc, dt, cum = chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    y = chain_scan(xbc.bfloat16().float(), dt, cum, D, d_inner, d_state, headdim)
    return chain_norm(y.bfloat16().float(), zx[..., :d_inner], norm_w, zxbcdt.dtype)


def phase_mamba(device, frames) -> tuple[dict, dict]:
    """Phase 7. Returns (K7's row at the prod serving shape, the launch
    counts of the Mamba serving run)."""
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import fused_mamba_chain_torch
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_cuda

    kwargs = mamba_prod_kwargs()
    di, n, p = kwargs["expansion"] * kwargs["base_ch"], kwargs["d_state"], kwargs["headdim"]
    h, q, k = di // p, 128, kwargs["d_conv"]
    b, l = MAMBA["batch"], MAMBA["tokens"]
    g = torch.Generator(device=device).manual_seed(4321)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device)

    # the inputs of tests/test_ssd_mega.py `_make_inputs`
    zx = (rand(b, l, 2 * di + 2 * n + h) * 0.5).bfloat16()
    params = (rand(k, di + 2 * n) * 0.2, rand(di + 2 * n) * 0.1,
              torch.rand(h, generator=g, device=device) * 3 - 4,
              -torch.exp(torch.rand(h, generator=g, device=device) * 1.5),
              rand(h), 1 + 0.1 * rand(di))
    dims = dict(d_inner=di, d_state=n, headdim=p, chunk=q)
    # per (batch, chunk): C·Bᵀ 2q²n, the intra-chunk products 2hq²p, the
    # state's readout and update 4qn·di
    flops = b * (l // q) * (2 * q * q * n + 2 * h * q * q * p + 4 * q * n * di)
    rows = {}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        args = (zx.to(dtype), *params)
        out_bytes = b * l * di * args[0].element_size()
        rows[label] = compare(
            f"K7 fused Mamba2 interior {label} ({b} × {l} tokens, d_inner {di}, d_state {n})",
            lambda args=args: fused_mamba_chain_cuda(*args, **dims),
            lambda args=args: fused_mamba_chain_torch(*args, **dims),
            MAMBA_TOL[label], iters=10, plain_iters=2,
            work=(nbytes(*args) + out_bytes, flops, dtype),
        )
    ctl = deviation(bf16_intermediates_chain(zx, *params, **dims),
                    fused_mamba_chain_torch(zx, *params, **dims))
    log(f"[kernels] control: plain chain with xBC and y rounded to bf16 vs plain: "
        f"max_rel {ctl['max_rel']:.6g} rms_rel {ctl['rms_rel']:.6g} "
        f"(must exceed K7's bf16 rms bound {MAMBA_TOL['bf16'][1]})")
    if ctl["rms_rel"] <= MAMBA_TOL["bf16"][1]:
        raise AssertionError("K7's bf16 bound passes a chain with bf16 intermediates")
    del zx, params
    launches = serve(device, frames, MambaDenoiserNet, kwargs, kwargs["num_blocks"], ("K7",),
                     "mamba")
    return rows["bf16"], launches


def _train_state(device, d_dtype, g_kwargs, patch, batch, seed):
    """Seeded G and D (D in `d_dtype`), and one numpy batch
    (bench.py:107-118) on the card."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG

    g = AFGSANet(**g_kwargs, device=device, generator=torch.Generator().manual_seed(seed))
    d = DiscriminatorVGG(in_nc=3, base_nf=64, input_size=patch, dtype=d_dtype, device=device,
                         generator=torch.Generator().manual_seed(seed + 1))
    rng = np.random.default_rng(seed)
    arrays = {
        "noisy": np.abs(rng.standard_normal((batch, patch, patch, 3))),
        "gt": np.abs(rng.standard_normal((batch, patch, patch, 3))),
        "aux": rng.standard_normal((batch, patch, patch, 7)),
    }
    data = {key: torch.from_numpy(val.astype(np.float32)).to(device) for key, val in arrays.items()}
    return g.train(), d.train(), data


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, so that two routes differ only
    where the generator's kernels differ from their plain versions."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _step_grads(device, g_kwargs, patch, batch, alpha, nudge=False):
    """One train step from the seeded state with a float32 critic:
    (metrics, G gradients). `nudge` moves every noisy input value to the
    next bf16 value up: a change of one bf16 ulp, whose effect on the
    gradients is the floor that bf16 rounding flips alone set."""
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    g, d, data = _train_state(device, torch.float32, g_kwargs, patch, batch, seed=3)
    if nudge:  # the inputs are ≥ 0, so one more in the bits is one ulp up
        bits = data["noisy"].to(torch.bfloat16).view(torch.int16) + 1
        data["noisy"] = bits.view(torch.bfloat16).float()
    spec = make_optimizer(1e-4, [2], 0.5, 100)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    metrics = {key: val.item() for key, val in step(data, alpha=alpha).items()}
    return metrics, {n: p.grad.detach().clone() for n, p in g.named_parameters()}


def grad_table(gk: dict, gp: dict) -> list:
    """(name, rms, total-mass deviation) of each G gradient, worst mass first."""
    rows = []
    for name, ref in gp.items():
        got, ref = gk[name].float(), ref.float()
        scale = ref.abs().max().item() + 1e-30
        rms = (got - ref).pow(2).mean().sqrt().item() / scale
        mass = abs(got.abs().sum().item() - ref.abs().sum().item()) / (ref.abs().sum().item() + 1e-30)
        rows.append((name, rms, mass))
    return sorted(rows, key=lambda r: -r[2])


def phase_training(device) -> dict:
    """Phase 5. Returns the launch counts of the 7 training steps."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import afgsa_prod_kwargs, count_params
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    patch, batch, warmup, timed = (TRAIN[k] for k in ("patch", "batch", "warmup", "timed"))
    kwargs = afgsa_prod_kwargs()
    g, d, data = _train_state(device, torch.bfloat16, kwargs, patch, batch, seed=0)
    assert g.block_route(batch, patch, patch), "the prod step must take the block route"
    spec = make_optimizer(1e-4, [2], 0.5, 100)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    gen = torch.Generator(device=device).manual_seed(7)
    log(f"[train] prod step: G {count_params(g)} params (bf16, {kwargs['num_sa']} blocks, "
        f"block route), D {count_params(d)} params; batch {batch} × {patch}², WGAN-GP + L1")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    secs, history = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        metrics = step(data, generator=gen)
        history.append({key: val.item() for key, val in metrics.items()})  # syncs
        secs.append(time.perf_counter() - t0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    for i, m in enumerate(history):
        if not all(math.isfinite(val) for val in m.values()):
            raise AssertionError(f"step {i}: non-finite losses {m}")
    need = kwargs["num_sa"] * (warmup + timed)
    for name in ("K1", "K2", "K3", "K4", "K5", "K6"):
        if launches[name] < need:
            raise AssertionError(f"{name} launched {launches[name]} times < {need} "
                                 "(5 blocks × 7 steps)")
    steady = float(np.mean(secs[warmup:]))
    log(f"[train] launches {launches} (need ≥ {need} each)")
    log(f"[train] losses step 0 {history[0]}; step {len(history) - 1} {history[-1]}")
    log(f"[train] seconds per step {[round(s_, 4) for s_ in secs]} (first {warmup} warm-up); "
        f"steady {steady:.4f} s/step = {batch / steady:.3f} patches/s; "
        f"peak memory {peak} B ({peak / 2**30:.3f} GiB)")

    alpha = torch.rand((batch, 1, 1, 1), generator=gen, device=device)
    plain = dict(kwargs, use_kernels=False)
    with deterministic_cudnn():
        mk, gk = _step_grads(device, kwargs, patch, batch, alpha)
        mp, gp = _step_grads(device, plain, patch, batch, alpha)
        # the plain route against itself (the comparison's noise floor), and
        # two witnesses of how far bf16 rounding alone moves these
        # gradients: the inputs one ulp up, and the literal route (autograd
        # through plain bf16 ops, which round at other points)
        witnesses = {
            "plain route repeated (noise floor)": _step_grads(device, plain, patch, batch, alpha),
            "plain route, inputs one bf16 ulp up": _step_grads(device, plain, patch, batch, alpha,
                                                              nudge=True),
            "plain literal route": _step_grads(device, dict(plain, use_block_kernel=False),
                                               patch, batch, alpha),
        }
    for key in ("d_loss", "g_loss"):
        if abs(mk[key] - mp[key]) > STEP_LOSS_TOL * max(1.0, abs(mp[key])):
            raise AssertionError(f"{key}: kernel route {mk[key]} vs plain route {mp[key]}")
    table = grad_table(gk, gp)
    for name, rms, mass in table[:8]:
        log(f"[train]   G gradient {name}: rms_rel {rms:.4e} mass {mass:.4e}")
    for label, (_, gw) in witnesses.items():
        rows = grad_table(gw, gp)
        at = {r[0]: r for r in rows}
        log(f"[train] {label} vs plain route: G gradients worst rms_rel "
            f"{max(r[1] for r in rows):.4e}, worst mass {rows[0][2]:.4e} ({rows[0][0]}); "
            + ", ".join(f"{n} rms_rel {at[n][1]:.4e} mass {at[n][2]:.4e}" for n, *_ in table[:3]))
    for name, rms, mass in table:
        if rms > STEP_GRAD_TOL[0] or mass > STEP_GRAD_TOL[1]:
            raise AssertionError(f"G gradient {name}: rms {rms:.3e} mass {mass:.3e} "
                                 f"> {STEP_GRAD_TOL}")
    dev = deviation(list(gk.values()), list(gp.values()))
    log(f"[train] one step (float32 critic), kernel route vs plain route: d_loss {mk['d_loss']:.6g} vs "
        f"{mp['d_loss']:.6g}, g_loss {mk['g_loss']:.6g} vs {mp['g_loss']:.6g}; G gradients "
        f"worst max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} "
        f"(bounds rms {STEP_GRAD_TOL[0]}, mass {STEP_GRAD_TOL[1]})")
    return launches


def phase_literal(device) -> dict:
    """Phase 6. Returns the launch counts of the fp32 literal-route step."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import afgsa_prod_kwargs
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    patch, batch = LITERAL["patch"], LITERAL["batch"]
    kwargs = dict(afgsa_prod_kwargs(), num_sa=LITERAL["num_sa"], dtype=torch.float32)
    g, d, data = _train_state(device, torch.float32, kwargs, patch, batch, seed=5)
    assert not g.block_route(batch, patch, patch), "fp32 takes the literal route"
    spec = make_optimizer(1e-4, [2], 0.5, 100)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    alpha = torch.rand((batch, 1, 1, 1), generator=torch.Generator().manual_seed(9)).to(device)
    reset_counts()
    metrics = {key: val.item() for key, val in step(data, alpha=alpha).items()}
    torch.cuda.synchronize()
    launches = read_counts()
    for name in ("K1", "K4"):
        if launches[name] < kwargs["num_sa"]:
            raise AssertionError(f"{name} launched {launches[name]} times < {kwargs['num_sa']}")
    if not all(math.isfinite(val) for val in metrics.values()):
        raise AssertionError(f"non-finite losses {metrics}")

    plain = dict(kwargs, use_kernels=False)
    with deterministic_cudnn():
        mk, gk = _step_grads(device, kwargs, patch, batch, alpha)
        mp, gp = _step_grads(device, plain, patch, batch, alpha)
        _, gp2 = _step_grads(device, plain, patch, batch, alpha)
    floor = deviation(list(gp2.values()), list(gp.values()))
    log(f"[literal] plain route repeated (noise floor): G gradients worst max_rel "
        f"{floor['max_rel']:.6g} rms_rel {floor['rms_rel']:.6g}")
    for key in ("d_loss", "g_loss"):
        if abs(mk[key] - mp[key]) > FP32_STEP_TOL[0] * max(1.0, abs(mp[key])):
            raise AssertionError(f"{key}: kernel route {mk[key]} vs plain route {mp[key]}")
    dev = deviation(list(gk.values()), list(gp.values()))
    check("fp32 G gradients", dev, FP32_STEP_TOL[1])
    log(f"[literal] fp32 step (2 blocks, {batch} × {patch}²): launches {launches}; "
        f"kernel vs plain route: d_loss {mk['d_loss']:.8g} vs {mp['d_loss']:.8g}, g_loss "
        f"{mk['g_loss']:.8g} vs {mp['g_loss']:.8g}; G gradients worst max_rel "
        f"{dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} (bound {FP32_STEP_TOL[1]})")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pixel_heal_thyself_tpu_torch import _build
    from pixel_heal_thyself_tpu_torch.measure import synthetic_frames

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

    results = phase_kernels(device)
    frames = synthetic_frames(SERVE["frames"], SERVE["size"])
    serving = phase_serving(device, frames)
    training = phase_training(device)
    phase_literal(device)
    results["K7"], mamba = phase_mamba(device, frames)
    # each kernel's count from the path it was ported for
    path = {"K1": serving, "K2": serving, "K3": serving, "K4": training, "K5": training,
            "K6": training, "K7": mamba}
    line = []
    for name, info in KERNELS.items():
        res = results[name]
        line.append({"name": info[0], "route": "cuda", "source": info[1],
                     "replaces": info[2], "launches": path[name][name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    log(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
   (its tensor-core body, checked by its body counter, beside its general
   body and SDPA over pre-gathered windows) and fp32 (the general body),
   and at halo 8 (the tensor-core body's two passes, the general body's
   key-chunked path), the pointwise GEMM K2
   (n_aux's two operands; one operand, k = n·Wk; two operands with the
   backward's f32 residual, also equal to the bit across two calls), the
   3×3 conv K3, the whole TransformerBlock forward in the three padding
   modes; the attention backward K4 (bf16: the tensor-core body, equal to
   the bit across two calls, its device time per launch, beside the general
   body and SDPA's autograd backward; fp32: the general body), the conv
   input gradient K5 (also equal to the bit across two calls), the weight
   gradient K6 (9
   taps and 1 tap, each also equal to the bit across two calls) and the whole
   block backward in the three padding modes. Prints deviations and
   CUDA-event times of kernel and plain version. (K7's rows run in phase
   7, K7-emit's and K8's in phase 8, beside the paths they serve.)
4. Serving: three synthetic 512² frame pairs denoised by the prod-width
   AFGSANet (seeded random weights, bf16, replicate padding) through
   `preprocess_data` and the device tiler (tile 64, margin 32, batch 8),
   the path `inference.run_inference` takes. Checks the outputs, that every
   block of every batch went through K1, K2 and K3 (launch counters), that
   every K1 launch took its tensor-core body and every K2 and K3 launch its
   Hopper body (per-body counters), and frame 0 against the model's plain
   path on the card.
5. Training: the prod GAN step (`training.train_step.make_train_step`,
   WGAN-GP + L1, Adam with the MultiStep schedule) on the prod-width
   AFGSANet in train mode and DiscriminatorVGG(128, 64, bf16), seeded
   random weights, batch 8 of 128² numpy patches: 2 warm-up and 5 timed
   steps. Checks finite losses, that every block of every step ran its
   backward through K4, K5 and K6 (launch counters), that every K1 and K4
   launch took its tensor-core body and every K2, K3, K5 and K6 launch its
   Hopper body (per-body counters), prints patches/s and
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
   rounded to bf16, which the TPU kernel never does), and K7's device time
   per launch (torch.profiler); K7's prologue alone on its vec body against
   its general body (xbc, dt and cum equal to the bit, both times and the
   prologue's bound) in bf16 and fp32; then three synthetic 512² frames denoised
   by the prod-width MambaDenoiserNet (seeded random weights, bf16,
   replicate padding) through the device tiler. Checks the outputs, that
   every layer of every batch went through K7 (launch counter) on its
   tensor-core body with its prologue on the vec body (per-body counters),
   and frame 0 against the model's plain path.
8. Mamba training: K7's emit variant on the prod generator's own layer
   inputs (its first training forward) within K7's bf16 bounds, and K7's
   prologue on those inputs on its vec body equal to its general body to
   the bit; K7's emit
   variant and the fused Mamba2 backward K8 against their plain versions
   at the prod shape in bf16 and fp32 (every gradient at its bound,
   MAMBA_BWD_TOL), K8's device time per launch, two K8 calls equal to the
   bit, beside a control that the bounds must fail (the plain backward
   with the reverse carry of the state gradient cut); then the prod GAN
   step of phase 5 with the prod-width MambaDenoiserNet as the generator:
   2 warm-up and 5 timed steps, every layer of every step through K7-emit
   and K8 (launch counters) on their tensor-core bodies with their
   prologues on the vec body (per-body counters), and one step through the
   kernel and plain routes beside the
   witnesses that set MAMBA_STEP_GRAD_TOL.
9. The literal Mamba route: the fused causal conv1d + SiLU forward K9 and
   backward K10 against their plain versions at zxbcdt [8, 16,384, 2192]
   (window 1024 + 1152; both on their vec bodies in both dtypes, beside
   cuDNN's grouped conv1d and its backward as yardsticks) and the chunked SSD
   scan K11 at x [8, 16,384, 16, 64] (bf16 on its tensor-core body, fp32
   on its general body, two bf16 calls equal to the bit), each in bf16
   and fp32 (CONV_TOL, SSD_SCAN_TOL), with K10's and K11's device time per
   launch, beside a control that K11's bf16 bound must fail (the plain
   scan carrying the state in f32); then the sections of `bench_mamba` at
   batch 8 with the fused conv (`--pallas`) on a seeded prod-width
   MambaDenoiserNet (literal route): s/iter and peak memory of each, that
   every layer of every G forward ran K9 and of every backward K10, and
   the `ssd_pallas` section K11 (launch counters), every K9 and K10 launch
   on its vec body and every K11 launch on its tensor-core body (per-body
   counters); the G forward and the L1 forward + backward through the
   kernel route against the plain route (FRAME_TOL, MAMBA_STEP_GRAD_TOL).
10. `fold_qkv`: one L1 forward + backward of the prod-width AFGSANet on
   the literal route (8 × 128²) with the q/k/v projections folded into
   the attention op against the unfolded model: both run K1 and K4, which
   the counters check on the folded route, so only the projections'
   rounding differs (FRAME_TOL, STEP_GRAD_TOL); every K1 and K4 launch of
   the folded run took its tensor-core body.
11. Trainer: the training CLI, `train.main`, for `-cn prod` and `-cn prod
   model=mamba` in a temporary working directory (synthetic 512² scenes,
   `trainer.epochs=2`, batch 8 × 128², bf16, the kernels on; the patch
   store built on the first run): `data.loader=auto` resolved to
   `device`, `train_loss.txt` and `evaluation.txt` one finite line per
   epoch, the PNG panels decode, `model_epoch{1,2}/state/` written; every
   train step launched K1–K6 (AFGSA) or K7-emit and K8 (Mamba) for every
   block and every validation forward K1–K3 or K7 (counter deltas around
   each call), all on their prod bodies; the first validation batch
   through the trainer's eval step against the plain route (FRAME_TOL); a
   resume from `model_epoch1/state` that starts at epoch 2 with G's
   parameters and both Adam states equal to the saved ones to the bit and
   its first step at the schedule's learning rate; `model_epoch2/state`
   served through `inference.load_generator`, one 512² frame equal to the
   trainer's G to the bit. Prints each epoch's patches/s and io share
   from the trainer's summary beside phases 5's and 8's step-alone rate,
   the store build's seconds and peak memory.

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
import copy
import json
import logging
import math
import re
import struct
import subprocess
import tempfile
import time
import zlib
from functools import partial
from pathlib import Path

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
# the generator's kernels. Even through the float32 critic the GP carries
# the generator output's bf16 flips into d_loss: the one-ulp witnesses move
# it 1.04% (AFGSA) and 0.64% (Mamba), the Mamba kernel route 0.85% (H100
# runs), so this bound sits at that floor; both routes are deterministic
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
# phase 7: 8 windows of 128² = 16,384 tokens per Mamba2 layer call; phase 8
# trains at TRAIN's geometry, the same 8 × 16,384 tokens per layer call
MAMBA = dict(batch=8, tokens=128 * 128)
# K8 (the fused Mamba2 backward) against its plain version, per gradient:
# both keep every intermediate in f32. dzx rounds once, at the output:
# K7's bounds (a bf16 value next to a rounding boundary may flip). The
# parameter gradients never round: f32 sums over 131,072 tokens in another
# order (WGRAD_TOL's reason); dt_bias and A are sums of cancelling terms
# and have one entry per head, so their rms is about their max
MAMBA_BWD_TOL = {
    label: {"dzx": MAMBA_TOL[label], "conv_w": WGRAD_TOL, "conv_b": WGRAD_TOL,
            "dt_bias": (1e-4, 1e-4), "A": (1e-4, 1e-4), "D": (1e-4, 1e-4), "norm_w": WGRAD_TOL}
    for label in ("bf16", "fp32")
}
# the prod Mamba step, kernel route vs plain route (phase 8): rms 5e-2, total
# mass 5e-2 for every generator gradient, read from the witnesses phase 8
# prints (H100 runs, PERF.md Findings). The kernel route reads worst
# rms 2.41e-2 and mass 2.58e-2 (blocks.2.mamba.A_log); the plain literal
# route rms 2.31e-2, mass 3.05e-2; the plain route with the inputs one bf16
# ulp up rms 3.48e-2, mass 4.67e-2 (dt_bias); the plain route repeated rms
# 4.8e-4. The worst are the per-head dt_bias and A_log gradients: sums over
# 131,072 tokens of cancelling terms, where one flip moves the sum most.
# AFGSA's rms 2.5e-2 sits below this model's flip floor; 5e-2 sits at it,
# and still fails a gradient that is missing, doubled, or computed without
# the state carry (the phase-8 control moves A's gradient by rms 1e-1 in a
# single layer)
MAMBA_STEP_GRAD_TOL = (5e-2, 5e-2)
# K9/K10 (the fused causal conv1d + SiLU) against their plain versions:
# both round each f32 product and sum at the same points in the same order
# (the kernels block FMA contraction), so y and dx could differ only where
# an exp differed in its last bit: at most one bf16 ulp (max_rel 2**-8 of
# the largest magnitude), rarely (rms 1e-4). The H100 reads them equal to
# the bit in both dtypes (PERF.md). dw and db are f32 sums over 131,072
# tokens in another order (WGRAD_TOL's reason): max_rel 1e-4 (read 4.7e-7)
CONV_TOL = {"bf16": (2**-8, 1e-4), "fp32": (1e-5, 1e-5)}
CONV_BWD_TOL = {label: {"dx": tol, "dw": (1e-4, 1e-4), "db": (1e-4, 1e-4)}
                for label, tol in CONV_TOL.items()}
# K11 (the chunked SSD scan) against its plain version: both round at the
# TPU kernel's points, the carried state included, and a sum in another
# order may put a value next to a rounding boundary on its other side:
# fp32 1e-4 max; bf16 two ulps (8e-3) max, and rms 1e-5, which the plain
# scan that carries the state in f32 must fail (phase 9 checks that
# control). The H100 read the scalar-FMA body equal to its plain version to
# the bit at the prod shape, and the control at rms 4.6e-5; the bf16
# tensor-core body sums in another order (PERF.md)
SSD_SCAN_TOL = {"bf16": (8e-3, 1e-5), "fp32": (1e-4, 1e-5)}
# phase 9: the bench_mamba sections' timed calls (after 2 warm-up calls)
BENCH_ITERS = 5
_SRC = "pixel_heal_thyself_tpu_torch/csrc/"
_TPU = "pixel_heal_thyself_tpu/ops/"
# kernel → (name, source, TPU kernel it replaces)
KERNELS = {
    "K1": ("block_halo_attention_fwd (K1)", _SRC + "attention_fwd.cu",
           _TPU + "attention_pallas.py:217"),
    "K2": ("pointwise_gemm (K2)", _SRC + "pointwise_sm90.cu", _TPU + "block_mega.py:413"),
    "K3": ("conv3x3 (K3)", _SRC + "conv3x3_sm90.cu", _TPU + "block_mega.py:413"),
    "K4": ("block_halo_attention_bwd (K4)", _SRC + "attention_bwd.cu",
           _TPU + "attention_pallas.py:383"),
    "K5": ("conv3x3_dgrad (K5)", _SRC + "dgrad_sm90.cu", _TPU + "block_mega.py:662"),
    "K6": ("weight_grad (K6)", _SRC + "wgrad_sm90.cu", _TPU + "block_mega.py:662"),
    "K7": ("fused_mamba_chain (K7)", _SRC + "ssd_fwd.cu", _TPU + "ssd_mega.py:256"),
    "K7e": ("fused_mamba_chain_emit (K7 emit)", _SRC + "ssd_fwd.cu", _TPU + "ssd_mega.py:252"),
    "K8": ("fused_mamba_chain_bwd (K8)", _SRC + "ssd_bwd.cu", _TPU + "ssd_mega.py:260"),
    "K9": ("fused_causal_conv1d_silu (K9)", _SRC + "conv_silu.cu", _TPU + "conv_pallas.py:147"),
    "K10": ("fused_causal_conv1d_silu_bwd (K10)", _SRC + "conv_silu.cu",
            _TPU + "conv_pallas.py:158"),
    "K11": ("ssd_pallas (K11)", _SRC + "ssd_scan.cu", _TPU + "ssd.py:324"),
}
KERNEL_NAMES = tuple(KERNELS)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from pixel_heal_thyself_tpu_torch.ops.conv_cuda import (
        fused_causal_conv1d_silu_bwd_cuda,
        fused_causal_conv1d_silu_cuda,
    )
    from pixel_heal_thyself_tpu_torch.ops.ssd_cuda import ssd_pallas_cuda
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
        fused_mamba_chain_bwd_cuda,
        fused_mamba_chain_cuda,
        fused_mamba_chain_emit_cuda,
    )

    return dict(zip(KERNEL_NAMES, (block_halo_attention_cuda, pointwise_gemm_cuda,
                                   conv3x3_cuda, block_halo_attention_bwd_cuda,
                                   conv3x3_dgrad_cuda, weight_grad_cuda,
                                   fused_mamba_chain_cuda, fused_mamba_chain_emit_cuda,
                                   fused_mamba_chain_bwd_cuda, fused_causal_conv1d_silu_cuda,
                                   fused_causal_conv1d_silu_bwd_cuda, ssd_pallas_cuda),
                    strict=True))


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        for attr in ("body_launches", "prologue_body_launches"):
            for body in getattr(fn, attr, {}):
                getattr(fn, attr)[body] = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


# the kernels with two bodies → the body every prod-shape launch must take:
# K2, K3, K5 and K6 the Hopper wgmma body (widths 256), K7, K7e and K8 the
# tensor-core body (d_state 64, headdim 64, chunk 128), K1 and K4 the
# tensor-core body (bf16, head_ch 64, block 8), K9 and K10 the vec body (a
# 16-byte aligned window), K11 the tensor-core body (bf16, chunk 128)
PROD_BODIES = {"K1": "tc", "K2": "sm90", "K3": "sm90", "K4": "tc", "K5": "sm90", "K6": "sm90",
               "K7": "tc", "K7e": "tc", "K8": "tc", "K9": "vec", "K10": "vec", "K11": "tc"}
# the kernels whose first launch is K7's prologue, and the body every prod
# prologue must take (the 16-byte aligned xBC window)
PROLOGUE_BODIES = {"K7": "vec", "K7e": "vec", "K8": "vec"}


def check_bodies(tag: str, launches: dict) -> None:
    """The launches of each kernel of PROD_BODIES by body, and of each
    prologue of PROLOGUE_BODIES: every one must have taken its prod body,
    none the general one."""
    fns = counters()
    for attr, want in (("body_launches", PROD_BODIES),
                       ("prologue_body_launches", PROLOGUE_BODIES)):
        for name, body in want.items():
            bodies = dict(getattr(fns[name], attr))
            log(f"[{tag}] {name} {attr.replace('_', ' ')}: {bodies} (total {launches[name]})")
            if bodies["general"] or bodies[body] != launches[name]:
                raise AssertionError(f"[{tag}] {name}: {bodies['general']} prod-shape launches "
                                     f"took the general body ({attr} {bodies})")


def expect_body(name: str, body: str, run):
    """`run()` with kernel `name`'s counters set to 0 first: every launch it
    made must have taken `body`. Returns what `run` returns."""
    fn = counters()[name]
    fn.launches = 0
    for key in fn.body_launches:
        fn.body_launches[key] = 0
    result = run()
    bodies = dict(fn.body_launches)
    log(f"[kernels] {name} launches by body: {bodies} (total {fn.launches})")
    if not fn.launches or bodies[body] != fn.launches:
        raise AssertionError(f"{name}: a prod-shape launch took another body than {body} "
                             f"({bodies})")
    return result


def sdpa_windows(x, bs: int, halo: int, heads: int, keys: bool = False, rel=None):
    """The library yardstick's operands: [windows, heads, n, head_ch] copies
    of the query blocks (or, with `keys`, of the key/value windows, k_eff
    biased and rounded when `rel` = (rel_h, rel_w) is given), gathered once
    and never timed."""
    from pixel_heal_thyself_tpu_torch.ops.attention import (
        blocks_from_image,
        extract_halo_windows,
        rel_bias,
    )

    b, h, w, c = x.shape
    hd, window = c // heads, bs + 2 * halo
    if not keys:
        wins = blocks_from_image(x, bs)
    else:
        wins = extract_halo_windows(x, bs, halo)
        if rel is not None:
            wins = wins.reshape(*wins.shape[:5], heads, hd).float()
            wins = (wins + rel_bias(*rel)[:, :, None, :]).to(x.dtype)
        wins = wins.reshape(b, h // bs, w // bs, window * window, c)
    n = wins.shape[3]
    return wins.reshape(-1, n, heads, hd).permute(0, 2, 1, 3).contiguous()


# K4's launches by name fragment (first match wins) for its per-launch times
K4_LAUNCHES = [("attention_bwd_tc", "main (tc body)"), ("attention_bwd_kernel", "main (general)"),
               ("attention_bwd_gather", "dk/dv gather"), ("attention_bias_reduce", "bias reduce"),
               ("sum_splits", "bias group sum"), ("reduce", "drel_h/drel_w sums")]


def nbytes(*tensors) -> int:
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def compare(name, kernel, plain, tol, iters=10, plain_iters=3, grads=None, work=None,
            library=None, check_fn=None):
    """A kernel against its plain version on the same inputs: deviation
    (checked against `tol`, the gradient bounds, or by `check_fn(name, got,
    ref)`), CUDA-event times of both, the bound from `work` = (bytes,
    flops, dtype) and the time of `library`, one PyTorch call computing the
    same function."""
    from pixel_heal_thyself_tpu_torch.measure import bound, cuda_ms

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    if check_fn is not None:
        dev = check_fn(name, got, ref)
    elif grads is None:
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


def assert_deterministic(name: str, fn) -> None:
    """Two calls give the same bits (the split sums add in a fixed order)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(f, s) for f, s in zip(first, second)):
        raise AssertionError(f"{name}: two calls differ")
    log(f"[kernels] {name}: two calls equal to the bit")


def phase_kernels(device) -> dict:
    """Phase 3. Returns {kernel name: its first row's result}."""
    from pixel_heal_thyself_tpu_torch.ops.attention import (
        block_halo_attention_bwd_torch,
        block_halo_attention_torch,
    )
    from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
        attention_body_launch,
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
    # the library yardstick of K1 and K4: SDPA (flash) over the windows,
    # gathered once beforehand with k_eff biased; the gather is not timed
    rels = (wts["rel_h"], wts["rel_w"])
    qw = sdpa_windows(q, BS, HALO, HEADS)
    kw_ = sdpa_windows(k, BS, HALO, HEADS, keys=True, rel=rels)
    vw = sdpa_windows(v, BS, HALO, HEADS, keys=True)
    res["K1"] = expect_body("K1", "tc", lambda: compare(
        "K1 attention bf16 (tc body; library: SDPA on pre-gathered windows, gather untimed)",
        lambda: block_halo_attention_cuda(q, k, v, *rels, **att),
        lambda: block_halo_attention_torch(q, k, v, *rels, **att),
        TOL["bf16"], work=(nbytes(q, k, v, *rels, q), attn_flops, bf),
        library=lambda: F.scaled_dot_product_attention(qw, kw_, vw),
    ))
    compare(
        "K1 attention bf16, general body",
        lambda: attention_body_launch("general", q, k, v, *rels, **att),
        lambda: block_halo_attention_torch(q, k, v, *rels, **att),
        TOL["bf16"], work=(nbytes(q, k, v, *rels, q), attn_flops, bf),
    )
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    expect_body("K1", "general", lambda: compare(
        "K1 attention fp32 (general body)",
        lambda: block_halo_attention_cuda(qf, kf, vf, *rels, **att),
        lambda: block_halo_attention_torch(qf, kf, vf, *rels, **att),
        TOL["fp32"],
    ))
    # halo 8 at head_ch 64: 36 key tiles, which the tensor-core body walks in
    # two passes; the general body's one-stage plan exceeds 227 KB in both
    # dtypes, so it walks the keys in chunks
    big = dict(att, halo_size=8)
    rel8 = [rand((BS + 16, c // HEADS // 2), dtype=torch.float32) for _ in range(2)]
    expect_body("K1", "tc", lambda: compare(
        "K1 attention bf16 halo 8 (tc body, two passes)",
        lambda: block_halo_attention_cuda(q, k, v, *rel8, **big),
        lambda: block_halo_attention_torch(q, k, v, *rel8, **big),
        TOL["bf16"], iters=3, plain_iters=1,
    ))
    for dt, tol, (qq, kk, vv) in (("bf16", TOL["bf16"], (q, k, v)),
                                  ("fp32", TOL["fp32"], (qf, kf, vf))):
        compare(
            f"K1 attention {dt} halo 8 (general body, key-chunked)",
            lambda qq=qq, kk=kk, vv=vv: attention_body_launch("general", qq, kk, vv, *rel8,
                                                              **big),
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
    # one operand: k = n·Wk (the most frequent launch: k, v, q and the
    # backward's recompute)
    x2d = x.reshape(pixels, c)
    res["K2 1 operand"] = compare(
        "K2 pointwise GEMM, 1 operand (k = n·Wk)",
        lambda: pointwise_gemm_cuda(x, wts["wk"]), lambda: pointwise_gemm_torch(x, wts["wk"]),
        TOL["bf16"], work=(nbytes(x, wts["wk"], x), 2 * pixels * c * c, bf),
        library=lambda: torch.mm(x2d, wts["wk"]),
    )
    # two operands with the f32 residual: the backward's dx = round(dx1 +
    # dv·Wvᵀ + dz·Wcat[:C]ᵀ)
    dxa = (q, wts["wv"], k, wts["wq"], None, False, do)
    qk = torch.cat([q, k], dim=-1).reshape(pixels, 2 * c)
    w_qk = torch.cat([wts["wv"], wts["wq"]], dim=0)
    res["K2 pre_residual"] = compare(
        "K2 pointwise GEMM, 2 operands + f32 residual (dx)",
        lambda: pointwise_gemm_cuda(*dxa), lambda: pointwise_gemm_torch(*dxa), TOL["bf16"],
        work=(nbytes(q, k, wts["wv"], wts["wq"], do, x), 2 * pixels * 2 * c * c, bf),
        library=lambda: torch.addmm(do.reshape(pixels, c), qk, w_qk),
    )
    assert_deterministic("K2 pointwise GEMM, 2 operands + f32 residual",
                         lambda: (pointwise_gemm_cuda(*dxa),))
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
    qg, kg, vg = (t.detach().requires_grad_() for t in (qw, kw_, vw))
    og = F.scaled_dot_product_attention(qg, kg, vg)
    dow = sdpa_windows(do, BS, HALO, HEADS)
    k4_work = (nbytes(q, k, v, do, *ab) + nbytes(q, k, v, *ab), attn_flops * 5 // 2, bf)
    res["K4"] = expect_body("K4", "tc", lambda: compare(
        "K4 attention backward bf16 (dq, dk, dv, drel_h, drel_w; tc body; library: SDPA's "
        "backward on pre-gathered windows, gather untimed)",
        lambda: block_halo_attention_bwd_cuda(q, k, v, *ab, do, **att),
        lambda: block_halo_attention_bwd_torch(q, k, v, *ab, do, **att),
        TOL["bf16"], iters=5, plain_iters=2,
        # five window products: logits, dP, dV, dQ, dK
        work=k4_work,
        library=lambda: torch.autograd.grad(og, (qg, kg, vg), dow, retain_graph=True),
    ))
    del qg, kg, vg, og, dow, qw, kw_, vw
    expect_body("K4", "tc", lambda: assert_deterministic(
        "K4 attention backward bf16 (tc body)",
        lambda: block_halo_attention_bwd_cuda(q, k, v, *ab, do, **att)))
    log_per_launch("K4 attention backward bf16 (tc body)",
                   lambda: block_halo_attention_bwd_cuda(q, k, v, *ab, do, **att), K4_LAUNCHES)
    compare(
        "K4 attention backward bf16, general body",
        lambda: attention_body_launch("general", q, k, v, *ab, do, **att),
        lambda: block_halo_attention_bwd_torch(q, k, v, *ab, do, **att),
        TOL["bf16"], iters=5, plain_iters=2, work=k4_work,
    )
    log_per_launch("K4 attention backward bf16 (general body)",
                   lambda: attention_body_launch("general", q, k, v, *ab, do, **att), K4_LAUNCHES)
    expect_body("K4", "general", lambda: compare(
        "K4 attention backward fp32 (general body)",
        lambda: block_halo_attention_bwd_cuda(qf, kf, vf, *ab, dof, **att),
        lambda: block_halo_attention_bwd_torch(qf, kf, vf, *ab, dof, **att),
        TOL["fp32"], iters=5, plain_iters=2,
    ))
    dg = (do, a, wts["w2"], "replicate", x)
    res["K5"] = compare(
        "K5 conv3x3 input gradient (replicate, ReLU mask, residual)",
        lambda: conv3x3_dgrad_cuda(*dg), lambda: conv3x3_dgrad_torch(*dg), TOL["bf16"],
        work=(nbytes(do, a, wts["w2"], x, x), conv_flops, bf),
        library=lambda: torch.nn.grad.conv2d_input(tuple(nchw(xp).shape), w2k, nchw(do)),
    )
    assert_deterministic("K5 conv3x3 input gradient", lambda: (conv3x3_dgrad_cuda(*dg),))
    wg9 = dict(taps=9, padding_mode="replicate", colsum=True)
    assert_deterministic("K6 weight gradient, 9 taps", lambda: weight_grad_cuda(x, do, a, **wg9))
    assert_deterministic("K6 weight gradient, 1 tap",
                         lambda: weight_grad_cuda(x, do, None, a, colsum=True))
    res["K6"] = compare(
        "K6 weight gradient, 9 taps (replicate, ReLU mask, db)",
        lambda: weight_grad_cuda(x, do, a, **wg9), lambda: weight_grad_torch(x, do, a, **wg9),
        WGRAD_TOL,
        work=(nbytes(x, do, a) + 4 * (9 * c * c + c), conv_flops, bf),
        library=lambda: torch.nn.grad.conv2d_weight(nchw(xp), w1k.shape, nchw(do)),
    )
    res["K6 1 tap"] = compare(
        "K6 weight gradient, 1 tap ([x; a]ᵀ·dz, db)",
        lambda: weight_grad_cuda(x, do, None, a, colsum=True),
        lambda: weight_grad_torch(x, do, None, a, colsum=True),
        WGRAD_TOL,
        work=(nbytes(x, a, do) + 4 * (2 * c * c + c), 2 * pixels * 2 * c * c, bf),
        library=lambda: torch.mm(xa.t(), do.reshape(pixels, c)),
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
    check_bodies(tag, launches)
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
    y, _ = chain_scan(xbc.bfloat16().float(), dt, cum, D, d_inner, d_state, headdim)
    return chain_norm(y.bfloat16().float(), zx[..., :d_inner], norm_w, zxbcdt.dtype)


def mamba_inputs(device) -> tuple:
    """(bf16 zxbcdt, f32 parameters, dims) of one prod Mamba2 layer call at
    8 × 16,384 tokens, seeded: the inputs of tests/test_ssd_mega.py
    `_make_inputs`."""
    from pixel_heal_thyself_tpu_torch.models.mamba import mamba_prod_kwargs

    kwargs = mamba_prod_kwargs()
    di, n, p = kwargs["expansion"] * kwargs["base_ch"], kwargs["d_state"], kwargs["headdim"]
    h, q, k = di // p, 128, kwargs["d_conv"]
    b, l = MAMBA["batch"], MAMBA["tokens"]
    g = torch.Generator(device=device).manual_seed(4321)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device)

    zx = (rand(b, l, 2 * di + 2 * n + h) * 0.5).bfloat16()
    params = (rand(k, di + 2 * n) * 0.2, rand(di + 2 * n) * 0.1,
              torch.rand(h, generator=g, device=device) * 3 - 4,
              -torch.exp(torch.rand(h, generator=g, device=device) * 1.5),
              rand(h), 1 + 0.1 * rand(di))
    return zx, params, dict(d_inner=di, d_state=n, headdim=p, chunk=q)


def log_per_launch(name: str, run, groups=None) -> None:
    """A kernel's device time per call by launch (torch.profiler), labelled
    by `groups` (default: the profile tools' GROUPS)."""
    from pixel_heal_thyself_tpu_torch.profile_serving import GROUPS, per_launch

    rows = per_launch(run, groups=groups or GROUPS)
    log(f"[kernels] {name} per launch: total {sum(rows.values()):.4f} ms; "
        + ", ".join(f"{label} {ms:.4f}" for label, ms in rows.items()))


def prologue_bodies(tag: str, zx, params, dims: dict, timed: bool = True) -> None:
    """K7's prologue alone (`ssd_prologue_cuda`) on its vec body against its
    general body on the same inputs: xbc, dt and cum must be equal to the
    bit. With `timed`, both bodies' CUDA-event times and the prologue's
    bound: it reads the xBC window and the dt column of zxbcdt and the
    parameters, and writes the f32 xbc, dt and cum."""
    from pixel_heal_thyself_tpu_torch.measure import bound, cuda_ms
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import ssd_prologue_cuda

    run = {body: partial(ssd_prologue_cuda, zx, *params[:4], **dims, body=body)
           for body in ("vec", "general")}
    got = {body: fn() for body, fn in run.items()}
    torch.cuda.synchronize()
    for name, v, g in zip(("xbc", "dt", "cum"), got["vec"], got["general"], strict=True):
        if not torch.equal(v, g):
            raise AssertionError(f"K7 prologue {tag}: the vec body's {name} differs from the "
                                 "general body's")
    if not timed:
        log(f"[kernels] K7 prologue {tag}: vec body equal to the general body to the bit "
            "(xbc, dt, cum)")
        return
    b, l, _ = zx.shape
    k, dc = params[0].shape
    h = params[2].shape[0]
    moved = b * l * (dc + h) * zx.element_size() + nbytes(*params[:4]) + nbytes(*got["vec"])
    res = bound(moved, 2 * b * l * dc * k, torch.float32)
    del got
    ms = {body: cuda_ms(fn, 20) for body, fn in run.items()}
    log(f"[kernels] K7 prologue {tag}: vec body equal to the general body to the bit (xbc, dt, "
        f"cum); vec {ms['vec']:.4f} ms, general {ms['general']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {moved} B)")


def phase_mamba(device, frames) -> tuple[dict, dict]:
    """Phase 7. Returns (K7's row at the prod serving shape, the launch
    counts of the Mamba serving run)."""
    from pixel_heal_thyself_tpu_torch.measure import mamba_chain_flops
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import fused_mamba_chain_torch
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_cuda

    kwargs = mamba_prod_kwargs()
    zx, params, dims = mamba_inputs(device)
    b, l, _ = zx.shape
    di, n, p, q = (dims[key] for key in ("d_inner", "d_state", "headdim", "chunk"))
    flops = mamba_chain_flops(b, l, di, n, di // p, q)[0]
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
    log_per_launch(f"K7 bf16 ({b} × {l} tokens)",
                   lambda: fused_mamba_chain_cuda(zx, *params, **dims))
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        prologue_bodies(f"{label} ({b} × {l} tokens, xBC width {di + 2 * n})", zx.to(dtype),
                        params, dims)
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


def named_devs(bounds: dict, got, ref) -> dict:
    """The deviation of each output from its reference, by the names of
    `bounds` (in the outputs' order)."""
    return {name: deviation(g, r) for name, g, r in zip(bounds, got, ref, strict=True)}


def outside(devs: dict, bounds: dict) -> list:
    """The outputs outside their (max_rel, rms_rel) bounds."""
    return [name for name, dev in devs.items()
            if dev["max_rel"] > bounds[name][0] or dev["rms_rel"] > bounds[name][1]]


def check_named(name: str, got, ref, bounds: dict) -> dict:
    """A kernel's outputs against the plain version's, each at its bound
    in `bounds`; prints every one; returns the worst deviation."""
    devs = named_devs(bounds, got, ref)
    log(f"[kernels] {name}: " + ", ".join(
        f"{g} {d['max_rel']:.3e}/{d['rms_rel']:.3e}" for g, d in devs.items())
        + " (max_rel/rms_rel)")
    bad = outside(devs, bounds)
    if bad:
        raise AssertionError(f"{name}: {bad} exceed {bounds}")
    return {k: max(d[k] for d in devs.values()) for k in ("max_abs_err", "max_rel", "rms_rel")}


def check_table(tag: str, table: list, tol: tuple) -> None:
    """Raise if a gradient of `grad_table`'s rows is outside tol = (rms, mass)."""
    for name, rms, mass in table:
        if rms > tol[0] or mass > tol[1]:
            raise AssertionError(f"{tag}: G gradient {name}: rms {rms:.3e} mass {mass:.3e} "
                                 f"> {tol}")


def carry_cut_chain_bwd(zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, states, dy,
                        d_inner, d_state, headdim, chunk):
    """The plain backward with the reverse carry of the state gradient cut
    (every chunk's leaving-state gradient zeroed): the fault K8's bounds
    must catch."""
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import (
        chain_norm_bwd,
        chain_prologue,
        chain_prologue_bwd,
        chain_scan,
        chain_scan_bwd,
    )

    zx = zxbcdt.float()
    xbc, dt, cum = chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    y, _ = chain_scan(xbc, dt, cum, D, d_inner, d_state, headdim, states=states)
    dy_ssd, dz, dnw = chain_norm_bwd(y, zx[..., :d_inner], norm_w, dy.float())
    dst_out = torch.zeros(states.shape, dtype=torch.float32, device=states.device)
    dxbc, ddt, dA, dD = chain_scan_bwd(xbc, dt, cum, A, D, states, dst_out, dy_ssd,
                                       d_inner, d_state, headdim)
    dxr, dw, db, ddtr, dbias = chain_prologue_bwd(zx, conv_w, conv_b, dt_bias, dxbc, ddt,
                                                  d_inner)
    return torch.cat([dz, dxr, ddtr], dim=-1).to(zxbcdt.dtype), dw, db, dbias, dA, dD, dnw


def generator_layer_calls(device) -> list:
    """The Mamba2 layer calls of the prod generator's first training forward
    (seeded weights and batch, train mode): [(args, dims)] as
    `MambaChainFn` hands them to K7's emit variant. The kernels' own rows
    run on random inputs; these are the inputs the main path gives them."""
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs
    from pixel_heal_thyself_tpu_torch.ops import ssd_mega
    from pixel_heal_thyself_tpu_torch.training.train_step import prepare_batch

    g, _, data = _train_state(device, torch.float32, mamba_prod_kwargs(), TRAIN["patch"],
                              TRAIN["batch"], seed=3, net=MambaDenoiserNet)
    calls, emit = [], ssd_mega.fused_mamba_chain_emit

    def record(*args, **dims):
        calls.append(([t.detach().clone() for t in args], dims))
        return emit(*args, **dims)

    ssd_mega.fused_mamba_chain_emit = record
    try:
        noisy, _, aux = prepare_batch(data["noisy"], data["gt"], data["aux"])
        g(noisy, aux)
    finally:
        ssd_mega.fused_mamba_chain_emit = emit
    return calls


def phase_mamba_kernels(device) -> dict:
    """Phase 8, kernels: K7's emit variant and K8 against their plain
    versions at 8 × 16,384 tokens in bf16 and fp32, and the carry-cut
    control, which must fail K8's bounds. Returns the bf16 rows by name."""
    from pixel_heal_thyself_tpu_torch.measure import mamba_chain_flops
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import (
        fused_mamba_chain_bwd_torch,
        fused_mamba_chain_torch,
    )
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
        fused_mamba_chain_bwd_cuda,
        fused_mamba_chain_emit_cuda,
    )

    # K7's emit variant on the prod generator's own layer inputs (bf16): its
    # output and entering states within K7's bf16 bounds
    for i, (args, dims) in enumerate(generator_layer_calls(device)):
        got = fused_mamba_chain_emit_cuda(*args, **dims)
        ref = fused_mamba_chain_torch(*args, **dims, emit=True)
        devs = {name: deviation(g, r) for name, g, r in zip(("out", "states"), got, ref)}
        log(f"[kernels] K7 emit on the prod generator's layer {i} inputs: " + ", ".join(
            f"{name} max_rel {dv['max_rel']:.3e} rms_rel {dv['rms_rel']:.3e}"
            for name, dv in devs.items()) + f" (bounds {MAMBA_TOL['bf16']})")
        for name, dv in devs.items():
            check(f"K7 emit, generator layer {i} {name}", dv, MAMBA_TOL["bf16"])
        prologue_bodies(f"on the prod generator's layer {i} inputs", args[0], args[1:], dims,
                        timed=False)
        del got, ref, args
    zx, params, dims = mamba_inputs(device)
    b, l, _ = zx.shape
    di, n, p, q = (dims[key] for key in ("d_inner", "d_state", "headdim", "chunk"))
    fwd_flops, bwd_flops = mamba_chain_flops(b, l, di, n, di // p, q)
    dy = torch.randn(b, l, di, generator=torch.Generator(device=device).manual_seed(8765),
                     device=device)
    rows = {}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        args = (zx.to(dtype), *params)
        el = args[0].element_size()
        out_bytes, st_bytes = b * l * di * el, b * (l // q) * n * di * el
        tag = f"{label} ({b} × {l} tokens, d_inner {di}, d_state {n})"
        emit = compare(
            f"K7 emit {tag}",
            lambda args=args: fused_mamba_chain_emit_cuda(*args, **dims),
            lambda args=args: fused_mamba_chain_torch(*args, **dims, emit=True),
            MAMBA_TOL[label], iters=10, plain_iters=2,
            work=(nbytes(*args) + out_bytes + st_bytes, fwd_flops, dtype),
        )
        _, states = fused_mamba_chain_torch(*args, **dims, emit=True)
        dyt = dy.to(dtype)
        bwd_args = (*args, states, dyt)
        # reads zxbcdt, the parameters, the states and dy; writes dzx and
        # the parameter gradients
        bwd = compare(
            f"K8 {tag}",
            lambda a=bwd_args: fused_mamba_chain_bwd_cuda(*a, **dims),
            lambda a=bwd_args: fused_mamba_chain_bwd_torch(*a, **dims),
            None, iters=5, plain_iters=1,
            check_fn=partial(check_named, bounds=MAMBA_BWD_TOL[label]),
            work=(nbytes(*bwd_args) + nbytes(*args), bwd_flops, dtype),
        )
        if label == "bf16":
            rows["K7e"], rows["K8"] = emit, bwd
            run = partial(fused_mamba_chain_bwd_cuda, *bwd_args, **dims)
            log_per_launch(f"K8 {tag}", run)
            assert_deterministic(f"K8 {tag}", run)
            devs = named_devs(MAMBA_BWD_TOL[label], carry_cut_chain_bwd(*bwd_args, **dims),
                              fused_mamba_chain_bwd_torch(*bwd_args, **dims))
            bad = outside(devs, MAMBA_BWD_TOL[label])
            log("[kernels] control: plain backward with the state-gradient carry cut vs plain: "
                + ", ".join(f"{g} {d['max_rel']:.3e}/{d['rms_rel']:.3e}" for g, d in devs.items())
                + f"; outside K8's bounds: {bad}")
            if not bad:
                raise AssertionError("K8's bounds pass a backward without the state carry")
        del states, bwd_args, args
    return rows


def _train_state(device, d_dtype, g_kwargs, patch, batch, seed, net=None):
    """Seeded G (`net`, AFGSANet by default) and D (in `d_dtype`), and one
    numpy batch (bench.py:107-118) on the card."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG

    g = (net or AFGSANet)(**g_kwargs, device=device,
                          generator=torch.Generator().manual_seed(seed))
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


def _step_grads(device, g_kwargs, patch, batch, alpha, nudge=False, net=None):
    """One train step from the seeded state with a float32 critic:
    (metrics, G gradients). `nudge` moves every noisy input value to the
    next bf16 value up: a change of one bf16 ulp, whose effect on the
    gradients is the floor that bf16 rounding flips alone set."""
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    g, d, data = _train_state(device, torch.float32, g_kwargs, patch, batch, seed=3, net=net)
    if nudge:  # the inputs are ≥ 0, so one more in the bits is one ulp up
        bits = data["noisy"].to(torch.bfloat16).view(torch.int16) + 1
        data["noisy"] = bits.view(torch.bfloat16).float()
    spec = make_optimizer(1e-4, [2], 0.5, 100)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    metrics = {key: val.item() for key, val in step(data, alpha=alpha).items()}
    # (a Mamba generator's aux encoder feeds no block and gets no gradient)
    return metrics, {n: p.grad.detach().clone() for n, p in g.named_parameters()
                     if p.grad is not None}


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


def train_and_compare(device, net, kwargs, route, names: tuple, layers: int, literal: dict,
                      grad_tol: tuple, tag: str) -> dict:
    """The prod GAN step with generator `net(**kwargs)` (`route(g)` says it
    takes its kernel route): 2 warm-up and 5
    timed steps (finite losses; each kernel in `names` launched for every
    one of `layers` layers of every step), then one step through the kernel
    and plain routes, beside the plain route repeated and two witnesses of
    the bf16 flip floor (the inputs one ulp up; the plain literal route,
    `literal` over the plain kwargs), against `grad_tol` = (rms, mass).
    Returns the launch counts of the 7 steps and the steady patches/s."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import count_params
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    patch, batch, warmup, timed = (TRAIN[k] for k in ("patch", "batch", "warmup", "timed"))
    g, d, data = _train_state(device, torch.bfloat16, kwargs, patch, batch, seed=0, net=net)
    assert route(g), f"the prod {net.__name__} step must take its kernel route"
    spec = make_optimizer(1e-4, [2], 0.5, 100)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    gen = torch.Generator(device=device).manual_seed(7)
    log(f"[{tag}] prod step: G {net.__name__} {count_params(g)} params (bf16, {layers} blocks, "
        f"kernel route), D {count_params(d)} params; batch {batch} × {patch}², WGAN-GP + L1")

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
    check_bodies(tag, launches)
    peak = torch.cuda.max_memory_allocated()
    del g, d, data, step

    for i, m in enumerate(history):
        if not all(math.isfinite(val) for val in m.values()):
            raise AssertionError(f"step {i}: non-finite losses {m}")
    need = layers * (warmup + timed)
    for name in names:
        if launches[name] < need:
            raise AssertionError(f"{name} launched {launches[name]} times < {need} "
                                 f"({layers} blocks × {warmup + timed} steps)")
    steady = float(np.mean(secs[warmup:]))
    log(f"[{tag}] launches {launches} (need ≥ {need} each of {', '.join(names)})")
    log(f"[{tag}] losses step 0 {history[0]}; step {len(history) - 1} {history[-1]}")
    log(f"[{tag}] seconds per step {[round(s_, 4) for s_ in secs]} (first {warmup} warm-up); "
        f"steady {steady:.4f} s/step = {batch / steady:.3f} patches/s; "
        f"peak memory {peak} B ({peak / 2**30:.3f} GiB)")

    alpha = torch.rand((batch, 1, 1, 1), generator=gen, device=device)
    plain = dict(kwargs, use_kernels=False)
    with deterministic_cudnn():
        mk, gk = _step_grads(device, kwargs, patch, batch, alpha, net=net)
        mp, gp = _step_grads(device, plain, patch, batch, alpha, net=net)
        # the plain route against itself (the comparison's noise floor), and
        # two witnesses of how far bf16 rounding alone moves these
        # gradients: the inputs one ulp up, and the literal route (autograd
        # through plain bf16 ops, which round at other points)
        witnesses = {
            "plain route repeated (noise floor)": _step_grads(device, plain, patch, batch, alpha,
                                                              net=net),
            "plain route, inputs one bf16 ulp up": _step_grads(device, plain, patch, batch, alpha,
                                                              nudge=True, net=net),
            "plain literal route": _step_grads(device, dict(plain, **literal), patch, batch,
                                               alpha, net=net),
        }
    for key in ("d_loss", "g_loss"):
        if abs(mk[key] - mp[key]) > STEP_LOSS_TOL * max(1.0, abs(mp[key])):
            raise AssertionError(f"{key}: kernel route {mk[key]} vs plain route {mp[key]}")
    table = grad_table(gk, gp)
    for name, rms, mass in table[:8]:
        log(f"[{tag}]   G gradient {name}: rms_rel {rms:.4e} mass {mass:.4e}")
    log(f"[{tag}] kernel route vs plain route: G gradients worst rms_rel "
        f"{max(r[1] for r in table):.4e}, worst mass {table[0][2]:.4e} ({table[0][0]})")
    for label, (mw, gw) in witnesses.items():
        rows = grad_table(gw, gp)
        at = {r[0]: r for r in rows}
        log(f"[{tag}] {label} vs plain route: d_loss {mw['d_loss']:.6g}, g_loss "
            f"{mw['g_loss']:.6g}; G gradients worst rms_rel "
            f"{max(r[1] for r in rows):.4e}, worst mass {rows[0][2]:.4e} ({rows[0][0]}); "
            + ", ".join(f"{n} rms_rel {at[n][1]:.4e} mass {at[n][2]:.4e}" for n, *_ in table[:3]))
    check_table(tag, table, grad_tol)
    dev = deviation(list(gk.values()), list(gp.values()))
    log(f"[{tag}] one step (float32 critic), kernel route vs plain route: d_loss "
        f"{mk['d_loss']:.6g} vs {mp['d_loss']:.6g}, g_loss {mk['g_loss']:.6g} vs "
        f"{mp['g_loss']:.6g}; G gradients worst max_rel {dev['max_rel']:.6g} rms_rel "
        f"{dev['rms_rel']:.6g} (bounds rms {grad_tol[0]}, mass {grad_tol[1]})")
    return launches, batch / steady


def phase_training(device) -> tuple[dict, float]:
    """Phase 5. Returns the launch counts of the 7 training steps and the
    steady patches/s."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs

    kwargs = afgsa_prod_kwargs()
    patch = TRAIN["patch"]
    return train_and_compare(device, AFGSANet, kwargs,
                             lambda g: g.block_route(TRAIN["batch"], patch, patch),
                             ("K1", "K2", "K3", "K4", "K5", "K6"), kwargs["num_sa"],
                             dict(use_block_kernel=False), STEP_GRAD_TOL, "train")


def phase_mamba_training(device) -> tuple[dict, float]:
    """Phase 8, training. Returns the launch counts of the 7 steps and the
    steady patches/s."""
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs

    kwargs = mamba_prod_kwargs()
    tokens = TRAIN["patch"] ** 2
    return train_and_compare(device, MambaDenoiserNet, kwargs,
                             lambda g: all(blk.mamba.fused_route(tokens) for blk in g.blocks),
                             ("K7e", "K8"), kwargs["num_blocks"], dict(use_megakernel=False),
                             MAMBA_STEP_GRAD_TOL, "mamba-train")


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


def ssd_scan_inputs(device, b: int, l: int, h: int, p: int, n: int) -> tuple:
    """Seeded Mamba-like inputs of the SSD scan: x, B, C ~ N(0, 1) and dt
    log-uniform on [0.001, 0.1] (the Mamba2 dt init) in bf16, A in
    -[1, 16] (its A init) and D in f32."""
    g = torch.Generator(device=device).manual_seed(2468)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    x = torch.randn(b, l, h, p, generator=g, device=device).bfloat16()
    dt = torch.exp(rand(b, l, h) * math.log(100.0) + math.log(0.001)).bfloat16()
    B = torch.randn(b, l, 1, n, generator=g, device=device).bfloat16()
    C = torch.randn(b, l, 1, n, generator=g, device=device).bfloat16()
    return x, dt, -(1 + 15 * rand(h)), B, C, torch.randn(h, generator=g, device=device)


def f32_carry_scan(x, dt, A, B, C, D, chunk: int):
    """The plain scan with the state carried between chunks in f32: the
    rounding K11's bf16 bound must catch missing."""
    from pixel_heal_thyself_tpu_torch.ops.ssd import pallas_outputs, pallas_stacks, pallas_states

    cum, xdt, Bc, Cc = pallas_stacks(x, dt, A, B, C, chunk)
    return pallas_outputs(cum, xdt, Bc, Cc, pallas_states(cum, xdt, Bc, torch.float32), x, D)


def phase_literal_kernels(device) -> dict:
    """Phase 9, kernels: K9 and K10 at the prod zxbcdt, K11 at the prod SSD
    shape, in bf16 and fp32 (K9 and K10 on their vec bodies, K11 bf16 on its
    tensor-core body and fp32 on its general body), K10's and K11's device
    time per launch, and K11's f32-carry control. Returns the bf16 rows by
    name."""
    from pixel_heal_thyself_tpu_torch.measure import mamba_chain_flops
    from pixel_heal_thyself_tpu_torch.ops.conv_cuda import (
        fused_causal_conv1d_silu_bwd_cuda,
        fused_causal_conv1d_silu_cuda,
    )
    from pixel_heal_thyself_tpu_torch.ops.conv_fused import _pre as conv_fused_pre
    from pixel_heal_thyself_tpu_torch.ops.conv_fused import (
        fused_causal_conv1d_silu_bwd_torch,
        fused_causal_conv1d_silu_torch,
    )
    from pixel_heal_thyself_tpu_torch.ops.ssd import ssd_pallas_torch
    from pixel_heal_thyself_tpu_torch.ops.ssd_cuda import ssd_pallas_cuda

    zx, params, dims = mamba_inputs(device)
    conv_w, conv_b = params[0], params[1]
    del params
    b, l, _ = zx.shape
    di, n, p, q = (dims[key] for key in ("d_inner", "d_state", "headdim", "chunk"))
    h, k, width = di // p, conv_w.shape[0], conv_w.shape[1]
    dy = torch.randn(b, l, width, generator=torch.Generator(device=device).manual_seed(97),
                     device=device)
    rows = {}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        z = zx.to(dtype)
        win_bytes = b * l * width * z.element_size()
        tag = f"{label} (zxbcdt {tuple(z.shape)}, window {di} + {width})"
        fwd = (z, conv_w, conv_b, di, width)
        # the library yardstick (never called by the port): cuDNN's grouped
        # conv1d on the contiguous window, zero-padded both sides, no SiLU
        xw = z[..., di:di + width].transpose(1, 2).contiguous()
        wc, bc = conv_w.t().unsqueeze(1).to(dtype).contiguous(), conv_b.to(dtype)
        k9 = expect_body("K9", "vec", lambda: compare(
            f"K9 fused conv1d + SiLU {tag}",
            lambda a=fwd: fused_causal_conv1d_silu_cuda(*a),
            lambda a=fwd: fused_causal_conv1d_silu_torch(*a),
            CONV_TOL[label], iters=20, plain_iters=3,
            work=(2 * win_bytes + nbytes(conv_w, conv_b), 2 * b * l * width * k, dtype),
            library=lambda: F.conv1d(xw, wc, bc, padding=k - 1, groups=width),
        ))
        y_err = (fused_causal_conv1d_silu_cuda(*fwd).float()
                 - fused_causal_conv1d_silu_torch(*fwd).float()).abs().max().item()
        log(f"[kernels] K9 {label}: y max_abs_err {y_err:.6g} against the plain version")
        bwd = (z, conv_w, conv_b, dy.to(dtype), di, width)
        # K10's yardstick: cuDNN's grouped conv1d backward (input, weight and
        # bias gradients) for the same dpre, which it is handed: the SiLU
        # gate that forms dpre (and the window's slicing) is left untimed
        x32 = z[..., di:di + width].float()
        pre = conv_fused_pre(x32, conv_w, conv_b)
        sig = torch.sigmoid(pre)
        dpre = (dy.to(dtype).float() * (sig * (1 + pre * (1 - sig)))).to(dtype)
        gout = F.pad(dpre.transpose(1, 2), (0, k - 1)).contiguous()
        del x32, pre, sig, dpre
        k10 = expect_body("K10", "vec", lambda: compare(
            f"K10 fused conv1d + SiLU backward {tag} (library: cuDNN's grouped conv1d "
            f"backward for the same dpre; the SiLU gate that forms dpre left untimed)",
            lambda a=bwd: fused_causal_conv1d_silu_bwd_cuda(*a),
            lambda a=bwd: fused_causal_conv1d_silu_bwd_torch(*a),
            None, iters=20, plain_iters=3,
            check_fn=partial(check_named, bounds=CONV_BWD_TOL[label]),
            # reads the window and dy, writes dx; the taps and their gradients
            work=(3 * win_bytes + 2 * nbytes(conv_w, conv_b), 4 * b * l * width * k, dtype),
            library=lambda: torch.ops.aten.convolution_backward(
                gout, xw, wc, [width], [1], [k - 1], [1], False, [0], width,
                [True, True, True]),
        ))
        dx_err = (fused_causal_conv1d_silu_bwd_cuda(*bwd)[0].float()
                  - fused_causal_conv1d_silu_bwd_torch(*bwd)[0].float()).abs().max().item()
        log(f"[kernels] K10 {label}: dx max_abs_err {dx_err:.6g} against the plain version")
        if label == "bf16":
            rows["K9"], rows["K10"] = k9, k10
            log_per_launch(f"K10 bf16 (zxbcdt {tuple(z.shape)})",
                           lambda a=bwd: fused_causal_conv1d_silu_bwd_cuda(*a))
        del bwd, fwd, z, xw, wc, bc, gout
    del zx, dy

    scan = ssd_scan_inputs(device, b, l, h, p, n)
    flops = mamba_chain_flops(b, l, di, n, h, q)[0]
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        args = tuple(t.to(dtype) if t.dim() > 1 else t for t in scan)
        row = expect_body("K11", "tc" if label == "bf16" else "general", lambda a=args: compare(
            f"K11 ssd_pallas {label} (x {tuple(a[0].shape)}, d_state {n}, chunk {q})",
            lambda: ssd_pallas_cuda(*a, chunk=q),
            lambda: ssd_pallas_torch(*a, chunk=q),
            SSD_SCAN_TOL[label], iters=10, plain_iters=2,
            work=(nbytes(*a, a[0]), flops, dtype),
        ))
        if label == "bf16":
            rows["K11"] = row
            assert_deterministic("K11 bf16", lambda a=args: (ssd_pallas_cuda(*a, chunk=q),))
            log_per_launch(f"K11 bf16 (x {tuple(args[0].shape)})",
                           lambda a=args: ssd_pallas_cuda(*a, chunk=q))
    ctl = deviation(f32_carry_scan(*scan, chunk=q), ssd_pallas_torch(*scan, chunk=q))
    log(f"[kernels] control: plain scan with the state carried in f32 vs plain: "
        f"max_rel {ctl['max_rel']:.6g} rms_rel {ctl['rms_rel']:.6g} "
        f"(must exceed K11's bf16 rms bound {SSD_SCAN_TOL['bf16'][1]}; K11 read "
        f"{rows['K11']['rms_rel']:.6g})")
    if ctl["rms_rel"] <= SSD_SCAN_TOL["bf16"][1]:
        raise AssertionError("K11's bf16 bound passes a scan that carries the state in f32")
    return rows


def phase_literal_path(device) -> dict:
    """Phase 9, the path: the bench_mamba sections at batch 8 with the fused
    conv on the literal route; then the G forward and the L1 forward +
    backward, kernel route against plain route. Returns the launch counts
    of the sections."""
    from pixel_heal_thyself_tpu_torch import bench_mamba

    batch, patch = MAMBA["batch"], TRAIN["patch"]
    reset_counts()
    bench_mamba.run(batch=batch, patch=patch, iters=BENCH_ITERS, pallas=True, mega=False,
                    device=device)
    torch.cuda.synchronize()
    launches = read_counts()
    check_bodies("literal-mamba", launches)
    data = bench_mamba.make_inputs(batch, patch, device)
    models = [bench_mamba.make_model(True, False, kernels, device) for kernels in (True, False)]
    assert all(blk.mamba.fused_conv_route(patch * patch) and not blk.mamba.fused_route(
        patch * patch) for blk in models[0].blocks), "the literal route with the fused conv"
    calls, layers = BENCH_ITERS + 2, len(models[0].blocks)  # each section's warm-up + timed
    # the G forward and the G forward + backward sections: a K9 for every
    # layer of each forward, a K10 for every layer of each backward
    need = {"K9": 2 * layers * calls, "K10": layers * calls, "K11": calls}
    log(f"[literal-mamba] launches {launches} (need ≥ {need}: every layer of every G forward "
        f"K9, of every backward K10; the ssd_pallas section K11)")
    for name, count in need.items():
        if launches[name] < count:
            raise AssertionError(f"{name} launched {launches[name]} times < {count}")
    with deterministic_cudnn():
        out_k, out_p = (bench_mamba.g_fwd(m, data) for m in models)
        dev = deviation(out_k, out_p)
        log(f"[literal-mamba] G forward, kernel route vs plain route: max_rel "
            f"{dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} (bound {FRAME_TOL})")
        check("literal Mamba G forward", dev, FRAME_TOL)
        del out_k, out_p
        gk = {k: v.clone() for k, v in bench_mamba.g_fwd_bwd(models[0], data).items()}
        gp = bench_mamba.g_fwd_bwd(models[1], data)
    table = grad_table(gk, gp)
    log(f"[literal-mamba] G L1 forward + backward, kernel route vs plain route: worst rms_rel "
        f"{max(r[1] for r in table):.4e}, worst mass {table[0][2]:.4e} ({table[0][0]}) "
        f"(bounds {MAMBA_STEP_GRAD_TOL})")
    check_table("literal-mamba", table, MAMBA_STEP_GRAD_TOL)
    return launches


def phase_fold_qkv(device) -> dict:
    """Phase 10: one L1 forward + backward of the prod-width AFGSANet on the
    literal route with fold_qkv against the unfolded model (same weights).
    Returns the launch counts of the folded run."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs

    kwargs = dict(afgsa_prod_kwargs(), use_block_kernel=False)
    patch, batch = TRAIN["patch"], TRAIN["batch"]
    folded = AFGSANet(**dict(kwargs, fold_qkv=True), device=device,
                      generator=torch.Generator().manual_seed(11))
    plain = AFGSANet(**kwargs, device=device)
    plain.load_state_dict(folded.state_dict())
    assert all(blk.attention.folded for blk in folded.blocks)
    assert not plain.block_route(batch, patch, patch)
    rng = np.random.default_rng(12)
    noisy, gt = (torch.from_numpy(np.abs(rng.standard_normal((batch, patch, patch, 3)))
                                  .astype(np.float32)).to(device) for _ in range(2))
    aux = torch.from_numpy(rng.standard_normal((batch, patch, patch, 7)).astype(np.float32)
                           ).to(device)

    def fwd_bwd(model):
        out = model(noisy, aux)
        (out - gt).abs().mean().backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    with deterministic_cudnn():
        reset_counts()
        out_f, grads_f = fwd_bwd(folded)
        torch.cuda.synchronize()
        launches = read_counts()
        check_bodies("fold-qkv", launches)
        out_u, grads_u = fwd_bwd(plain)
    for name in ("K1", "K4"):
        if launches[name] < kwargs["num_sa"]:
            raise AssertionError(f"folded route: {name} launched {launches[name]} times")
    dev = deviation(out_f, out_u)
    table = grad_table(grads_f, grads_u)
    log(f"[fold-qkv] prod AFGSANet literal route, {batch} × {patch}², launches {launches}; "
        f"folded vs unfolded: output max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} "
        f"(bound {FRAME_TOL}); G gradients worst rms_rel {max(r[1] for r in table):.4e}, "
        f"worst mass {table[0][2]:.4e} ({table[0][0]}) (bounds {STEP_GRAD_TOL})")
    check("fold_qkv output", dev, FRAME_TOL)
    check_table("fold-qkv", table, STEP_GRAD_TOL)
    return launches


# phase 11: `train.main` at `-cn prod` (AFGSA and Mamba) on synthetic scenes.
# The default synthetic_size 128 leaves no room for 128² patches
# (`importance_sampling` raises "too small" in both packages), so the
# scenes are 512²; the rest is prod: 4 scene pairs, num_patches 400, batch
# 8 × 128², bf16, the kernels on, val batch 8. Cut: 2 epochs (prod 12).
TRAINER_CONFIG = "prod"
TRAINER_ARGS = ["data.images.synthesize=true", "data.images.synthetic_size=512",
                "trainer.epochs=2", "--device", "cuda"]
# per model: the kernels every train step and every validation forward run
TRAINER_KERNELS = {"afgsa": (("K1", "K2", "K3", "K4", "K5", "K6"), ("K1", "K2", "K3")),
                   "mamba": (("K7e", "K8"), ("K7",))}
EPOCH_SUMMARY = re.compile(r"\[Train\] epoch=(\d+) summary: .*\(([\d.]+) patches/sec, "
                           r"io ([\d.]+)s = (\d+)%\)")


def decode_png(path) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit RGB PNG with unfiltered rows, as
    `utils.images.write_png` writes one; every chunk's CRC is checked."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0]:
            raise AssertionError(f"{path}: bad CRC in {tag!r}")
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2):
        raise AssertionError(f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def _snapshot(state) -> dict:
    return {"g": _clone(state.g.state_dict()), "g_opt": _clone(state.g_opt.state_dict()),
            "d_opt": _clone(state.d_opt.state_dict())}


@contextlib.contextmanager
def trainer_probe(train_names: tuple, eval_names: tuple):
    """Wrap the trainer's step factories and checkpoint functions for one
    run. Records each train step's and each validation forward's launches
    of its kernels (counter deltas around the call), the first validation
    batch with its output and G's weights then, the state each save wrote
    and the state each restore left."""
    from pixel_heal_thyself_tpu_torch.training import checkpoints
    from pixel_heal_thyself_tpu_torch.training import trainer as trainer_mod

    fns = counters()
    rec = {"train": [], "eval": [], "first_eval": None, "saved": {}, "restored": None}

    def counted(kind: str, names: tuple, make):
        def make_counted(*args, **kwargs):
            fn = make(*args, **kwargs)

            def run(*a, **k):
                before = {n: fns[n].launches for n in names}
                out = fn(*a, **k)
                rec[kind].append({n: fns[n].launches - before[n] for n in names})
                if kind == "eval" and rec["first_eval"] is None:
                    rec["first_eval"] = (_clone(a[0]), out[0].detach().clone(),
                                         _clone(args[0].state_dict()))
                return out

            run.__dict__.update(fn.__dict__)  # the step's optimizers
            return run
        return make_counted

    real = (trainer_mod.make_train_step, trainer_mod.make_eval_step,
            checkpoints.save_checkpoint, checkpoints.restore_checkpoint)

    def save(path, state, epoch):
        real[2](path, state, epoch)
        rec["saved"][epoch] = _snapshot(state)

    def restore(path, state):
        epoch = real[3](path, state)
        rec["restored"] = dict(_snapshot(state), lr=state.g_opt.param_groups[0]["lr"],
                               count=state.g_sched.last_epoch)
        return epoch

    trainer_mod.make_train_step = counted("train", train_names, real[0])
    trainer_mod.make_eval_step = counted("eval", eval_names, real[1])
    checkpoints.save_checkpoint, checkpoints.restore_checkpoint = save, restore
    try:
        yield rec
    finally:
        trainer_mod.make_train_step, trainer_mod.make_eval_step = real[0], real[1]
        checkpoints.save_checkpoint, checkpoints.restore_checkpoint = real[2], real[3]


@contextlib.contextmanager
def trainer_log():
    """The trainer's log lines, kept in a list instead of printed."""
    lg = logging.getLogger("pht_tpu")
    lines: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep(logging.INFO)
    levels = [(h, h.level) for h in lg.handlers]
    for h, _ in levels:
        h.setLevel(logging.WARNING)
    lg.addHandler(keep)
    try:
        yield lines
    finally:
        lg.removeHandler(keep)
        for h, level in levels:
            h.setLevel(level)


def run_trainer(argv: list, model: str) -> tuple:
    """`train.main(argv)` from counts of 0 and a fresh run-dir pin: (trainer,
    probe record, log lines, launch counts, seconds, peak memory)."""
    from pixel_heal_thyself_tpu_torch import train
    from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache

    reset_run_dirs_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with trainer_probe(*TRAINER_KERNELS[model]) as rec, trainer_log() as lines:
        t0 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return trainer, rec, lines, read_counts(), secs, torch.cuda.max_memory_allocated()


def check_trainer_run(tag: str, model: str, trainer, rec: dict, launches: dict,
                      epochs: list, layers: int) -> Path:
    """A run's artifacts and launches; returns its run directory."""
    run = Path(trainer.cfg.paths.output_dir)
    if trainer.loader_kind != "device":
        raise AssertionError(f"[{tag}] data.loader=auto resolved to {trainer.loader_kind!r}")
    patch = trainer.cfg.data.patches.patch_size
    for name, pattern in (("train_loss.txt", r"Epoch: (\d+) \tG loss: (\S+) \tD Loss: (\S+)"),
                          ("evaluation.txt", r"Validation: (\d+) \tAvg MRSE: (\S+) \tAvg PSNR: "
                                             r"(\S+) \tAvg 1-SSIM: (\S+)")):
        text = (run / name).read_text()
        rows = [re.fullmatch(pattern, line) for line in text.splitlines()]
        if not all(rows) or [int(m[1]) for m in rows] != epochs:
            raise AssertionError(f"[{tag}] {name} is not one line per epoch {epochs}: {text!r}")
        if not all(math.isfinite(float(v)) for m in rows for v in m.groups()[1:]):
            raise AssertionError(f"[{tag}] {name}: non-finite values {text!r}")
        log(f"[{tag}] {name}: " + " | ".join(text.splitlines()))
    for epoch in epochs:
        folder = run / f"model_epoch{epoch}"
        if not (folder / "state" / "checkpoint.pt").is_file():
            raise AssertionError(f"[{tag}] {folder}/state has no checkpoint")
        panels = sorted(folder.glob("*.png"))
        for png in panels:
            if decode_png(png).shape != (patch, 3 * patch, 3):
                raise AssertionError(f"[{tag}] {png}: not a {patch} × {3 * patch} panel")
        if not panels:
            raise AssertionError(f"[{tag}] {folder} has no panels")
    n_train = len(np.load(Path(trainer.cfg.data.patches.dir) / "train" / "aux.npy", mmap_mode="r"))
    steps = len(epochs) * -(-n_train // trainer.cfg.trainer.batch_size)
    if len(rec["train"]) != steps:
        raise AssertionError(f"[{tag}] {len(rec['train'])} train steps, expected {steps}")
    for kind in ("train", "eval"):
        short = [(i, d) for i, d in enumerate(rec[kind]) if any(v < layers for v in d.values())]
        if short or not rec[kind]:
            raise AssertionError(f"[{tag}] {kind} calls with fewer than {layers} launches of a "
                                 f"kernel: {short[:3]} ({len(rec[kind])} calls)")
    check_bodies(tag, launches)
    log(f"[{tag}] {len(rec['train'])} train steps each launched ≥ {layers} of "
        f"{', '.join(TRAINER_KERNELS[model][0])}; {len(rec['eval'])} validation forwards each "
        f"≥ {layers} of {', '.join(TRAINER_KERNELS[model][1])}; launches {launches}")
    return run


def phase_trainer(device, frame: dict, step_rates: dict, smi: str) -> None:
    """Phase 11: the training CLI, `train.main`, for `-cn prod` and `-cn prod
    model=mamba` in a temporary working directory: two epochs each, every
    step and validation forward through its kernels on their prod bodies,
    the first validation batch against the plain route, a resume from
    model_epoch1 to the bit, and model_epoch2 served through
    `inference.load_generator` equal to the trainer's G."""
    from pixel_heal_thyself_tpu_torch.inference import (
        afgsa_kwargs_from_config,
        denoise_frame_fused,
        load_generator,
        make_fused_frame_apply,
        mamba_kwargs_from_config,
    )
    from pixel_heal_thyself_tpu_torch.metrics import calculate_ssim
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        make_eval_step,
        multistep_milestone_epochs,
        multistep_schedule,
    )
    from pixel_heal_thyself_tpu_torch.utils.images import tensor2img

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        for model in ("afgsa", "mamba"):
            tag = f"trainer-{model}"
            base = ["-cn", TRAINER_CONFIG] + (["model=mamba"] if model == "mamba" else [])
            trainer, rec, lines, launches, secs, peak = run_trainer(
                base + TRAINER_ARGS + ["run_num=0"], model)
            cfg = trainer.cfg
            g = trainer.state.g
            layers = cfg.model.self_attention.num_layers if model == "afgsa" else cfg.model.num_layers
            if not trainer.use_kernels:
                raise AssertionError(f"[{tag}] the trainer did not take the kernels")
            run0 = check_trainer_run(tag, model, trainer, rec, launches, [1, 2], layers)
            for line in lines:
                if any(key in line for key in ("summary:", "patch store", "resolved", "in total")):
                    log(f"[{tag}] trainer: {line}")
            if trainer.store_build_seconds is not None:
                log(f"[{tag}] patch store built in {trainer.store_build_seconds:.2f} s "
                    f"(synthetic 512² scenes, 4 pairs, num_patches "
                    f"{cfg.data.patches.num_patches}, patch {cfg.data.patches.patch_size}); {smi}")
            for m in (EPOCH_SUMMARY.search(line) for line in lines):
                if m:
                    log(f"[{tag}] epoch {m[1]}: {m[2]} patches/s with the loader and host syncs "
                        f"in the loop, io {m[3]} s = {m[4]}% (the trainer's summary); step alone "
                        f"{step_rates[model]:.3f} patches/s (phase {5 if model == 'afgsa' else 8}); "
                        f"{smi}")
            log(f"[{tag}] run of 2 epochs {secs:.2f} s; peak memory {peak} B "
                f"({peak / 2**30:.3f} GiB); {smi}")

            # the first validation batch: the eval step against the plain route
            batch, out, weights = rec["first_eval"]
            kwargs = (afgsa_kwargs_from_config if model == "afgsa" else mamba_kwargs_from_config)(cfg)
            plain = type(g)(**dict(kwargs, use_kernels=False), device=device)
            plain.load_state_dict(weights)
            ref = make_eval_step(plain)(batch)[0]
            dev = deviation(out, ref)
            log(f"[{tag}] first validation batch {tuple(batch['noisy'].shape)}, eval step "
                f"(kernels) vs plain route: max_rel {dev['max_rel']:.6g} rms_rel "
                f"{dev['rms_rel']:.6g} (bound {FRAME_TOL})")
            check(f"[{tag}] first validation batch", dev, FRAME_TOL)
            # what a validation batch costs: the eval forward on the card
            # against the SSIM of its samples on the host
            eval_step = make_eval_step(g)
            eval_step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            output, _, gt = eval_step(batch)
            output, gt = output.float().cpu().numpy(), gt.float().cpu().numpy()
            forward_s = time.perf_counter() - t0
            out_255 = tensor2img(output, post_spec=True)
            gt_255 = tensor2img(gt.astype(np.float64))
            t0 = time.perf_counter()
            calculate_ssim(out_255, gt_255)
            ssim_s = time.perf_counter() - t0
            log(f"[{tag}] one validation batch of {len(out_255)}: eval forward and copy "
                f"{forward_s * 1e3:.2f} ms, the SSIM of its samples on the host "
                f"{ssim_s * 1e3:.2f} ms; {smi}")
            del plain, ref, batch, out, weights, output, gt

            # resume from model_epoch1: its state to the bit, at the schedule
            ckpt = run0 / "model_epoch1" / "state"
            resumed, rec2, _, launches2, secs2, _ = run_trainer(
                base + TRAINER_ARGS + ["run_num=1", "trainer.load_model=true",
                                       f"trainer.model_path={ckpt.resolve()}"], model)
            saved, restored = rec["saved"][0], rec2["restored"]
            for part in ("g", "g_opt", "d_opt"):
                if not same_bits(restored[part], saved[part]):
                    raise AssertionError(f"[{tag}] resume: {part} differs from the saved state")
            milestones = multistep_milestone_epochs(cfg.trainer.epochs, cfg.trainer.lr_milestone)
            steps = len(rec["train"]) // 2
            lr = multistep_schedule(cfg.trainer.lr_g, milestones, cfg.trainer.lr_gamma,
                                    steps)(restored["count"])
            if restored["count"] != steps or restored["lr"] != lr:
                raise AssertionError(f"[{tag}] resume: count {restored['count']} lr "
                                     f"{restored['lr']} (want {steps}, {lr})")
            check_trainer_run(f"{tag}-resume", model, resumed, rec2, launches2, [2], layers)
            log(f"[{tag}] resumed from model_epoch1 at epoch 2 in {secs2:.2f} s: G parameters and "
                f"both Adam states equal to the saved ones to the bit; first step at lr {lr:g} "
                f"(schedule count {restored['count']})")
            del resumed, rec2

            # serve model_epoch2 through inference.load_generator
            serve_cfg = copy.deepcopy(cfg)
            serve_cfg.trainer.model_path = str(run0 / "model_epoch2" / "state")
            loaded = load_generator(serve_cfg, device=device)
            outs = [denoise_frame_fused(
                make_fused_frame_apply(m.eval(), (SERVE["size"], SERVE["size"]), tile=SERVE["tile"],
                                       margin=SERVE["margin"], batch_tiles=SERVE["batch"],
                                       device=device), frame, device=device)
                for m in (loaded, g)]
            if outs[0].shape != (SERVE["size"], SERVE["size"], 3) or not np.isfinite(outs[0]).all():
                raise AssertionError(f"[{tag}] bad served frame")
            if not np.array_equal(outs[0], outs[1]):
                dev = deviation(torch.from_numpy(outs[0]), torch.from_numpy(outs[1]))
                raise AssertionError(f"[{tag}] the served frame differs from the trainer's G: {dev}")
            log(f"[{tag}] model_epoch2/state served one {SERVE['size']}² frame through "
                "inference.load_generator, equal to the trainer's G to the bit")
            del trainer, rec, g, loaded, outs
            torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False  # as main set them
    torch.backends.cudnn.allow_tf32 = False


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
    training, afgsa_rate = phase_training(device)
    phase_literal(device)
    results["K7"], mamba = phase_mamba(device, frames)
    results.update(phase_mamba_kernels(device))
    mamba_training, mamba_rate = phase_mamba_training(device)
    results.update(phase_literal_kernels(device))
    literal = phase_literal_path(device)
    phase_fold_qkv(device)
    phase_trainer(device, frames[0], {"afgsa": afgsa_rate, "mamba": mamba_rate}, smi)
    # each kernel's count from the path it was ported for
    path = {"K1": serving, "K2": serving, "K3": serving, "K4": training, "K5": training,
            "K6": training, "K7": mamba, "K7e": mamba_training, "K8": mamba_training,
            "K9": literal, "K10": literal, "K11": literal}
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

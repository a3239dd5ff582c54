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
   body and SDPA over pre-gathered windows) and fp32 (the general body,
   its bound by operations at the f32 rate, beside SDPA over pre-gathered
   fp32 windows), and at halo 8 (the tensor-core body's two passes, the general body's
   key-chunked path), the pointwise GEMM K2
   (n_aux's two operands; one operand, k = n·Wk; two operands with the
   backward's f32 residual, also equal to the bit across two calls), the
   3×3 conv K3, the whole TransformerBlock forward in the three padding
   modes; the attention backward K4 (bf16: the tensor-core body, equal to
   the bit across two calls, its device time per launch, beside the general
   body and SDPA's autograd backward; fp32: the general body, beside
   SDPA's autograd backward on the fp32 windows), the conv
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
   AFGSANet in train mode and the prod critic as training builds it
   (DiscriminatorVGG(128, 64) in `models.discriminators.GP_CRITIC_DTYPE`,
   float32), seeded random weights, batch 8 of 128² numpy patches: 2
   warm-up and 5 timed steps, TF32 on as the trainer sets it at bf16.
   Checks finite losses, that every block of every step ran its backward
   through K4, K5 and K6 (launch counters), that every K1 and K4
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
   kernel route against the plain route (FRAME_TOL, MAMBA_STEP_GRAD_TOL);
   then, in a fresh process with CUBLAS_WORKSPACE_CONFIG=:4096:8, two L1
   forward + backward passes of each route equal to the bit, no aten op
   whose two runs on the same inputs differ, and the same under
   `torch.use_deterministic_algorithms(True)` with no op warned of.
10. `fold_qkv`: one L1 forward + backward of the prod-width AFGSANet on
   the literal route (8 × 128²) with the q/k/v projections folded into
   the attention op against the unfolded model: both run K1 and K4, which
   the counters check on the folded route, so only the projections'
   rounding differs (FRAME_TOL, STEP_GRAD_TOL); every K1 and K4 launch of
   the folded run took its tensor-core body.
11. Trainer: the training CLI, `train.main`, for `-cn prod` and `-cn prod
   model=mamba` in a temporary working directory (synthetic 512² scenes,
   `trainer.epochs=2`, num_patches 100, batch 8 × 128², bf16, the
   kernels on; the patch
   store built on the first run): `data.loader=auto` resolved to
   `device`, `train_loss.txt` and `evaluation.txt` one finite line per
   epoch, the PNG panels decode, `model_epoch{1,2}/state/` written; every
   train step launched K1–K6 (AFGSA) or K7-emit and K8 (Mamba) for every
   block and every validation forward K1–K3 or K7 (counter deltas around
   each call), all on their prod bodies; the first validation batch
   through the trainer's eval step against the plain route (FRAME_TOL); a
   resume from `model_epoch1/state` that starts at epoch 2 with G, D and
   both Adam states equal to the saved ones to the bit and
   its first step at the schedule's learning rate; `model_epoch2/state`
   served through `inference.load_generator`, one 512² frame equal to the
   trainer's G to the bit. Prints each epoch's patches/s and io share
   from the trainer's summary beside phases 5's and 8's step-alone rate,
   the store build's seconds and peak memory.
12. The trainer's GAN options at prod width (batch 8 × 128², bf16, the
   kernels on; 1 warm-up + 3 steps each): (a) the AFGSANet with FiLM, which
   takes the literal route, WGAN-GP against the prod critic (float32, TF32
   on, as phase 5): every step
   launches K1 and K4 five times (the tensor-core bodies) and no block
   kernel; one step through the kernel and plain routes (STEP_LOSS_TOL,
   STEP_GRAD_TOL) beside the plain route repeated; one 512² FiLM frame
   served (K1 40 times, nothing else) against the plain path (FRAME_TOL).
   (b) The multiscale spectral-norm critic with RaHinge, MS-SSIM and LPIPS
   (random weights) for the prod AFGSANet (block route) and the prod
   MambaDenoiserNet: every step launches what a phase 5 or phase 8 step
   launched; after the first step every SNConv's `u` equals one power
   iteration from its old `u` with the pre-update weights, recomputed in
   f32 (SN_U_TOL); the route comparison as in (a) (Mamba:
   MAMBA_STEP_GRAD_TOL). Prints step seconds and peak memory. (c)
   `train.main -cn prod` with `model.use_film`, the multiscale critic,
   MS-SSIM and LPIPS(`random`), 40 patches an image, 2 epochs: every train
   step launches K1 and K4 and every validation forward K1, five times
   each; then a resume from `model_epoch1/state` that restores G, D (every
   `u`) and both Adam states to the bit.
13. Serving artifacts: for each prod generator (seeded weights, the
   phase 4 / 7 models), `save_params` → `tools.export_model.main`
   (`-cn prod`, platforms cuda: window 128, batch 8) → `serving.
   load_exported`; the graph's `pht::` ops (5 of `transformer_block_fwd`
   or `fused_mamba_chain`); phase 4's three frames through the artifact
   and through the live model: exactly K2 160, K1 40, K3 80 (AFGSA) or K7
   40 (Mamba) a frame from each, on the prod bodies, frame 0 within
   FRAME_TOL of the live model (and whether equal to the bit), steady
   s/frame of both, export and load seconds, artifact bytes, peak memory.
   For AFGSA also: a fresh interpreter serves one frame from the artifact
   with no model class imported; the portable `cpu,cuda` artifact (the
   plain route, traced on the CPU) runs on the card with no launch within
   FRAME_TOL of the kernel artifact; `inference.main` with
   `inference.from_export` scores a synthetic 512² scene, launching one
   frame's kernels.
14. Sharded serving (`parallel/`) on the one card, phase 4's frame 0 at
   prod width (seeded weights): the row-sharded AFGSANet over 2 gloo
   ranks sharing the card (`parallel.distributed.spawn_world`) at margin
   32, its gathered frame equal to the bit to the two strips this process
   computes with their halo rows put in by hand, each rank's launches K1 5,
   K2 20, K3 10 a frame on their prod bodies, and at margin 72 (the prod
   reach is 65 px) within FRAME_TOL of one rank; one rank on nccl (its
   process group and a CUDA-tensor all_gather), equal to the bit to one
   rank with no process group; the sequence-sharded MambaDenoiserNet over
   the 2 ranks (the literal chain: no K7) within FRAME_TOL of the literal
   model on the whole frame; `python -m torch.distributed.run
   --nproc-per-node 2 -m pixel_heal_thyself_tpu_torch.inference -cn prod
   parallel.multihost=true inference.spatial=true` on a synthetic 512²
   scene, one finite `evaluation.txt`. Prints s/frame per path, peak
   memory per rank and the phase's seconds. Two ranks on one card measure
   correctness and overhead, not a multi-GPU speed-up.
15. Multi-GPU training (`parallel/`, `make_train_step(..., mesh=)`) on the
   one card, prod widths, global batch 8 × 128²: 2 gloo ranks sharing the
   card train the AFGSA (K1–K6) and Mamba (K7e/K8) steps data-parallel (4
   rows a rank) and the AFGSA step with Adam sharded over the 2 ranks (D=1
   × M=2): 4 timed bf16 steps each against the prod critic (float32, TF32
   on, as phase 5) (s/step, host seconds in the gradient
   and parameter collectives, peak memory and launches per rank, every
   launch on its prod body, the global losses equal on every rank), then
   one step with a float32 critic under deterministic cuDNN against one
   process (STEP_LOSS_TOL and STEP_GRAD_TOL, Mamba MAMBA_STEP_GRAD_TOL; D=1
   × M=2 equal to the bit); one rank on nccl equal to the bit to no
   process group, and over a data group of itself; the training CLI under
   `torch.distributed.run --nproc-per-node 2` (4 synthetic 512² scenes, 16
   patches an image, 1 epoch) and its resume, only rank 0 writing, each
   rank's epoch launching K1–K6 (the trainer's own counts).
16. The tools (`pixel_heal_thyself_tpu_torch.tools`), each through its
   `run`, prod widths, bf16, seeded weights (TOOLS): `bench_inference` at
   720p with the AFGSANet at tile 64 / 96 / 112 (the 128² window; K1 150 /
   70 / 55, K2 and K3 with them, a frame on the prod bodies; the seam PSNR
   against tile 64) and its host-synced, pipelined and fused dispatch at
   tile 64 equal to the bit, and the MambaDenoiserNet at tile 64 (K7 150 a
   frame); `bench_serving` (the AFGSA artifact against the live model at
   720p: every `pht::` op of the live forward in the graph, the frames
   equal to the bit, first-call and steady s/frame, export and load
   seconds, bytes); `bench_pipeline`'s seven input modes of the AFGSA GAN
   step (5 steps each: patches/s, finite losses, every step's K1–K6 on the
   prod bodies); `flops_train_step` for both generators (TFLOP/sample,
   counted on the plain route, and the share of the dense bf16 peak that
   phases 5's and 8's step rates imply); `make_synthetic_datasets` at 64²,
   `data.inspect` and `resize_exrs` on its EXRs. Prints the phase's seconds.
17. The quality campaign (`tools.quality_campaign.run`, the port of the JAX
   package's `tools/r5_quality_campaign.sh`) in a temporary directory, cut
   to 2 scenes of 256² a dataset directory, 100 patches an image and 1
   epoch (CAMPAIGN): legs 1,
   2a and 4 (`-cn prod`, AFGSA), then legs 1, 2b and 4 (`-cn stag
   model=mamba`); every train step launched K1–K6 (AFGSA) or K7-emit and
   K8 (Mamba) for every block and every validation forward K1–K3 or K7, on
   their prod bodies (as phase 11); leg 4 wrote one evaluation file a
   scene (2 training, 2 held-out) with finite metrics and launched K1–K3
   or K7; the summary line parses and holds both legs. Prints each leg's
   epoch rate, validation seconds, peak memory, launches a step and a
   validation batch, and the phase's seconds. The full campaign (12
   epochs, 10 scenes of 512²) is its own command, not a phase.
18. The WGAN-GP critic's numerics (`tools.critic_numerics`) at the prod
   shapes under the trainer's bf16 arithmetic: the critic the trainer
   builds (`create_discriminator` of the `-cn prod` AFGSATrainer: float32,
   TF32 products, its seeded init) on 8 tiles of the campaign's first
   scene, `fake` from the seeded prod AFGSANet through its kernels. The
   trainer's critic and a bf16 copy each against the true-float32 critic:
   the trainer's GP norms' mean relative deviation within 3× its own
   reading (CRITIC_TRAINER_GP, which the bf16 copy fails), the bf16 copy's
   GP norms and D gradient within 2× the JAX package's own bf16 deviation
   for the same critic and inputs (CRITIC_JAX, measured on the CPU).
   Prints what it read and the phase's seconds.
19. The replay of the TPU kernel #5's forward with one-pass bf16 products
   (`tools.tpu_rounding`) on phase 17's 2b checkpoint, over 2 scenes of
   256²: the checkpoint served and validated through K7 and then with the
   replay in K7's place, in one process under the same switches (cuDNN
   deterministic). The K7 pass launched K7 and called no replay, the
   replay pass the reverse; every PSNR finite; the replay's frames lie
   above 0 and within REPLAY_RMS_REL (rms relative) of K7's. Prints the
   deltas and the phase's seconds.
20. `trainer.deterministic` (the trainer's determinism settings, as the
   reference's `set_determinism` makes them): in phase 11's directory (its
   patch store and cut), `train.main -cn prod` twice and `-cn prod
   model=mamba` twice, 1 epoch each, each in a fresh process (three at
   a time): each pair's last checkpoint (G, D and both Adam states, by
   `training.checkpoints.digest`) equal to the bit and its
   `train_loss.txt` and `evaluation.txt` byte-equal. Prints the ops torch
   warned of under `warn_only`, one control pair of AFGSA runs with the
   settings left at torch's defaults (equal or not; not a condition),
   each generator's prod GAN step (phases 5 and 8) as the median of 20
   steps under the trainer's settings and of 20 under torch's defaults,
   and the phase's seconds.

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
import io
import json
import logging
import math
import os
import re
import struct
import subprocess
import sys
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


def check_bodies(tag: str, launches: dict, quiet: bool = False) -> None:
    """The launches of each kernel of PROD_BODIES by body, and of each
    prologue of PROLOGUE_BODIES: every one must have taken its prod body,
    none the general one. `quiet` logs nothing when they all did."""
    fns = counters()
    for attr, want in (("body_launches", PROD_BODIES),
                       ("prologue_body_launches", PROLOGUE_BODIES)):
        for name, body in want.items():
            bodies = dict(getattr(fns[name], attr))
            if not quiet:
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
    # fp32: bound by the operations at the f32 rate outside the tensor cores;
    # library SDPA on fp32 windows gathered the same way
    qwf = sdpa_windows(qf, BS, HALO, HEADS)
    kwf = sdpa_windows(kf, BS, HALO, HEADS, keys=True, rel=rels)
    vwf = sdpa_windows(vf, BS, HALO, HEADS, keys=True)
    f32 = torch.float32
    expect_body("K1", "general", lambda: compare(
        "K1 attention fp32 (general body; library: SDPA on pre-gathered fp32 windows)",
        lambda: block_halo_attention_cuda(qf, kf, vf, *rels, **att),
        lambda: block_halo_attention_torch(qf, kf, vf, *rels, **att),
        TOL["fp32"], work=(nbytes(qf, kf, vf, *rels, qf), attn_flops, f32),
        library=lambda: F.scaled_dot_product_attention(qwf, kwf, vwf),
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
    qg, kg, vg = (t.detach().requires_grad_() for t in (qwf, kwf, vwf))
    og = F.scaled_dot_product_attention(qg, kg, vg)
    dow = sdpa_windows(dof, BS, HALO, HEADS)
    expect_body("K4", "general", lambda: compare(
        "K4 attention backward fp32 (general body; library: SDPA's backward on pre-gathered "
        "fp32 windows)",
        lambda: block_halo_attention_bwd_cuda(qf, kf, vf, *ab, dof, **att),
        lambda: block_halo_attention_bwd_torch(qf, kf, vf, *ab, dof, **att),
        TOL["fp32"], iters=5, plain_iters=2,
        work=(nbytes(qf, kf, vf, dof, *ab) + nbytes(qf, kf, vf, *ab), attn_flops * 5 // 2, f32),
        library=lambda: torch.autograd.grad(og, (qg, kg, vg), dow, retain_graph=True),
    ))
    del qg, kg, vg, og, dow, qwf, kwf, vwf
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


def serve_frames(device, frames, apply_fn, tag: str) -> tuple:
    """Denoise `frames` with `apply_fn` (a model, or a loaded serving
    artifact) through the device tiler, the path `inference.run_inference`
    takes, from counts of 0: checks the outputs and that every launch took
    its prod body. Returns (outputs, launch counts, steady s/frame, peak
    memory)."""
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame_fused, make_fused_frame_apply

    size, tile, margin, batch = (SERVE[k] for k in ("size", "tile", "margin", "batch"))
    fused = make_fused_frame_apply(apply_fn, (size, size), tile=tile, margin=margin,
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
    for out in outs:
        if out.shape != (size, size, 3) or not np.isfinite(out).all():
            raise AssertionError(f"bad frame output {out.shape}, finite={np.isfinite(out).all()}")
    steady = float(np.mean(secs[1:] or secs))
    log(f"[{tag}] seconds per frame {[round(s, 4) for s in secs]} (first includes warm-up); "
        f"steady {steady:.4f} s/frame = {1 / steady:.3f} frames/s; "
        f"peak memory {peak} B ({peak / 2**30:.3f} GiB)")
    return outs, launches, steady, peak


def serve(device, frames, net, kwargs, layers: int, names: tuple, tag: str) -> dict:
    """Denoise `frames` with `net(**kwargs)` (seeded random weights) through
    the device tiler (`serve_frames`): checks that each kernel in `names`
    ran for every one of `layers` layers of every batch (launch counters),
    and frame 0 against the model's plain path on the card. Returns the
    launch counts."""
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame_fused, make_fused_frame_apply
    from pixel_heal_thyself_tpu_torch.models.afgsa import count_params

    size, tile, margin, batch = (SERVE[k] for k in ("size", "tile", "margin", "batch"))
    model = net(**kwargs, device=device, generator=torch.Generator().manual_seed(0)).eval()
    log(f"[{tag}] {net.__name__} prod width: {count_params(model)} params, "
        f"{len(frames)} synthetic {size}² frames, tile {tile} + margin {margin}, batch {batch}")
    outs, launches, _, _ = serve_frames(device, frames, model, tag)

    n_batches = math.ceil((size // tile) ** 2 / batch)
    need = layers * n_batches * len(frames)
    for name in names:
        if launches[name] < need:
            raise AssertionError(f"{name} launched {launches[name]} times < {need} "
                                 f"({layers} layers × {n_batches} batches × {len(frames)} frames)")
    log(f"[{tag}] launches {launches} (need ≥ {need} each of {', '.join(names)})")

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


def _train_state(device, d_dtype, g_kwargs, patch, batch, seed, net=None, multiscale=False,
                 data_group=None):
    """Seeded G (`net`, AFGSANet by default) and D (in `d_dtype`: the
    multiscale spectral-norm critic with `multiscale`, else
    DiscriminatorVGG over `data_group`), and one numpy batch
    (bench.py:107-118) on the card."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.discriminators import (
        DiscriminatorVGG,
        MultiScaleDiscriminator,
    )

    g = (net or AFGSANet)(**g_kwargs, device=device,
                          generator=torch.Generator().manual_seed(seed))
    d_gen = torch.Generator().manual_seed(seed + 1)
    if multiscale:
        d = MultiScaleDiscriminator(in_nc=3, patch_size=patch, dtype=d_dtype, device=device,
                                    generator=d_gen)
    else:
        d = DiscriminatorVGG(in_nc=3, base_nf=64, input_size=patch, dtype=d_dtype,
                             device=device, generator=d_gen, data_group=data_group)
    rng = np.random.default_rng(seed)
    arrays = {
        "noisy": np.abs(rng.standard_normal((batch, patch, patch, 3))),
        "gt": np.abs(rng.standard_normal((batch, patch, patch, 3))),
        "aux": rng.standard_normal((batch, patch, patch, 7)),
    }
    data = {key: torch.from_numpy(val.astype(np.float32)).to(device) for key, val in arrays.items()}
    return g.train(), d.train(), data


@contextlib.contextmanager
def trainer_tf32():
    """TF32 on while the block runs, as the trainer sets it for a bf16 run
    (its float32 critic's products): a timed prod step runs what training
    runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


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


def make_step(g, d, lpips=None, mesh=None):
    """The prod train step of G against D: WGAN-GP + L1 (over `mesh`,
    phase 15); or, with `lpips` (LPIPS params on the card), the multiscale
    RaHinge step + L1 + MS-SSIM + LPIPS (phase 12)."""
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    spec = make_optimizer(1e-4, [2], 0.5, 100)
    if lpips is None:
        return make_train_step(g, d, LossesConfig(), False, spec, spec, mesh=mesh)
    return make_train_step(g, d, LossesConfig(use_ssim_loss=True, use_lpips_loss=True), True,
                           spec, spec, lpips_params=lpips)


def _step_grads(device, g_kwargs, patch, batch, alpha, nudge=False, net=None, lpips=None):
    """One train step from the seeded state with a float32 critic (the
    multiscale one with SSIM and LPIPS when `lpips` is given): (metrics, G
    gradients). `nudge` moves every noisy input value to the next bf16
    value up: a change of one bf16 ulp, whose effect on the gradients is
    the floor that bf16 rounding flips alone set."""
    g, d, data = _train_state(device, torch.float32, g_kwargs, patch, batch, seed=3, net=net,
                              multiscale=lpips is not None)
    if nudge:  # the inputs are ≥ 0, so one more in the bits is one ulp up
        bits = data["noisy"].to(torch.bfloat16).view(torch.int16) + 1
        data["noisy"] = bits.view(torch.bfloat16).float()
    step = make_step(g, d, lpips)
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

    patch, batch, warmup, timed = (TRAIN[k] for k in ("patch", "batch", "warmup", "timed"))
    from pixel_heal_thyself_tpu_torch.models.discriminators import GP_CRITIC_DTYPE

    g, d, data = _train_state(device, GP_CRITIC_DTYPE, kwargs, patch, batch, seed=0, net=net)
    assert route(g), f"the prod {net.__name__} step must take its kernel route"
    step = make_step(g, d)
    gen = torch.Generator(device=device).manual_seed(7)
    log(f"[{tag}] prod step: G {net.__name__} {count_params(g)} params (bf16, {layers} blocks, "
        f"kernel route), D {count_params(d)} params ({d.dtype}, TF32 on); batch {batch} × "
        f"{patch}², WGAN-GP + L1")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    secs, history = [], []
    with trainer_tf32():
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
    del models, data, gk, gp
    torch.cuda.empty_cache()  # the probe's process needs the route's 41 GB
    # the route's backward once varied from run to run (F.pad's reflect
    # backward summed with atomics, PERF.md §6): now two passes of each
    # route give the same bits, and no aten op differs between two runs on
    # the same inputs
    res = literal_determinism_probe("literal-mamba")
    for route in ("kernel route", "plain route"):
        r = res[route]
        if not (r["equal"] and r["deterministic_mode_equal"]) or r["varying_ops"] or \
                r["nondeterministic_ops"]:
            raise AssertionError(f"[literal-mamba] {route} is not deterministic: {r}")
    return launches


def _grads_twice(model, data) -> tuple:
    from pixel_heal_thyself_tpu_torch import bench_mamba

    a = {k: v.clone() for k, v in bench_mamba.g_fwd_bwd(model, data).items()}
    b = bench_mamba.g_fwd_bwd(model, data)
    worst = max(a, key=lambda k: (a[k].float() - b[k].float()).abs().max().item())
    return (all(torch.equal(a[k], b[k]) for k in a),
            (a[worst].float() - b[worst].float()).abs().max().item(), worst)


def _varying_ops(model, data) -> dict:
    """One L1 forward + backward with every aten op that writes no input
    run twice on the same inputs: {op: (calls whose two results differ,
    largest difference)}. The hand kernels run outside the dispatcher."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from pixel_heal_thyself_tpu_torch import bench_mamba

    varied = {}

    class Twice(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func._schema.is_mutable or "empty" in func.__name__:
                return out
            again = func(*args, **kwargs)
            pairs = [(x, y) for x, y in zip(torch.utils._pytree.tree_leaves(out),
                                            torch.utils._pytree.tree_leaves(again))
                     if isinstance(x, torch.Tensor) and x.is_floating_point()]
            diff = max(((x.float() - y.float()).abs().max().item() for x, y in pairs
                        if not torch.equal(x, y)), default=None)
            if diff is not None:
                n, worst = varied.get(str(func), (0, 0.0))
                varied[str(func)] = (n + 1, max(worst, diff))
            return out

    with Twice():
        bench_mamba.g_fwd_bwd(model, data)
    return varied


def literal_determinism() -> None:
    """Phase 9's literal Mamba route (`bench_mamba`'s prod model with the
    fused conv, batch 8 × 128², deterministic cuDNN), kernel and plain:
    two L1 forward + backward passes compared bit for bit; the aten ops
    whose two runs on the same inputs differ (`_varying_ops`); then two
    passes under `torch.use_deterministic_algorithms(True, warn_only=True)`,
    which also names each op that has no deterministic CUDA
    implementation. Prints one `DETERMINISM {json}` line."""
    import warnings

    from pixel_heal_thyself_tpu_torch import _build, bench_mamba

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    device = torch.device("cuda")
    data = bench_mamba.make_inputs(MAMBA["batch"], TRAIN["patch"], device)
    out = {"CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    for kernels in (True, False):
        model = bench_mamba.make_model(True, False, kernels, device)
        with deterministic_cudnn():
            equal, max_abs, worst = _grads_twice(model, data)
            varied = _varying_ops(model, data)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    det_equal, det_max_abs, det_worst = _grads_twice(model, data)
                    det_varied = _varying_ops(model, data)
            finally:
                torch.use_deterministic_algorithms(False)
        ops = sorted({m.group(1) for w in caught for m in [re.search(
            r"(\S+) does not have a deterministic implementation", str(w.message))] if m})
        out["kernel route" if kernels else "plain route"] = {
            "equal": equal, "max_abs": max_abs, "worst": worst, "varying_ops": varied,
            "nondeterministic_ops": ops, "deterministic_mode_equal": det_equal,
            "deterministic_mode_max_abs": det_max_abs, "deterministic_mode_varying_ops": det_varied}
        del model
        torch.cuda.empty_cache()
    print("DETERMINISM " + json.dumps(out), flush=True)


def literal_determinism_probe(tag: str, workspace: str | None = ":4096:8") -> dict:
    """`literal_determinism` in a fresh interpreter, with cuBLAS's
    deterministic workspace (CUBLAS_WORKSPACE_CONFIG=`workspace`, set for
    that process only; None leaves it unset); logs and returns its
    result."""
    repo = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    env["PYTHONPATH"] = str(repo)
    if workspace:
        env["CUBLAS_WORKSPACE_CONFIG"] = workspace
    proc = subprocess.run([sys.executable, "-c",
                           "import chip_smoke; chip_smoke.literal_determinism()"],
                          capture_output=True, text=True, cwd=repo, env=env, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] the determinism probe exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("DETERMINISM "))
    res = json.loads(line[len("DETERMINISM "):])
    for route, r in res.items():
        if not isinstance(r, dict):
            continue
        log(f"[{tag}] CUBLAS_WORKSPACE_CONFIG={res['CUBLAS_WORKSPACE_CONFIG']}, {route}: two L1 "
            f"backward passes equal to the bit {r['equal']} (max_abs {r['max_abs']:.6g} at "
            f"{r['worst']}); aten ops whose two runs differ {r['varying_ops']}; under "
            f"torch.use_deterministic_algorithms: ops without a deterministic CUDA "
            f"implementation {r['nondeterministic_ops']}, two passes equal "
            f"{r['deterministic_mode_equal']} (max_abs {r['deterministic_mode_max_abs']:.6g}), "
            f"ops whose two runs differ {r['deterministic_mode_varying_ops']}")
    return res


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
# scenes are 512²; the rest is prod: 4 scene pairs, batch 8 × 128², bf16,
# the kernels on, val batch 8. Cut: 2 epochs (prod 12), num_patches 100
# (prod 400, at which this phase's four runs took 520 s of the script's
# 1186 s on an NVIDIA H100 80GB HBM3 at 700.00 W).
TRAINER_CONFIG = "prod"
TRAINER_ARGS = ["data.images.synthesize=true", "data.images.synthetic_size=512",
                "data.patches.num_patches=100", "trainer.epochs=2", "--device", "cuda"]
# per model: the kernels every train step and every validation forward run
TRAINER_KERNELS = {"afgsa": (("K1", "K2", "K3", "K4", "K5", "K6"), ("K1", "K2", "K3")),
                   "mamba": (("K7e", "K8"), ("K7",))}
# what a resume must restore to the bit (D with any spectral-norm `u`)
RESUME_PARTS = ("g", "d", "g_opt", "d_opt")
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
    return {part: _clone(getattr(state, part).state_dict()) for part in RESUME_PARTS}


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


# what `training.trainer.deterministic_algorithms` sets, as
# `critic_numerics.set_switches` names it
DETERMINISM_SWITCHES = ("cudnn_deterministic", "deterministic_algorithms")


def determinism_kept():
    """A block after which the process's determinism switches stand as
    before it: a trainer built in the block sets them for the process
    (`trainer.deterministic`), and the phases after it measure under
    their own. TF32 is left as the trainer sets it."""
    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import arithmetic, switches_now

    now = switches_now()
    return arithmetic({k: now[k] for k in DETERMINISM_SWITCHES})


def run_trainer(argv: list, kernels: tuple) -> tuple:
    """`train.main(argv)` from counts of 0 and a fresh run-dir pin, probing
    `kernels` = (the train step's, the validation forward's): (trainer,
    probe record, log lines, launch counts, seconds, peak memory). The
    determinism switches are restored after it (`determinism_kept`)."""
    from pixel_heal_thyself_tpu_torch import train
    from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache

    reset_run_dirs_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with trainer_probe(*kernels) as rec, trainer_log() as lines, determinism_kept():
        t0 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return trainer, rec, lines, read_counts(), secs, torch.cuda.max_memory_allocated()


def check_trainer_run(tag: str, kernels: tuple, trainer, rec: dict, launches: dict,
                      epochs: list, layers: int) -> Path:
    """A run's artifacts and launches (`kernels` as `run_trainer`'s);
    returns its run directory."""
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
        f"{', '.join(kernels[0])}; {len(rec['eval'])} validation forwards each "
        f"≥ {layers} of {', '.join(kernels[1])}; launches {launches}")
    return run


def phase_trainer(device, frame: dict, step_rates: dict, smi: str, workdir: str) -> None:
    """Phase 11: the training CLI, `train.main`, for `-cn prod` and `-cn prod
    model=mamba` in `workdir` (phase 20 trains on its patch store): two epochs each, every
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

    with contextlib.chdir(workdir):
        for model in ("afgsa", "mamba"):
            tag = f"trainer-{model}"
            base = ["-cn", TRAINER_CONFIG] + (["model=mamba"] if model == "mamba" else [])
            trainer, rec, lines, launches, secs, peak = run_trainer(
                base + TRAINER_ARGS + ["run_num=0"], TRAINER_KERNELS[model])
            cfg = trainer.cfg
            g = trainer.state.g
            layers = cfg.model.self_attention.num_layers if model == "afgsa" else cfg.model.num_layers
            if not trainer.use_kernels:
                raise AssertionError(f"[{tag}] the trainer did not take the kernels")
            run0 = check_trainer_run(tag, TRAINER_KERNELS[model], trainer, rec, launches, [1, 2],
                                     layers)
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
                                       f"trainer.model_path={ckpt.resolve()}"],
                TRAINER_KERNELS[model])
            saved, restored = rec["saved"][0], rec2["restored"]
            for part in RESUME_PARTS:
                if not same_bits(restored[part], saved[part]):
                    raise AssertionError(f"[{tag}] resume: {part} differs from the saved state")
            milestones = multistep_milestone_epochs(cfg.trainer.epochs, cfg.trainer.lr_milestone)
            steps = len(rec["train"]) // 2
            lr = multistep_schedule(cfg.trainer.lr_g, milestones, cfg.trainer.lr_gamma,
                                    steps)(restored["count"])
            if restored["count"] != steps or restored["lr"] != lr:
                raise AssertionError(f"[{tag}] resume: count {restored['count']} lr "
                                     f"{restored['lr']} (want {steps}, {lr})")
            check_trainer_run(f"{tag}-resume", TRAINER_KERNELS[model], resumed, rec2, launches2,
                              [2], layers)
            log(f"[{tag}] resumed from model_epoch1 at epoch 2 in {secs2:.2f} s: G and D and both "
                f"Adam states equal to the saved ones to the bit; first step at lr {lr:g} "
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


# phase 12: the trainer's GAN options at prod width (batch 8 × 128², bf16,
# the kernels on): FiLM, which takes the literal route (K1/K4 through
# `BlockHaloAttentionFn`), and the multiscale spectral-norm critic with
# RaHinge, MS-SSIM and LPIPS on random weights (no pretrained LPIPS weights
# are in the repository), for both generators. Each step run: 1 warm-up + 3
GAN_STEPS = dict(warmup=1, timed=3)
# an SNConv's u after the first step against one power iteration from its
# old u with the pre-update weights, recomputed in f32: unit vectors, the
# same f32 products in the same order
SN_U_TOL = 1e-6
# the CLI run: `-cn prod` with the four options; cut: 40 patches an image
# (prod 400) so that a validation pass, SSIM on the host, stays short
GAN_TRAINER_ARGS = ["model.use_film=true", "model.discriminator.use_multiscale_discriminator=true",
                    "model.losses.use_ssim_loss=true", "model.losses.use_lpips_loss=true",
                    "model.losses.lpips_weights_path=random", "data.images.synthesize=true",
                    "data.images.synthetic_size=512", "data.patches.num_patches=40",
                    "trainer.epochs=2", "--device", "cuda"]


def per_step(launches: dict, steps: int) -> dict:
    """A run's launch counts over `steps` equal steps → one step's."""
    if any(n % steps for n in launches.values()):
        raise AssertionError(f"launches {launches} are not {steps} equal steps")
    return {name: n // steps for name, n in launches.items()}


def check_u_written(tag: str, sn: dict, before: dict) -> None:
    """Every SNConv's u after one train step equals one power iteration
    from its u before the step with the weights before the D update: the D
    step's fake forward wrote it, once. Beside it, how far two iterations
    lie (what a second write would give)."""
    worst, second = 0.0, math.inf
    for name, m in sn.items():
        w, u = before[name]
        w = w.reshape(w.shape[0], -1)

        def iterate(u):
            v = F.normalize(w.t() @ u, dim=0, eps=1e-12)
            return F.normalize(w @ v, dim=0, eps=1e-12)

        u1 = iterate(u)
        worst = max(worst, (m.u - u1).abs().max().item())
        if u.numel() > 1:  # a 1-channel head's u is ±1 whatever the iterations
            second = min(second, (m.u - iterate(u1)).abs().max().item())
    log(f"[{tag}] after step 0, {len(sn)} SNConv u against one power iteration from the old u "
        f"and weights (f32): worst max_abs_err {worst:.3e} (bound {SN_U_TOL}); two iterations "
        f"would differ by ≥ {second:.3e}")
    if worst > SN_U_TOL:
        raise AssertionError(f"[{tag}] an SNConv's u is not one power iteration from its old u")


def gan_step(device, net, kwargs, lpips, route, expect: dict, grad_tol: tuple, tag: str) -> dict:
    """Phase 12's prod training steps of the generator `net(**kwargs)`
    (`route(g)`: it takes the route under test): WGAN-GP against
    DiscriminatorVGG, or, with `lpips` (LPIPS params on the card), the
    multiscale RaHinge step with MS-SSIM and LPIPS. Every step must launch
    exactly `expect` (0 for a kernel not named) on the prod bodies, and
    after the first step every SNConv's u must be one power iteration from
    its old u; then one step through the kernel and plain routes (f32
    critic) beside the plain route repeated: losses within STEP_LOSS_TOL,
    G gradients within `grad_tol`. Returns the launch counts."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import count_params
    from pixel_heal_thyself_tpu_torch.models.discriminators import SNConv

    patch, batch = TRAIN["patch"], TRAIN["batch"]
    warmup, steps = GAN_STEPS["warmup"], GAN_STEPS["warmup"] + GAN_STEPS["timed"]
    from pixel_heal_thyself_tpu_torch.models.discriminators import GP_CRITIC_DTYPE

    # the critic's dtype as training's: the multiscale critic keeps the run's
    g, d, data = _train_state(device, torch.bfloat16 if lpips is not None else GP_CRITIC_DTYPE,
                              kwargs, patch, batch, seed=0, net=net,
                              multiscale=lpips is not None)
    if not route(g):
        raise AssertionError(f"[{tag}] the prod {net.__name__} step left its route")
    step = make_step(g, d, lpips)
    gen = torch.Generator(device=device).manual_seed(7)
    sn = {name: m for name, m in d.named_modules() if isinstance(m, SNConv)}
    before = {name: (m.weight.detach().clone(), m.u.clone()) for name, m in sn.items()}
    log(f"[{tag}] prod step: G {net.__name__} {count_params(g)} params (bf16), D "
        f"{type(d).__name__} {count_params(d)} params ({len(sn)} SNConv); batch {batch} × "
        f"{patch}², " + ("RaHinge + L1 + MS-SSIM + LPIPS (random weights)" if sn
                         else "WGAN-GP + L1"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    secs, history, counts = [], [], []
    for i in range(steps):
        c0 = read_counts()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if sn else trainer_tf32():
            metrics = step(data, generator=gen)
            history.append({key: val.item() for key, val in metrics.items()})  # syncs
        secs.append(time.perf_counter() - t0)
        counts.append({k: n - c0[k] for k, n in read_counts().items()})
        if i == 0 and sn:
            check_u_written(tag, sn, before)
    launches = read_counts()
    check_bodies(tag, launches)
    peak = torch.cuda.max_memory_allocated()
    del g, d, data, step, before
    want = {name: expect.get(name, 0) for name in KERNEL_NAMES}
    for i, got in enumerate(counts):
        if got != want:
            raise AssertionError(f"[{tag}] step {i} launched {got}, expected {want}")
    for i, m in enumerate(history):
        if not all(math.isfinite(val) for val in m.values()):
            raise AssertionError(f"[{tag}] step {i}: non-finite losses {m}")
    steady = float(np.mean(secs[warmup:]))
    log(f"[{tag}] every step launched {want}")
    log(f"[{tag}] losses step 0 {history[0]}; step {steps - 1} {history[-1]}")
    log(f"[{tag}] seconds per step {[round(s_, 4) for s_ in secs]} (first {warmup} warm-up); "
        f"steady {steady:.4f} s/step = {batch / steady:.3f} patches/s; "
        f"peak memory {peak} B ({peak / 2**30:.3f} GiB)")

    alpha = torch.rand((batch, 1, 1, 1), generator=gen, device=device)
    plain = dict(kwargs, use_kernels=False)
    with deterministic_cudnn():
        mk, gk = _step_grads(device, kwargs, patch, batch, alpha, net=net, lpips=lpips)
        mp, gp = _step_grads(device, plain, patch, batch, alpha, net=net, lpips=lpips)
        mr, gr = _step_grads(device, plain, patch, batch, alpha, net=net, lpips=lpips)
    for key in ("d_loss", "g_loss"):
        if abs(mk[key] - mp[key]) > STEP_LOSS_TOL * max(1.0, abs(mp[key])):
            raise AssertionError(f"[{tag}] {key}: kernel route {mk[key]} vs plain route {mp[key]}")
    table, floor = grad_table(gk, gp), grad_table(gr, gp)
    log(f"[{tag}] one step (float32 critic), kernel route vs plain route: d_loss "
        f"{mk['d_loss']:.6g} vs {mp['d_loss']:.6g}, g_loss {mk['g_loss']:.6g} vs "
        f"{mp['g_loss']:.6g}; G gradients worst rms_rel {max(r[1] for r in table):.4e}, worst "
        f"mass {table[0][2]:.4e} ({table[0][0]}) (bounds {grad_tol}); the plain route repeated: "
        f"worst rms_rel {max(r[1] for r in floor):.4e}, worst mass {floor[0][2]:.4e}")
    check_table(tag, table, grad_tol)
    return launches


def phase_gan_steps(device, frame, training: dict, mamba_training: dict, smi: str) -> None:
    """Phase 12 (a): the prod FiLM AFGSA step on the literal route (K1 and
    K4, 5 a step each; no block kernel) and one FiLM frame served; (b) the
    multiscale + MS-SSIM + LPIPS step of the prod AFGSA (block route) and
    the prod Mamba, each step launching what a phase 5 / phase 8 step
    launched (`training`, `mamba_training`: their launch counts)."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs
    from pixel_heal_thyself_tpu_torch.models.lpips import random_lpips_params
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs

    t_phase = time.perf_counter()
    patch, batch = TRAIN["patch"], TRAIN["batch"]
    steps = TRAIN["warmup"] + TRAIN["timed"]
    film = dict(afgsa_prod_kwargs(), use_film=True)
    layers = film["num_sa"]
    gan_step(device, AFGSANet, film, None,
             lambda g: not g.block_route(batch, patch, patch)
             and all(blk.attention.use_film for blk in g.blocks),
             {"K1": layers, "K4": layers}, STEP_GRAD_TOL, "film")
    launches = serve(device, [frame], AFGSANet, film, layers, ("K1",), "film-serve")
    n_batches = math.ceil((SERVE["size"] // SERVE["tile"]) ** 2 / SERVE["batch"])
    if launches != {name: layers * n_batches if name == "K1" else 0 for name in KERNEL_NAMES}:
        raise AssertionError(f"[film-serve] a FiLM frame launched {launches}, expected K1 "
                             f"{layers * n_batches} and nothing else")

    lpips = random_lpips_params(0, device=device)
    afgsa = afgsa_prod_kwargs()
    gan_step(device, AFGSANet, afgsa, lpips, lambda g: g.block_route(batch, patch, patch),
             per_step(training, steps), STEP_GRAD_TOL, "multiscale")
    mamba = mamba_prod_kwargs()
    gan_step(device, MambaDenoiserNet, mamba, lpips,
             lambda g: all(blk.mamba.fused_route(patch * patch) for blk in g.blocks),
             per_step(mamba_training, steps), MAMBA_STEP_GRAD_TOL, "multiscale-mamba")
    del lpips
    torch.cuda.empty_cache()
    log(f"[gan] phase 12 (a) and (b) {time.perf_counter() - t_phase:.2f} s; {smi}")


def phase_gan_trainer(smi: str) -> None:
    """Phase 12 (c): `train.main -cn prod` with FiLM, the multiscale
    critic, MS-SSIM and LPIPS(random) for 2 epochs (every train step K1 and
    K4 for every block, every validation forward K1), then a resume from
    model_epoch1 that restores G, D (with every u) and both Adams to the
    bit."""
    t_phase = time.perf_counter()
    kernels = (("K1", "K4"), ("K1",))
    tag = "trainer-gan"
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        base = ["-cn", TRAINER_CONFIG] + GAN_TRAINER_ARGS
        trainer, rec, lines, launches, secs, peak = run_trainer(base + ["run_num=0"], kernels)
        cfg, state = trainer.cfg, trainer.state
        if not (trainer.use_kernels and type(state.d).__name__ == "MultiScaleDiscriminator"
                and all(blk.attention.use_film for blk in state.g.blocks)):
            raise AssertionError(f"[{tag}] the trainer did not take FiLM, the multiscale critic "
                                 "and the kernels")
        layers = cfg.model.self_attention.num_layers
        run0 = check_trainer_run(tag, kernels, trainer, rec, launches, [1, 2], layers)
        if any(c != {"K1": layers, "K4": layers} for c in rec["train"]) or any(
                c != {"K1": layers} for c in rec["eval"]):
            raise AssertionError(f"[{tag}] a train step or validation forward launched other "
                                 f"than {layers} K1 (+ {layers} K4): {rec['train'][:2]}")
        for line in lines:
            if any(key in line for key in ("SSIM lossW", "multiscale", "FiLM", "LPIPS",
                                           "summary:", "in total")):
                log(f"[{tag}] trainer: {line}")
        log(f"[{tag}] run of 2 epochs {secs:.2f} s; peak memory {peak} B "
            f"({peak / 2**30:.3f} GiB); {smi}")

        ckpt = run0 / "model_epoch1" / "state"
        resumed, rec2, _, launches2, secs2, _ = run_trainer(
            base + ["run_num=1", "trainer.load_model=true",
                    f"trainer.model_path={ckpt.resolve()}"], kernels)
        saved, restored = rec["saved"][0], rec2["restored"]
        for part in RESUME_PARTS:
            if not same_bits(restored[part], saved[part]):
                raise AssertionError(f"[{tag}] resume: {part} differs from the saved state")
        n_u = sum(name.endswith(".u") for name in restored["d"])
        if n_u != sum(1 for name in state.d.state_dict() if name.endswith(".u")) or not n_u:
            raise AssertionError(f"[{tag}] resume: the critic's u buffers are missing")
        if restored["count"] != len(rec["train"]) // 2:
            raise AssertionError(f"[{tag}] resume at schedule count {restored['count']}")
        check_trainer_run(f"{tag}-resume", kernels, resumed, rec2, launches2, [2], layers)
        log(f"[{tag}] resumed from model_epoch1 at epoch 2 in {secs2:.2f} s: G, D (its {n_u} "
            f"SNConv u) and both Adam states equal to the saved ones to the bit")
        del trainer, resumed, rec, rec2, state
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False  # as main set them
    torch.backends.cudnn.allow_tf32 = False
    log(f"[gan] phase 12 (c) {time.perf_counter() - t_phase:.2f} s; {smi}")


# phase 13: each prod generator's serving artifact (`tools.export_model` at
# its defaults: window 128 = tile 64 + 2 × margin 32, batch 8, platforms
# cuda), its kernel ops in the graph and what a 512² frame launches
# through it: 8 batches × 5 blocks of K2 ×4 → K1 → K3 ×2, or of K7
EXPORT = {"afgsa": ({"transformer_block_fwd": 5}, {"K1": 40, "K2": 160, "K3": 80}),
          "mamba": ({"fused_mamba_chain": 5}, {"K7": 40})}
# a fresh process serving one frame from the AFGSA artifact: no model
# class may be imported
SERVE_ALONE = """
import json, sys, time
import numpy as np
import torch
from pixel_heal_thyself_tpu_torch.inference import denoise_frame_fused, make_fused_frame_apply
from pixel_heal_thyself_tpu_torch.serving import load_exported

art, frame, out, tile, margin, device = sys.argv[1:]
t0 = time.perf_counter()
apply_fn, manifest = load_exported(art, device)
load_s = time.perf_counter() - t0
data = dict(np.load(frame))
fused = make_fused_frame_apply(apply_fn, data["noisy"].shape[:2], tile=int(tile),
                               margin=int(margin), batch_tiles=manifest["batch_tiles"],
                               device=device)
t0 = time.perf_counter()
np.save(out, denoise_frame_fused(fused, data, device=device))
frame_s = time.perf_counter() - t0
models = sorted(m for m in sys.modules if m.startswith("pixel_heal_thyself_tpu_torch.models"))
print(json.dumps({"models": models, "load_s": load_s, "frame_s": frame_s}))
"""


def export_artifact(tag: str, base: list, out_dir: str, *extra) -> tuple:
    """`tools.export_model.main` from a fresh run-dir pin: (artifact dir,
    seconds, bytes)."""
    from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache
    from pixel_heal_thyself_tpu_torch.tools import export_model

    reset_run_dirs_cache()
    t0 = time.perf_counter()
    art = export_model.main(base + [f"export.out_dir={out_dir}", *extra])
    secs = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(art).iterdir())
    log(f"[{tag}] exported {art.name} {list(extra)} in {secs:.2f} s (config, model build, "
        f"trace, save): {size} B")
    return art, secs, size


def serve_alone(tag: str, art, frame: dict, want: np.ndarray, tmp: str, device) -> None:
    """A fresh interpreter loads `art` and denoises `frame`: no model class
    imported, the artifact's frame 0 within FRAME_TOL."""
    np.savez(Path(tmp, "frame.npz"), noisy=frame["noisy"], aux=frame["aux"])
    out = Path(tmp, "alone.npy")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_ALONE, str(art), str(Path(tmp, "frame.npz")), str(out),
         str(SERVE["tile"]), str(SERVE["margin"]), str(device)],
        capture_output=True, text=True, cwd=Path(__file__).resolve().parent, timeout=300,
    )
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] the fresh process failed:\n{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    if rec["models"]:
        raise AssertionError(f"[{tag}] the fresh process imported model classes {rec['models']}")
    got = np.load(out)
    dev = deviation(torch.from_numpy(got), torch.from_numpy(want))
    check(f"[{tag}] fresh-process frame", dev, FRAME_TOL)
    log(f"[{tag}] a fresh process ({time.perf_counter() - t0:.2f} s in all) loaded the artifact "
        f"in {rec['load_s']:.2f} s and denoised one frame in {rec['frame_s']:.4f} s (first, "
        f"warm-up included) with no model class imported; equal to the bit: "
        f"{np.array_equal(got, want)}, max_rel {dev['max_rel']:.6g}")


def phase_export(device, frames, smi: str) -> None:
    """Phase 13: serving artifacts of both prod generators (seeded weights):
    `save_params` → `tools.export_model` (platforms cuda) → `load_exported`;
    phase 4's frames through the artifact and the live model (launches,
    bodies, frame 0 within FRAME_TOL and whether equal to the bit, steady
    s/frame, peak memory); for AFGSA a fresh process serving a frame, the
    portable `cpu,cuda` artifact (the plain route: no launch, within
    FRAME_TOL of the kernel artifact) and `inference.main` with
    `inference.from_export` on a synthetic 512² scene."""
    from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache
    from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset
    from pixel_heal_thyself_tpu_torch.inference import (
        denoise_frame_fused,
        make_fused_frame_apply,
    )
    from pixel_heal_thyself_tpu_torch.inference import main as inference_main
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs
    from pixel_heal_thyself_tpu_torch.serving import load_exported
    from pixel_heal_thyself_tpu_torch.training.checkpoints import save_params

    t_phase = time.perf_counter()
    size, tile, margin, batch = (SERVE[k] for k in ("size", "tile", "margin", "batch"))
    models = {"afgsa": (AFGSANet, afgsa_prod_kwargs(), []),
              "mamba": (MambaDenoiserNet, mamba_prod_kwargs(), ["model=mamba"])}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        for name, (net, kwargs, cfg) in models.items():
            tag = f"export-{name}"
            ops, per_frame = EXPORT[name]
            model = net(**kwargs, device=device, generator=torch.Generator().manual_seed(0))
            model.eval()
            save_params(Path(tmp, f"{name}.pt"), model)
            base = ["-cn", "prod", *cfg, f"trainer.model_path={Path(tmp, name + '.pt')}"]
            art, export_s, art_bytes = export_artifact(tag, base, str(Path(tmp, f"{name}_art")))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply_fn, manifest = load_exported(art, device)
            load_s = time.perf_counter() - t0
            if manifest["kernel_ops"] != ops or manifest["platforms"] != [device.type]:
                raise AssertionError(f"[{tag}] manifest {manifest['kernel_ops']} "
                                     f"{manifest['platforms']}, expected {ops} on {device}")

            outs, launches, steady, peak = serve_frames(device, frames, apply_fn, tag)
            want = {k: per_frame.get(k, 0) * len(frames) for k in KERNEL_NAMES}
            if launches != want:
                raise AssertionError(f"[{tag}] the artifact launched {launches}, expected {want}")
            live, live_launches, live_steady, live_peak = serve_frames(device, frames, model,
                                                                        f"{tag}-live")
            if live_launches != launches:
                raise AssertionError(f"[{tag}] the live model launched {live_launches}, the "
                                     f"artifact {launches}")
            dev = deviation(torch.from_numpy(outs[0]), torch.from_numpy(live[0]))
            check(f"[{tag}] frame 0", dev, FRAME_TOL)
            log(f"[{tag}] launches per frame {per_frame} (artifact and live model alike), "
                f"prod bodies; frame 0 artifact vs live model: equal to the bit "
                f"{all(np.array_equal(o, w) for o, w in zip(outs, live))}, max_rel "
                f"{dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} (bound {FRAME_TOL})")
            log(f"[{tag}] steady s/frame: artifact {steady:.4f}, live model {live_steady:.4f} "
                f"({steady / live_steady - 1:+.2%}); export {export_s:.2f} s, artifact "
                f"{art_bytes} B, load {load_s:.2f} s; peak memory artifact {peak} B, live "
                f"{live_peak} B; {smi}")
            if name != "afgsa":
                del model, apply_fn
                continue

            serve_alone(tag, art, frames[0], outs[0], tmp, device)

            portable, _, _ = export_artifact(f"{tag}-portable", base, str(Path(tmp, "portable")),
                                             "export.platforms=cpu,cuda")
            port_fn, port_manifest = load_exported(portable, device)
            if port_manifest["kernel_ops"] or port_manifest["traced_on"] != "cpu":
                raise AssertionError(f"[{tag}] portable manifest {port_manifest}")
            reset_counts()
            fused = make_fused_frame_apply(port_fn, (size, size), tile=tile, margin=margin,
                                           batch_tiles=batch, device=device)
            t0 = time.perf_counter()
            got = denoise_frame_fused(fused, frames[0], device=device)
            port_s = time.perf_counter() - t0
            if any(read_counts().values()):
                raise AssertionError(f"[{tag}] the portable artifact launched {read_counts()}")
            dev = deviation(torch.from_numpy(got), torch.from_numpy(outs[0]))
            check(f"[{tag}] portable frame 0", dev, FRAME_TOL)
            log(f"[{tag}] portable cpu,cuda artifact (plain route, traced on the CPU, moved to "
                f"the card): no kernel launch, frame 0 {port_s:.4f} s (first), vs the kernel "
                f"artifact max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g}")

            images, out_dir = Path(tmp, "images"), Path(tmp, "served")
            generate_dataset(images, scenes=["fftle0_0"], height=size, width=size, seed=0)
            reset_run_dirs_cache()
            reset_counts()
            t0 = time.perf_counter()
            inference_main(["-cn", "prod", f"inference.from_export={art}",
                            f"inference.images_dir={images}", f"inference.out_dir={out_dir}",
                            f"inference.device={device.type}"])
            cli_s = time.perf_counter() - t0
            cli = read_counts()
            if cli != {k: per_frame.get(k, 0) for k in KERNEL_NAMES}:
                raise AssertionError(f"[{tag}] inference.main launched {cli}, expected "
                                     f"{per_frame} for its one frame")
            text = (out_dir / "fftle0_0_32_evaluation.txt").read_text()
            values = [float(line.split(": ")[1]) for line in text.splitlines()]
            if len(values) != 3 or not np.isfinite(values).all():
                raise AssertionError(f"[{tag}] evaluation.txt {text!r}")
            log(f"[{tag}] inference.main inference.from_export: one 512² scene in {cli_s:.2f} s "
                f"(EXR read, frame, scoring), launches {per_frame}, evaluation "
                f"{text.strip().replace(chr(10), '; ')}")
            del model, apply_fn, port_fn
        torch.cuda.empty_cache()
    log(f"[export] phase 13 {time.perf_counter() - t_phase:.2f} s; {smi}")


# phase 14: full-frame serving sharded over the ranks of torch.distributed,
# every rank on the one card: phase 4's frame 0 (512²) at prod width
# (seeded weights as phases 4 and 7). AFGSA row-sharded over 2 gloo ranks at
# margin 32 (against the strips the parent computes with their halos put in
# by hand: equal to the bit) and at margin 72 ≥ the prod reach of 2 + 5·12 +
# 3 = 65 px (against one rank: FRAME_TOL); one rank on nccl; Mamba
# sequence-sharded over 2 gloo ranks against the unsharded literal model
# (FRAME_TOL); the sharded CLI under `torch.distributed.run`. Two ranks
# sharing one card measure correctness and overhead, not a multi-GPU speed-up
SHARD = dict(ranks=2, margin=32, wide_margin=72, frames=2)
# what each rank launches for its strip of one frame: 5 blocks of K2 ×4 →
# K1 → K3 ×2 (AFGSA), nothing for the sequence path (its layers take the
# literal chain under seq_axis, as the JAX gate says: no K7)
SHARD_LAUNCHES = {"afgsa": {"K1": 5, "K2": 20, "K3": 10}, "mamba": {}}


def sharded_rank(tmp: str, jobs: list, device_type: str) -> None:
    """One rank of phase 14 (run by `parallel.distributed.spawn_world`): for
    each job (model, margin) the frame through the sharded path
    SHARD["frames"] times, each from counts of 0; saves the frames (rank
    0), each frame's launches and per-body launches, seconds and peak
    memory to `tmp/rank<r>.pt`."""
    import torch.distributed as dist

    from pixel_heal_thyself_tpu_torch import _build
    from pixel_heal_thyself_tpu_torch.inference import (
        denoise_frame_sequence,
        denoise_frame_spatial,
    )
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs
    from pixel_heal_thyself_tpu_torch.parallel import (
        make_seq_sharded_apply,
        make_sharded_apply_rows,
        row_axis,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()  # the parent's build
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device(device_type))
    axis = row_axis()
    frame = dict(np.load(Path(tmp, "frame.npz")))
    nets = {"afgsa": (AFGSANet, afgsa_prod_kwargs()), "mamba": (MambaDenoiserNet,
                                                               mamba_prod_kwargs())}
    res, models = {"backend": dist.get_backend(), "device": str(device)}, {}
    with deterministic_cudnn():
        for name, margin in jobs:
            if name not in models:
                net, kwargs = nets[name]
                models[name] = net(**kwargs, device=device).eval()
                models[name].load_state_dict(torch.load(Path(tmp, f"{name}.pt")))
            if name == "afgsa":
                sharded = make_sharded_apply_rows(models[name], margin, axis)
                run = partial(denoise_frame_spatial, sharded, frame, axis.size, margin=margin,
                              device=device)
            else:
                run = partial(denoise_frame_sequence, make_seq_sharded_apply(models[name], axis),
                              frame, axis.size, device=device)
            rec = {"secs": [], "launches": [], "bodies": []}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(SHARD["frames"]):
                reset_counts()
                t0 = time.perf_counter()
                out = run()  # syncs: the frame comes back to the host
                rec["secs"].append(time.perf_counter() - t0)
                rec["launches"].append(read_counts())
                rec["bodies"].append({k: dict(fn.body_launches) for k, fn in counters().items()
                                      if hasattr(fn, "body_launches")})
            rec["peak"] = torch.cuda.max_memory_allocated()
            if axis.index == 0:
                rec["frame"] = out
            res[f"{name}/{margin}"] = rec
    torch.save(res, Path(tmp, f"rank{axis.index}.pt"))


def hand_strips(model, frame: dict, ranks: int, margin: int, device) -> np.ndarray:
    """`denoise_frame_spatial`'s frame computed in this process with no
    process group: the frame padded as it pads it, each rank's strip given
    `margin` rows of its neighbours (the frame's edge row replicated at the
    top and bottom) by hand, through the model, cropped and stacked."""
    from pixel_heal_thyself_tpu_torch.data.preprocessing import postprocess_specular
    from pixel_heal_thyself_tpu_torch.inference import _model_inputs

    noisy, aux = _model_inputs(frame)
    h, w = noisy.shape[:2]
    pad = ((0, (-h) % (8 * ranks)), (margin, margin + (-w) % 8), (0, 0))
    noisy, aux = (np.pad(x, pad, mode="edge") for x in (noisy, aux))
    strip = noisy.shape[0] // ranks
    outs = []
    for r in range(ranks):
        lo, hi = r * strip, (r + 1) * strip
        rows = np.concatenate([np.full(margin, lo), np.arange(lo, hi), np.full(margin, hi - 1)])
        if r:
            rows[:margin] = np.arange(lo - margin, lo)
        if r < ranks - 1:
            rows[-margin:] = np.arange(hi, hi + margin)
        with torch.inference_mode():
            out = model(torch.from_numpy(noisy[rows][None]).to(device),
                        torch.from_numpy(aux[rows][None]).to(device))
        outs.append(out[0, margin:-margin].float().cpu().numpy())
    return postprocess_specular(np.concatenate(outs)[:h, margin:margin + w])


def spawn_ranks(tmp: str, ranks: int, jobs: list, tag: str, device) -> tuple:
    """`sharded_rank` in `ranks` fresh processes on `device`: (each rank's
    record, seconds in all, spawn and process-group start included)."""
    from pixel_heal_thyself_tpu_torch.parallel.distributed import spawn_world

    for r in range(ranks):
        Path(tmp, f"rank{r}.pt").unlink(missing_ok=True)
    init = Path(tmp, f"init_{tag}")
    init.unlink(missing_ok=True)
    t0 = time.perf_counter()
    spawn_world(sharded_rank, ranks, f"file://{init}", device.type, args=(tmp, jobs, device.type))
    secs = time.perf_counter() - t0
    return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False) for r in range(ranks)], secs


def check_shard_run(tag: str, recs: list, key: str, want: dict, backend: str) -> None:
    """Every rank's backend, and each of its frames' launches: `want` and
    nothing else, every launch on its prod body."""
    for r, rec in enumerate(recs):
        if rec["backend"] != backend:
            raise AssertionError(f"[{tag}] rank {r}: backend {rec['backend']}, expected {backend}")
        job = rec[key]
        for launches, bodies in zip(job["launches"], job["bodies"]):
            expect = {k: want.get(k, 0) for k in KERNEL_NAMES}
            if launches != expect:
                raise AssertionError(f"[{tag}] rank {r} {key}: launches {launches}, expected "
                                     f"{expect}")
            for name, n in want.items():
                if bodies[name]["general"] or bodies[name][PROD_BODIES[name]] != n:
                    raise AssertionError(f"[{tag}] rank {r} {key}: {name} bodies {bodies[name]}")
        log(f"[{tag}] rank {r} ({rec['device']}, {backend}) {key}: launches a frame "
            f"{want or 'none'} on the prod bodies; seconds per frame "
            f"{[round(x, 4) for x in job['secs']]} (first includes warm-up); peak memory "
            f"{job['peak']} B ({job['peak'] / 2**30:.3f} GiB)")


def phase_sharded(device, frame: dict, smi: str) -> None:
    """Phase 14: sharded full-frame serving on the one card (SHARD's comment):
    the 2-rank gloo world runs AFGSA at margins 32 and 72 and Mamba; a
    1-rank nccl world AFGSA at margin 32; then the CLI under
    `torch.distributed.run` with 2 ranks. Any rank's failure fails it."""
    from pixel_heal_thyself_tpu_torch.data.preprocessing import postprocess_specular
    from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset
    from pixel_heal_thyself_tpu_torch.inference import _model_inputs, denoise_frame_spatial
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs
    from pixel_heal_thyself_tpu_torch.parallel import make_sharded_apply_rows
    from pixel_heal_thyself_tpu_torch.training.checkpoints import save_params

    t_phase = time.perf_counter()
    ranks, margin, wide = SHARD["ranks"], SHARD["margin"], SHARD["wide_margin"]
    with tempfile.TemporaryDirectory() as tmp:
        afgsa = AFGSANet(**afgsa_prod_kwargs(), device=device,
                         generator=torch.Generator().manual_seed(0)).eval()
        mamba_kwargs = mamba_prod_kwargs()
        mamba = MambaDenoiserNet(**mamba_kwargs, device=device,
                                 generator=torch.Generator().manual_seed(0)).eval()
        for name, model in (("afgsa", afgsa), ("mamba", mamba)):
            torch.save(model.state_dict(), Path(tmp, f"{name}.pt"))
        np.savez(Path(tmp, "frame.npz"), noisy=frame["noisy"], aux=frame["aux"])

        # this process, no process group: the references
        with deterministic_cudnn():
            strips = hand_strips(afgsa, frame, ranks, margin, device)
            t0 = time.perf_counter()
            one_rank = {m: denoise_frame_spatial(make_sharded_apply_rows(afgsa, m), frame, 1,
                                                 margin=m, device=device) for m in (margin, wide)}
            one_rank_s = (time.perf_counter() - t0) / 2
            literal = MambaDenoiserNet(**dict(mamba_kwargs, use_megakernel=False),
                                       device=device).eval()
            literal.load_state_dict(mamba.state_dict())
            noisy, aux = (torch.from_numpy(x[None]).to(device) for x in _model_inputs(frame))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            whole_s = []
            for _ in range(SHARD["frames"]):
                t0 = time.perf_counter()
                with torch.inference_mode():
                    whole = postprocess_specular(literal(noisy, aux)[0].float().cpu().numpy())
                whole_s.append(round(time.perf_counter() - t0, 4))
            whole_peak = torch.cuda.max_memory_allocated()
        log(f"[sharded] references in this process: AFGSA one rank {one_rank_s:.4f} s/frame "
            f"(mean of margins {margin} and {wide}); Mamba literal model on the whole frame "
            f"({noisy.shape[1] * noisy.shape[2]} tokens a layer) {whole_s} s/frame (first "
            f"includes warm-up), peak {whole_peak} B")
        del literal, mamba, noisy, aux
        torch.cuda.empty_cache()

        # 2 gloo ranks sharing the card
        recs, secs = spawn_ranks(tmp, ranks, [("afgsa", margin), ("afgsa", wide),
                                              ("mamba", 0)], "gloo", device)
        for key in (f"afgsa/{margin}", f"afgsa/{wide}", "mamba/0"):
            check_shard_run("sharded", recs, key, SHARD_LAUNCHES[key.split("/")[0]], "gloo")
        got = recs[0][f"afgsa/{margin}"]["frame"]
        if not np.array_equal(got, strips):
            dev = deviation(torch.from_numpy(got), torch.from_numpy(strips))
            raise AssertionError(f"[sharded] AFGSA {ranks} ranks, margin {margin}: the gathered "
                                 f"frame differs from the hand-built strips: {dev}")
        log(f"[sharded] AFGSA {ranks} gloo ranks, margin {margin}: the gathered frame equals the "
            "strips computed here with their halos put in by hand, to the bit")
        dev = deviation(torch.from_numpy(recs[0][f"afgsa/{wide}"]["frame"]),
                        torch.from_numpy(one_rank[wide]))
        check(f"[sharded] AFGSA margin {wide}", dev, FRAME_TOL)
        log(f"[sharded] AFGSA {ranks} ranks, margin {wide} (≥ the reach of 65 px) vs one rank: "
            f"max_rel {dev['max_rel']:.6g} rms_rel {dev['rms_rel']:.6g} (bound {FRAME_TOL})")
        dev = deviation(torch.from_numpy(recs[0]["mamba/0"]["frame"]), torch.from_numpy(whole))
        check("[sharded] Mamba sequence-sharded frame", dev, FRAME_TOL)
        log(f"[sharded] Mamba {ranks} ranks, sequence-sharded (literal chain, no K7) vs the "
            f"literal model on the whole frame: max_rel {dev['max_rel']:.6g} rms_rel "
            f"{dev['rms_rel']:.6g} (bound {FRAME_TOL})")
        log(f"[sharded] {ranks}-rank gloo world: {secs:.2f} s in all (spawn, process group, "
            f"builds, 3 paths × {SHARD['frames']} frames); {smi}")

        # one rank on nccl: its process group and a CUDA-tensor all_gather
        recs, secs = spawn_ranks(tmp, 1, [("afgsa", margin)], "nccl", device)
        check_shard_run("sharded-nccl", recs, f"afgsa/{margin}", SHARD_LAUNCHES["afgsa"], "nccl")
        got = recs[0][f"afgsa/{margin}"]["frame"]
        if not np.array_equal(got, one_rank[margin]):
            dev = deviation(torch.from_numpy(got), torch.from_numpy(one_rank[margin]))
            raise AssertionError(f"[sharded-nccl] the frame differs from one rank with no process "
                                 f"group: {dev}")
        log(f"[sharded-nccl] 1 rank on nccl, margin {margin}: the frame equals this process's "
            f"one-rank frame to the bit; {secs:.2f} s in all; {smi}")

        # the CLI: 2 ranks under torch.distributed.run
        images, out_dir = Path(tmp, "images"), Path(tmp, "served")
        generate_dataset(images, scenes=["fftle0_0"], height=SERVE["size"],
                         width=SERVE["size"], seed=0)
        save_params(Path(tmp, "afgsa_params.pt"), afgsa)
        repo = Path(__file__).resolve().parent
        env = {**os.environ, "PYTHONPATH": str(repo)}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={ranks}", "-m", "pixel_heal_thyself_tpu_torch.inference", "-cn",
             "prod", "parallel.multihost=true", "inference.spatial=true",
             f"trainer.model_path={Path(tmp, 'afgsa_params.pt')}",
             f"inference.images_dir={images}", f"inference.out_dir={out_dir}",
             f"inference.device={device.type}"],
            capture_output=True, text=True, cwd=tmp, env=env, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[sharded-cli] torch.distributed.run exited {proc.returncode}:"
                                 f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        written = sorted(p.name for p in out_dir.iterdir())
        text = (out_dir / "fftle0_0_32_evaluation.txt").read_text()
        values = [float(line.split(": ")[1]) for line in text.splitlines()]
        if written != ["fftle0_0_32_evaluation.txt"] or not np.isfinite(values).all():
            raise AssertionError(f"[sharded-cli] wrote {written}: {text!r}")
        backends = sorted(set(re.findall(r"backend (\w+)", proc.stdout + proc.stderr)))
        log(f"[sharded-cli] torch.distributed.run --nproc-per-node={ranks} inference -cn prod "
            f"inference.spatial=true: one {SERVE['size']}² scene in {cli_s:.2f} s in all (launcher, "
            f"{ranks} processes, EXR read, frame, scoring), backend {backends}, one evaluation "
            f"{text.strip().replace(chr(10), '; ')}")
        del afgsa
        torch.cuda.empty_cache()
    log(f"[sharded] phase 14 {time.perf_counter() - t_phase:.2f} s; {smi}")


# phase 15: multi-GPU training on the one card. nccl refuses two ranks on
# one GPU, so 2 gloo ranks share it (their collectives staged through host
# memory), as in phase 14: correctness and overhead, not a speed-up. Each
# job trains the prod generator against the prod critic (DiscriminatorVGG(128,
# 64) in GP_CRITIC_DTYPE) on the global batch 8 × 128² (4 rows a rank at
# D = 2): DP["steps"] timed bf16 steps (TF32 on, as the trainer sets it),
# then one step with a float32 critic under deterministic cuDNN against
# one process (STEP_LOSS_TOL; STEP_GRAD_TOL, Mamba
# MAMBA_STEP_GRAD_TOL). The D = 1 × M = 2 job shards Adam over the two
# ranks: its step must equal one process to the bit.
DP = dict(ranks=2, steps=4)
DP_JOBS = (("afgsa", (2, 1)), ("mamba", (2, 1)), ("afgsa", (1, 2)))
# each kernel a timed step must launch, per generator
DP_KERNELS = {"afgsa": ("K1", "K2", "K3", "K4", "K5", "K6"), "mamba": ("K7e", "K8")}
# the CLI: phase 11's cuts (4 synthetic 512² scenes) and 16 patches an
# image (prod 400: 3 steps an epoch, a short replicated validation), 1
# epoch, then a resume for a second
DP_CLI_ARGS = ["-cn", TRAINER_CONFIG, "parallel.multihost=true", "parallel.data_axis=2",
               "data.images.synthesize=true", "data.images.synthetic_size=512",
               "data.patches.num_patches=16", "--device", "cuda"]


def _prod_net(name: str):
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs

    return {"afgsa": (AFGSANet, afgsa_prod_kwargs()),
            "mamba": (MambaDenoiserNet, mamba_prod_kwargs())}[name]


def _rows(data: dict, mesh) -> dict:
    """This rank's `host_batch_bounds` rows of a global batch."""
    from pixel_heal_thyself_tpu_torch.parallel.distributed import host_batch_bounds

    lo, hi = host_batch_bounds(next(iter(data.values())).shape[0], mesh.data_index, mesh.data)
    return {k: v[lo:hi] for k, v in data.items()}


def compare_step(device, name: str, alpha, mesh=None) -> dict:
    """Phase 15's comparison step: the seeded prod state with a float32
    critic (over `mesh`'s data group; the global batch's rows of this rank),
    under deterministic cuDNN: metrics, G gradients and G parameters after
    the step (on the host)."""
    net, kwargs = _prod_net(name)
    patch, batch = TRAIN["patch"], TRAIN["batch"]
    with deterministic_cudnn():
        g, d, data = _train_state(device, torch.float32, kwargs, patch, batch, seed=3, net=net,
                                  data_group=None if mesh is None else mesh.data_group)
        step = make_step(g, d, mesh=mesh)
        metrics = {k: v.item() for k, v in step(data if mesh is None else _rows(data, mesh),
                                                alpha=alpha).items()}
    return {"metrics": metrics,
            "grads": {n: p.grad.detach().float().cpu() for n, p in g.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().float().cpu() for n, p in g.named_parameters()}}


def dp_rank(tmp: str, device_type: str, alpha) -> None:
    """One rank of phase 15's gloo world (`spawn_world`): each of DP_JOBS
    over its grid: the timed bf16 steps (each step's seconds, its seconds
    in the step's collectives, the launches and bodies of all of them,
    peak memory), then `compare_step`. Saves to `tmp/dp_rank<r>.pt`."""
    import torch.distributed as dist

    from pixel_heal_thyself_tpu_torch import _build
    from pixel_heal_thyself_tpu_torch.models.discriminators import GP_CRITIC_DTYPE
    from pixel_heal_thyself_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()  # the parent's build
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device(device_type))
    patch, batch = TRAIN["patch"], TRAIN["batch"]
    res = {"backend": dist.get_backend(), "device": str(device)}
    for name, grid in DP_JOBS:
        mesh = make_mesh(*grid)
        net, kwargs = _prod_net(name)
        g, d, data = _train_state(device, GP_CRITIC_DTYPE, kwargs, patch, batch, seed=0, net=net,
                                  data_group=mesh.data_group)
        step = make_step(g, d, mesh=mesh)
        local = _rows(data, mesh)
        gen = torch.Generator(device=device).manual_seed(7)
        rec = {"secs": [], "comm": [], "losses": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for _ in range(DP["steps"]):
            t0, c0 = time.perf_counter(), step.comm_seconds
            with trainer_tf32():
                metrics = step(local, generator=gen)
                rec["losses"].append({k: v.item() for k, v in metrics.items()})  # syncs
            rec["secs"].append(time.perf_counter() - t0)
            rec["comm"].append(step.comm_seconds - c0)
        rec["launches"] = read_counts()
        rec["bodies"] = {k: dict(fn.body_launches) for k, fn in counters().items()
                         if hasattr(fn, "body_launches")}
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["kept"] = {part: sum(p.numel() for grp in opt.param_groups for p in grp["params"])
                       for part, opt in (("g", step.g_opt), ("d", step.d_opt))}
        del g, d, data, step, local
        torch.cuda.empty_cache()
        rec.update(compare_step(device, name, alpha, mesh))
        res[f"{name}/{grid[0]}x{grid[1]}"] = rec
    torch.save(res, Path(tmp, f"dp_rank{dist.get_rank()}.pt"))


def dp_nccl_rank(tmp: str, alpha) -> None:
    """Phase 15's nccl rank (a world of 1): after a warm-up step, the
    comparison step with no grid, over the grid the trainer builds (1 × 1),
    then over a data group of this one rank, whose collectives run on nccl
    with CUDA tensors."""
    import torch.distributed as dist

    from pixel_heal_thyself_tpu_torch import _build
    from pixel_heal_thyself_tpu_torch.parallel.mesh import Mesh, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    device = torch.device("cuda", torch.cuda.current_device())
    res = {"backend": dist.get_backend(), "grid": make_mesh(-1, 1, TRAIN["batch"])}
    # the first step of a process (cold library handles) need not take the
    # algorithms of the later ones: compare warm steps, as the gloo ranks do
    compare_step(device, "afgsa", alpha)
    res["none"] = compare_step(device, "afgsa", alpha)
    res["world1"] = compare_step(device, "afgsa", alpha, res["grid"])
    res["group1"] = compare_step(device, "afgsa", alpha, Mesh(data_group=dist.group.WORLD))
    torch.save(res, Path(tmp, "dp_nccl.pt"))


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def check_dp_comparison(tag: str, got: dict, ref: dict, grad_tol: tuple) -> None:
    """A phase 15 comparison step against one process's: the losses within
    STEP_LOSS_TOL, the G gradients within `grad_tol` (rms, mass)."""
    for key in ("d_loss", "g_loss"):
        want = ref["metrics"][key]
        if abs(got["metrics"][key] - want) > STEP_LOSS_TOL * max(1.0, abs(want)):
            raise AssertionError(f"[{tag}] {key}: {got['metrics'][key]} vs one process {want}")
    table = grad_table(got["grads"], ref["grads"])
    check_table(tag, table, grad_tol)
    log(f"[{tag}] one step (float32 critic, deterministic cuDNN) vs one process: d_loss "
        f"{got['metrics']['d_loss']:.6g} vs {ref['metrics']['d_loss']:.6g}, g_loss "
        f"{got['metrics']['g_loss']:.6g} vs {ref['metrics']['g_loss']:.6g}; G gradients worst "
        f"rms_rel {max(r[1] for r in table):.4e}, worst mass {table[0][2]:.4e} ({table[0][0]}) "
        f"(bounds {grad_tol}); equal to the bit: {_same(got['grads'], ref['grads'])}")


def check_dp_timed(tag: str, recs: list, key: str, name: str) -> None:
    """Every rank's timed steps: finite global losses equal on every rank,
    each kernel of the generator launched for every block of every step on
    its prod body; prints s/step, collective seconds, peak memory and
    launches per rank."""
    layers = 5
    need = layers * DP["steps"]
    for r, rec in enumerate(recs):
        job = rec[key]
        if job["losses"] != recs[0][key]["losses"]:
            raise AssertionError(f"[{tag}] rank {r}: losses {job['losses']} differ from rank 0's")
        if not all(math.isfinite(v) for m in job["losses"] for v in m.values()):
            raise AssertionError(f"[{tag}] rank {r}: non-finite losses {job['losses']}")
        for k in DP_KERNELS[name]:
            bodies = job["bodies"][k]
            if job["launches"][k] < need or bodies["general"] or bodies[PROD_BODIES[k]] != \
                    job["launches"][k]:
                raise AssertionError(f"[{tag}] rank {r}: {k} launched {job['launches'][k]} "
                                     f"(need ≥ {need}), bodies {bodies}")
        steady = job["secs"][1:]
        log(f"[{tag}] rank {r} ({rec['device']}, {rec['backend']}): s/step "
            f"{[round(x, 4) for x in job['secs']]} (first includes warm-up; steady mean "
            f"{np.mean(steady):.4f}), gradient/parameter collectives s/step "
            f"{[round(x, 4) for x in job['comm']]}, peak memory {job['peak']} B "
            f"({job['peak'] / 2**30:.3f} GiB), parameters its Adams update G {job['kept']['g']} "
            f"D {job['kept']['d']}, launches {job['launches']}")
    log(f"[{tag}] losses (global, equal on every rank) step 0 {recs[0][key]['losses'][0]}")


def run_dp_cli(tmp: str, extra: list, tag: str) -> tuple:
    """`torch.distributed.run --nproc-per-node 2 -m ...train` with
    DP_CLI_ARGS + `extra` in `tmp`: (seconds, output)."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={DP['ranks']}", "-m", "pixel_heal_thyself_tpu_torch.train",
         *DP_CLI_ARGS, *extra],
        capture_output=True, text=True, cwd=tmp, env=env, timeout=600,
    )
    secs = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] torch.distributed.run exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for line in out.splitlines():
        if any(k in line for k in ("[dist]", "Mesh:", "summary:", "Resumed", "in total",
                                   "kernel launches")):
            log(f"[{tag}] {line.split('] ', 2)[-1]}")
    launches = re.findall(r"kernel launches: (.*);", out)
    want = ("block_halo_attention_cuda", "pointwise_gemm_cuda", "conv3x3_cuda",
            "block_halo_attention_bwd_cuda", "conv3x3_dgrad_cuda", "weight_grad_cuda")
    if len(launches) != DP["ranks"] or not all(k in line for line in launches for k in want):
        raise AssertionError(f"[{tag}] each rank's epoch must launch K1–K6: {launches}")
    return secs, out


def phase_dp_training(device, smi: str) -> None:
    """Phase 15 (DP's comment): the 2-rank gloo world over DP_JOBS, one
    nccl rank, then the training CLI under `torch.distributed.run` and its
    resume. Any rank's failure fails it."""
    from pixel_heal_thyself_tpu_torch.parallel.distributed import spawn_world

    t_phase = time.perf_counter()
    alpha = torch.rand((TRAIN["batch"], 1, 1, 1), generator=torch.Generator().manual_seed(5))
    # a warm-up step first: a process's first step need not take the
    # library algorithms of its later ones (dp_nccl_rank)
    compare_step(device, "afgsa", alpha.to(device))
    refs = {name: compare_step(device, name, alpha.to(device)) for name in ("afgsa", "mamba")}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_world(dp_rank, DP["ranks"], f"file://{tmp}/init_gloo", device.type,
                    args=(tmp, device.type, alpha))
        secs = time.perf_counter() - t0
        recs = [torch.load(Path(tmp, f"dp_rank{r}.pt"), weights_only=False)
                for r in range(DP["ranks"])]
        for name, grid in DP_JOBS:
            key = f"{name}/{grid[0]}x{grid[1]}"
            tag = f"dp-{name}-{grid[0]}x{grid[1]}"
            if any(rec["backend"] != "gloo" for rec in recs):
                raise AssertionError(f"[{tag}] backends {[rec['backend'] for rec in recs]}")
            check_dp_timed(tag, recs, key, name)
            for r, rec in enumerate(recs):
                got, ref = rec[key], refs[name]
                if grid[1] == 1:
                    tol = MAMBA_STEP_GRAD_TOL if name == "mamba" else STEP_GRAD_TOL
                    check_dp_comparison(f"{tag} rank {r}", got, ref, tol)
                    continue
                if not (got["metrics"] == ref["metrics"] and _same(got["grads"], ref["grads"])
                        and _same(got["params"], ref["params"])):
                    dev = deviation(list(got["params"].values()), list(ref["params"].values()))
                    raise AssertionError(f"[{tag}] rank {r}: the step differs from one "
                                         f"process's: parameters after it {dev}")
                log(f"[{tag}] rank {r}: losses, G gradients and G parameters after the step "
                    f"(Adam on this rank's shards, then the all-gather) equal to one process's "
                    f"to the bit")
        log(f"[dp] {DP['ranks']}-rank gloo world: {secs:.2f} s in all (spawn, process group, "
            f"3 jobs); {smi}")

        t0 = time.perf_counter()
        spawn_world(dp_nccl_rank, 1, f"file://{tmp}/init_nccl", "cuda", args=(tmp, alpha))
        rec = torch.load(Path(tmp, "dp_nccl.pt"), weights_only=False)
        if rec["backend"] != "nccl":
            raise AssertionError(f"[dp-nccl] backend {rec['backend']}")
        got, none = rec["world1"], rec["none"]
        if not (got["metrics"] == none["metrics"] and _same(got["grads"], none["grads"])
                and _same(got["params"], none["params"])):
            dev = deviation(list(got["grads"].values()), list(none["grads"].values()))
            raise AssertionError(f"[dp-nccl] the step over the world-size-1 grid differs from "
                                 f"the step with no grid: G gradients {dev}")
        log(f"[dp-nccl] 1 rank on nccl, grid {rec['grid'].data}x{rec['grid'].model}: the step "
            "(losses, G gradients, G parameters) equals the same process's step with no grid "
            "to the bit")
        check_dp_comparison("dp-nccl rank vs this process", none, refs["afgsa"], STEP_GRAD_TOL)
        check_dp_comparison("dp-nccl data group of 1 rank", rec["group1"], none, STEP_GRAD_TOL)
        log(f"[dp-nccl] {time.perf_counter() - t0:.2f} s in all; {smi}")

        dp_cli(tmp)
    torch.cuda.empty_cache()
    log(f"[dp] phase 15 {time.perf_counter() - t_phase:.2f} s; {smi}")


def dp_cli(tmp: str) -> None:
    """Phase 15's CLI leg in `tmp`: one epoch over 2 ranks, then a resume
    for a second; only rank 0 makes run directories."""
    runs = Path(tmp, "outputs", "runs")
    secs, out = run_dp_cli(tmp, ["trainer.epochs=1", "run_num=0"], "dp-cli")
    run0 = next(runs.glob("*/run000"))
    checks = {"backends": sorted(set(re.findall(r"backend (\w+)", out))),
              "mesh": "Mesh: 2 data x 1 model over 2 ranks" in out,
              "files": sorted(p.name for p in run0.iterdir()),
              "loss": (run0 / "train_loss.txt").read_text().splitlines(),
              "eval": (run0 / "evaluation.txt").read_text().splitlines()}
    if (checks["backends"] != ["gloo"] or not checks["mesh"] or len(checks["loss"]) != 1
            or len(checks["eval"]) != 1 or "model_epoch1" not in checks["files"]):
        raise AssertionError(f"[dp-cli] {checks}")
    values = [float(v) for v in re.findall(r"-?\d+\.\d+", checks["loss"][0] + checks["eval"][0])]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"[dp-cli] non-finite {checks}")
    log(f"[dp-cli] 2 ranks, 1 epoch: {secs:.2f} s in all (launcher, processes, store, "
        f"epoch, replicated validation); {checks['loss'][0]!r}; {checks['eval'][0]!r}")
    ckpt = run0 / "model_epoch1" / "state"
    secs, out = run_dp_cli(tmp, ["trainer.epochs=2", "run_num=1", "trainer.load_model=true",
                                 f"trainer.model_path={ckpt}"], "dp-cli-resume")
    run1 = next(runs.glob("*/run001"))
    lines = (run1 / "train_loss.txt").read_text().splitlines()
    if len(re.findall(r"Resumed from .* at epoch 1", out)) != DP["ranks"] or not (
            len(lines) == 1 and lines[0].startswith("Epoch: 2")):
        raise AssertionError(f"[dp-cli-resume] {lines}")
    if sorted(p.name for p in runs.glob("*/*")) != ["run000", "run001"]:
        raise AssertionError(f"[dp-cli] run dirs {sorted(p.name for p in runs.glob('*/*'))}")
    log(f"[dp-cli-resume] both ranks resumed at epoch 2 in {secs:.2f} s: {lines[0]!r}; "
        "only rank 0 made run directories")


# phase 16: the measurement and data tools of `pixel_heal_thyself_tpu_torch.
# tools` on the card, each through its `run`: 720p tiled serving of both prod
# generators (bench_inference), the AFGSA artifact against the live model at
# 720p (bench_serving), the input-pipeline split of the AFGSA GAN step
# (bench_pipeline), per-sample FLOP counts (flops_train_step), and the EXR
# inspection, resize and dataset tools on small synthetic scenes
TOOLS = dict(height=720, width=1280, iters=2, mamba_iters=1, frames=2, steps=5, exr_size=64)
# launches per 720p frame: ⌈720/t⌉·⌈1280/t⌉ windows in batches of 8, 5 blocks
# (AFGSA: K1 once, K2 4 times, K3 twice a block; Mamba: K7 once a layer)
TOOL_FRAME_LAUNCHES = {
    ("afgsa", 64): {"K1": 150, "K2": 600, "K3": 300},  # 240 windows, 30 batches
    ("afgsa", 96): {"K1": 70, "K2": 280, "K3": 140},  # 112 windows, 14 batches
    ("afgsa", 112): {"K1": 55, "K2": 220, "K3": 110},  # 84 windows, 11 batches (4 pad)
    ("mamba", 64): {"K7": 150},
}
# launches of one prod AFGSA GAN step (phase 5)
STEP_LAUNCHES = {"K1": 5, "K2": 60, "K3": 10, "K4": 5, "K5": 10, "K6": 30}


def tool_frames(model, name: str, geometry: tuple, variant: str, iters: int, device) -> tuple:
    """`bench_inference.run` of `model` at one geometry and dispatch variant
    from counts of 0: every frame launched TOOL_FRAME_LAUNCHES on the prod
    bodies. Returns (the result, the first frame's output)."""
    from pixel_heal_thyself_tpu_torch.tools import bench_inference

    h, w = TOOLS["height"], TOOLS["width"]
    tag = f"tools-{name}-{variant}-t{geometry[0]}"
    reset_counts()
    (result,), frames = bench_inference.run(model, h, w, iters, variant, geometries=(geometry,),
                                            device=device, log=lambda s: None)
    launches = read_counts()
    per_frame = TOOL_FRAME_LAUNCHES[(name, geometry[0])]
    want = {k: per_frame.get(k, 0) * (iters + 1) for k in KERNEL_NAMES}
    if launches != want:
        raise AssertionError(f"[{tag}] {iters + 1} frames launched {launches}, expected {want}")
    check_bodies(tag, launches, quiet=True)
    out = frames[geometry]
    if out.shape != (h, w, 3) or not np.isfinite(out).all():
        raise AssertionError(f"[{tag}] bad frame {out.shape}, finite={np.isfinite(out).all()}")
    return result, out


def phase_tools(device, step_rates: dict, smi: str) -> None:
    """Phase 16: each tool of `pixel_heal_thyself_tpu_torch.tools` through
    its `run` on the card (TOOLS; prod widths, bf16, seeded weights):
    bench_inference's three geometries with the AFGSANet (K1/K2/K3 per frame
    and bodies, the seam PSNR against tile 64) and its sync, pipelined and
    fused dispatch at tile 64 equal to the bit, the MambaDenoiserNet at tile
    64 (K7); bench_serving's artifact (every `pht::` op of the live forward
    in its graph) equal to the live model to the bit at 720p;
    bench_pipeline's seven modes (finite losses, every step's K1–K6 on the
    prod bodies); flops_train_step for both generators with the FLOP share
    that phases 5's and 8's step rates imply; inspect, resize_exrs and
    make_synthetic_datasets on small synthetic scenes."""
    from pixel_heal_thyself_tpu_torch.data import inspect
    from pixel_heal_thyself_tpu_torch.data.exr import read_exr_header
    from pixel_heal_thyself_tpu_torch.tools import (
        bench_inference,
        bench_pipeline,
        bench_serving,
        flops_train_step,
        make_synthetic_datasets,
        prod_critic,
        prod_generator,
        resize_exrs,
    )

    t_phase = time.perf_counter()
    h, w, iters = TOOLS["height"], TOOLS["width"], TOOLS["iters"]
    afgsa = prod_generator("afgsa", device).eval()
    first = bench_inference.GEOMETRIES[0]
    ref = None
    for geometry in bench_inference.GEOMETRIES:
        res, out = tool_frames(afgsa, "afgsa", geometry, "pipelined", iters, device)
        ref = out if ref is None else ref
        seam = None if geometry == first else bench_inference.psnr(out, ref)
        log(f"[tools-inference] afgsa {h}×{w} tile {geometry[0]} margin {geometry[1]}: "
            f"{res['sec_per_frame']:.4f} s/frame ({iters} frames), {res['mpix_per_sec']:.4f} "
            f"Mpix/s, seam PSNR vs tile 64 {seam}; launches a frame "
            f"{TOOL_FRAME_LAUNCHES[('afgsa', geometry[0])]} on the prod bodies; {smi}")
    for variant in ("sync", "fused"):
        res, out = tool_frames(afgsa, "afgsa", first, variant, iters, device)
        if not np.array_equal(out, ref):
            raise AssertionError(f"[tools-inference] the {variant} frame differs from the "
                                 f"pipelined one: max abs {np.abs(out - ref).max()}")
        log(f"[tools-inference] afgsa {h}×{w} tile 64 {variant}: {res['sec_per_frame']:.4f} "
            f"s/frame, {res['mpix_per_sec']:.4f} Mpix/s; frame equal to the pipelined one "
            f"to the bit; {smi}")
    mamba = prod_generator("mamba", device).eval()
    res, _ = tool_frames(mamba, "mamba", first, "pipelined", TOOLS["mamba_iters"], device)
    log(f"[tools-inference] mamba {h}×{w} tile 64: {res['sec_per_frame']:.4f} s/frame "
        f"({TOOLS['mamba_iters']} frame), {res['mpix_per_sec']:.4f} Mpix/s; K7 150 a frame "
        f"on the prod bodies; {smi}")
    del mamba
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        result, frames = bench_serving.run(afgsa, str(Path(tmp, "art")), TOOLS["frames"], h, w,
                                           device, log=lambda s: None)
        check_bodies("tools-serving", read_counts(), quiet=True)
    if not result["pht_ops_in_live_forward"] or not result["live_ops_all_in_artifact"]:
        raise AssertionError(f"[tools-serving] live forward ops {result['pht_ops_in_live_forward']}"
                             f", artifact {result['pht_ops_in_artifact']}")
    if not np.array_equal(frames["exported"], frames["live"]):
        raise AssertionError(f"[tools-serving] exported frame differs from the live one: "
                             f"max_abs_delta {result['max_abs_delta']}")
    log(f"[tools-serving] {json.dumps(result)}; exported frame equal to the live one to the "
        f"bit; {smi}")
    del afgsa
    torch.cuda.empty_cache()

    g = prod_generator("afgsa", device).train()
    d = prod_critic(device).train()
    steps = TOOLS["steps"]

    @contextlib.contextmanager
    def probe(mode):
        reset_counts()
        yield
        launches = read_counts()
        want = {k: STEP_LAUNCHES.get(k, 0) * steps for k in KERNEL_NAMES}
        if launches != want:
            raise AssertionError(f"[tools-pipeline] {mode}: {steps} steps launched {launches}, "
                                 f"expected {want}")
        check_bodies(f"tools-pipeline-{mode}", launches, quiet=True)

    runs = bench_pipeline.run(g, d, bench_pipeline.host_batches(steps, TRAIN["batch"],
                                                                TRAIN["patch"]),
                              device, probe=probe, log=lambda s: None)
    for mode, r in runs.items():
        if not np.isfinite(r["losses"]).all():
            raise AssertionError(f"[tools-pipeline] {mode}: losses {r['losses']}")
    log(f"[tools-pipeline] patches/s over {steps} steps a mode, every step K1–K6 "
        f"{STEP_LAUNCHES} on the prod bodies, finite losses: "
        f"{ {m: round(r['patches_per_sec'], 4) for m, r in runs.items()} }; {smi}")
    del g, d
    torch.cuda.empty_cache()

    for name, rate in step_rates.items():
        g, d = flops_train_step.models(name, device, use_kernels=False)
        out = flops_train_step.run(g, d, flops_train_step.BATCH[name], device=device)
        share = flops_train_step.flop_share(out["full_step_tflop_per_sample"], rate)
        log(f"[tools-flops] {name} (plain route counted, batch {out['batch']} × 128²): full "
            f"step {out['full_step_tflop_per_sample']:.6f} TFLOP/sample, G forward "
            f"{out['g_fwd_tflop_per_sample']:.6f}, G forward + backward "
            f"{out['g_fwd_bwd_tflop_per_sample']:.6f}; at the step rate {rate:.4f} patches/s "
            f"(phase {5 if name == 'afgsa' else 8}) the full step's share of the dense bf16 "
            f"peak (mfu) {share:.6f}; {smi}")
        del g, d
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        size = TOOLS["exr_size"]
        make_synthetic_datasets.run(tmp, size=size)
        files = sorted(Path(tmp).rglob("*.exr"))
        exr = Path(tmp, "images_heldout_synth", "32spp", "heldout0_0_32.exr")
        if len(files) != 48 or exr not in files:
            raise AssertionError(f"[tools-data] make_synthetic_datasets wrote {len(files)} EXRs")
        text = inspect.describe_exr(str(exr))
        disp = inspect.show_exr_channel(str(exr), "normal", save_path=str(Path(tmp, "n.png")))
        png = decode_png(Path(tmp, "n.png"))
        if png.shape != (size, size, 3) or not np.array_equal(png,
                                                              inspect.display_image(disp)):
            raise AssertionError(f"[tools-data] the normal display PNG {png.shape}")
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            resize_exrs.run(Path(tmp, "images_heldout_synth"))
        hdr = read_exr_header(exr)
        if (hdr["width"], hdr["height"]) != (size // 2, size // 2) or "Failed" in printed.getvalue():
            raise AssertionError(f"[tools-data] resize_exrs: {hdr}, {printed.getvalue()}")
        log(f"[tools-data] make_synthetic_datasets: {len(files)} EXRs at {size}²; inspect: "
            f"{text.splitlines()[:3]}, the normal display PNG decodes to the display image; "
            f"resize_exrs: the held-out tree at {hdr['width']}×{hdr['height']}")
    log(f"[tools] phase 16 {time.perf_counter() - t_phase:.2f} s; {smi}")


# phase 17: the quality campaign's legs 1, 2a/2b and 4 through its `run`,
# cut to 2 scenes of 256² a dataset directory, 100 patches an image and 1
# epoch (the validation split is a whole scene: at the configs' 400 / 200
# patches an image it took 22 s of the AFGSA leg's 50)
CAMPAIGN = dict(size=256, scenes=2, patches=100, epochs=1)
CAMPAIGN_OVERRIDES = [f"trainer.epochs={CAMPAIGN['epochs']}",
                      f"data.patches.num_patches={CAMPAIGN['patches']}"]
SCENE_FILE = re.compile(r"RMSE: (\S+)\nPSNR: (\S+)\n1-SSIM: (\S+)\n")


def phase_campaign(smi: str, tmp: str) -> None:
    """Phase 17: `tools.quality_campaign.run` on the card, under `tmp`,
    for legs 1, 2a and 4, then 1, 2b and 4 (CAMPAIGN): each train step and
    validation forward through its kernels on their prod bodies
    (`trainer_probe`, as phase 11), leg 4's evaluation files one a scene
    with finite metrics, leg 4's launches, and the summary line."""
    from pixel_heal_thyself_tpu_torch.tools import quality_campaign

    t_phase = time.perf_counter()
    served = quality_campaign.TRAIN_SCENES[:CAMPAIGN["scenes"]] + quality_campaign.HELDOUT_SCENES
    for leg in (leg for leg in quality_campaign.TRAINING if leg.name in ("2a", "2b")):
        tag = f"campaign-{leg.name}"
        kernels = TRAINER_KERNELS[leg.model]
        lines: list[str] = []
        reset_counts()
        with trainer_probe(*kernels) as rec, trainer_log():
            result = quality_campaign.run(
                tmp, legs=("1", leg.name, "4"), device="cuda", size=CAMPAIGN["size"],
                n_scenes=CAMPAIGN["scenes"],
                overrides=CAMPAIGN_OVERRIDES, log=lines.append)
        launches = read_counts()
        layers = 5
        for kind in ("train", "eval"):
            short = [(i, d) for i, d in enumerate(rec[kind])
                     if any(v < layers for v in d.values())]
            if short or not rec[kind]:
                raise AssertionError(f"[{tag}] {kind} calls with fewer than {layers} launches "
                                     f"of a kernel: {short[:3]} ({len(rec[kind])} calls)")
        check_bodies(tag, launches, quiet=True)
        summary = json.loads(lines[-1])
        if summary != json.loads(json.dumps(result)) or leg.name not in summary["legs"]:
            raise AssertionError(f"[{tag}] the summary line {lines[-1][:200]!r}")
        got = summary["legs"][leg.name]
        folder = Path(tmp, "reports", "port_r5_quality", leg.model)
        files = sorted(f.name for f in folder.glob("*_evaluation.txt"))
        if files != sorted(f"{s}_32_evaluation.txt" for s in served):
            raise AssertionError(f"[{tag}] leg 4 wrote {files}")
        for f in folder.glob("*_evaluation.txt"):
            m = SCENE_FILE.fullmatch(f.read_text())
            if not m or not all(math.isfinite(float(v)) for v in m.groups()):
                raise AssertionError(f"[{tag}] {f.name}: {f.read_text()!r}")
        serve_kernels = {"K1", "K2", "K3"} if leg.model == "afgsa" else {"K7"}
        by_name = {counters()[k].__name__: k for k in KERNEL_NAMES}
        served_k = {by_name[k] for k, v in got["serve_launches"].items() if v}
        if served_k != serve_kernels:
            raise AssertionError(f"[{tag}] leg 4 launched {got['serve_launches']}")
        if not all(math.isfinite(got[k]) for k in ("val_psnr", "val_1_ssim", "full_frame_psnr")):
            raise AssertionError(f"[{tag}] non-finite metrics {got}")
        log(f"[{tag}] {len(rec['train'])} train steps each launched ≥ {layers} of "
            f"{', '.join(kernels[0])}; {len(rec['eval'])} validation forwards each ≥ {layers} "
            f"of {', '.join(kernels[1])}, on the prod bodies; leg 4: {len(files)} scenes, "
            f"launches {got['serve_launches']}")
        log(f"[{tag}] val PSNR {got['val_psnr']} 1-SSIM {got['val_1_ssim']}, full-frame mean "
            f"PSNR {got['full_frame_psnr']:.4f}, held-out {got['heldout_psnr']}; epoch "
            f"{got['epoch_patches_per_sec']} patches/s, io {got['epoch_io_percent']}%, "
            f"validation {got['val_seconds']} s, peak memory {got['peak_memory_bytes']} B, "
            f"launches a step {got['launches_per_step']}, a validation batch "
            f"{got['launches_per_val_batch']}; leg {got['seconds']:.2f} s, leg 4 "
            f"{got['serve_seconds']:.2f} s; {smi}")
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False  # as main set them
    torch.backends.cudnn.allow_tf32 = False
    log(f"[campaign] phase 17 {time.perf_counter() - t_phase:.2f} s; {smi}")


# phase 18: the WGAN-GP critic's numerics on the card (`tools.critic_numerics`,
# under the trainer's bf16 arithmetic): the prod critic DiscriminatorVGG(128,
# 64) at the trainer's seeded init (parameter sum CRITIC_CHECKSUM), on 8 tiles
# of 128² of the campaign's first scene (`critic_numerics.scene_batch`), fake
# = the prod AFGSANet at its seeded init through its kernels, alpha from
# seed 990819. CRITIC_JAX is the JAX package's own bf16-vs-f32 deviation of
# the same D step on the CPU for the same critic and inputs (the inputs as
# `critic_numerics --save-inputs` wrote them on an NVIDIA H100 80GB HBM3 at
# 700.00 W; `python tests/torch_port_critic_yardstick.py INPUTS.npz`): the
# GP's input-gradient norms, mean relative error, and D's parameter
# gradient, rms relative error over all leaves.
CRITIC_JAX = {"gp_norm": 1.1378375407094e-02, "d_grad": 1.7238e-01}
CRITIC_CHECKSUM = 3836.401164807634
# the trainer's own critic (float32, TF32 products) read a GP-norm deviation
# of 1.1635e-3 in this phase on an NVIDIA H100 80GB HBM3 at 700.00 W, the
# bf16 critic 8.1129e-3: the trainer's critic is held within 3× its own
# reading, which the bf16 critic fails
CRITIC_TRAINER_GP = 3 * 1.1635e-03


def phase_critic(smi: str) -> None:
    """Phase 18: `critic_numerics.run` at the prod shapes on the critic
    the trainer builds (`AFGSATrainer.create_discriminator` at `-cn
    prod`), which must be float32 and keep the GP norms' mean relative
    deviation from the true-float32 critic within CRITIC_TRAINER_GP; the
    bf16 critic (the JAX package's choice) must keep its GP norms and D
    gradient within 2× CRITIC_JAX's."""
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.config.run_dirs import register_run_dirs_resolver
    from pixel_heal_thyself_tpu_torch.tools import critic_numerics
    from pixel_heal_thyself_tpu_torch.training.trainer import AFGSATrainer

    t_phase = time.perf_counter()
    register_run_dirs_resolver()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), determinism_kept():
        cfg = ConfigRegistry.create_config(compose(TRAINER_CONFIG, [f"paths.output_dir={tmp}"]))
        critic = AFGSATrainer(cfg, device="cuda").create_discriminator()
    torch.backends.cuda.matmul.allow_tf32 = False  # as main set them
    torch.backends.cudnn.allow_tf32 = False
    if critic.dtype != torch.float32:
        raise AssertionError(f"[critic] the trainer builds its critic in {critic.dtype}")
    result = critic_numerics.run(critic=critic, device="cuda", names=("trainer",),
                                 seed=cfg.seed, log=lambda _: None)
    checksum = result["critic"]["checksum"]
    if abs(checksum - CRITIC_CHECKSUM) > 1e-9 * abs(CRITIC_CHECKSUM):
        raise AssertionError(f"[critic] the seeded critic's parameter sum {checksum!r} is not "
                             f"the one CRITIC_JAX was measured for ({CRITIC_CHECKSUM!r})")
    rows = result["rows"]
    for name, row in (("trainer_critic", rows["trainer_critic"]), ("bf16", rows["trainer"])):
        gp, dg = row["gp_norm"]["mean_rel_err"], row["d_grad"]["overall"]
        log(f"[critic] {name}: GP norms mean rel {gp:.4e} (max {row['gp_norm']['max_rel_err']:.4e})"
            f", D grad rms rel {dg:.4e}, G grad rms rel {row['g_grad']:.4e}, d_loss rel "
            f"{row['losses']['d_loss']['rel_err']:.4e}; JAX bf16 on the CPU: GP norms "
            f"{CRITIC_JAX['gp_norm']:.4e}, D grad {CRITIC_JAX['d_grad']:.4e}")
    gp = rows["trainer_critic"]["gp_norm"]["mean_rel_err"]
    if not gp <= CRITIC_TRAINER_GP:
        raise AssertionError(f"[critic] the trainer's critic: GP norms {gp:.4e} beyond "
                             f"{CRITIC_TRAINER_GP:.4e}")
    gp, dg = rows["trainer"]["gp_norm"]["mean_rel_err"], rows["trainer"]["d_grad"]["overall"]
    if not (gp <= 2 * CRITIC_JAX["gp_norm"] and dg <= 2 * CRITIC_JAX["d_grad"]):
        raise AssertionError(f"[critic] bf16: GP norms {gp:.4e} or D grad {dg:.4e} beyond 2x "
                             "the JAX package's")
    log(f"[critic] the trainer's critic: {critic.dtype}, GP norms within "
        f"{CRITIC_TRAINER_GP:.4e}; repeat of the bf16 critic: D grad "
        f"{rows['repeat']['d_grad']['overall']:.4e}; phase 18 "
        f"{time.perf_counter() - t_phase:.2f} s; {smi}")


# phase 19: `tools.tpu_rounding` on phase 17's 2b checkpoint at its 2 scenes
# of 256². The replay rounds every product of the interior once to bf16,
# where K7 keeps them to 3×TF32 and rounds only its output to bf16: its
# frames must differ from K7's, and by no more than REPLAY_RMS_REL of their
# rms (5× the 4e-3 rms that phase 7 holds K7's frames to against the plain
# route).
REPLAY_RMS_REL = 2e-2


def phase_replay(smi: str, tmp: str) -> None:
    """Phase 19: the replay of the TPU kernel #5's bf16 products
    (`tpu_rounding.run`) on phase 17's 2b checkpoint under `tmp`, served
    over CAMPAIGN's 2 training scenes and validated both ways."""
    from pixel_heal_thyself_tpu_torch.tools import tpu_rounding

    t_phase = time.perf_counter()
    leg = json.loads(Path(tmp, "reports", "port_r5_quality", "legs", "2b.json").read_text())
    with determinism_kept():  # the tool's trainer sets them
        rec = tpu_rounding.run(Path(tmp, leg["checkpoint"]), "2b", tmp, CAMPAIGN_OVERRIDES,
                               "cuda", scenes=CAMPAIGN["scenes"], log=lambda _: None)
    k7, replay = rec["k7"], rec["replay"]
    name = counters()["K7"].__name__
    if not (k7["launches"].get(name, 0) > 0 and k7["replay_calls"] == 0):
        raise AssertionError(f"[replay] the K7 pass: launches {k7['launches']}, "
                             f"{k7['replay_calls']} replay calls")
    if not (name not in replay["launches"] and replay["replay_calls"] > 0):
        raise AssertionError(f"[replay] the replay pass: launches {replay['launches']}, "
                             f"{replay['replay_calls']} replay calls")
    psnrs = [*k7["scenes"].values(), *replay["scenes"].values(), k7["val_psnr"],
             replay["val_psnr"]]
    if len(k7["scenes"]) != CAMPAIGN["scenes"] or not all(map(math.isfinite, psnrs)):
        raise AssertionError(f"[replay] scenes or PSNRs: {k7['scenes']}, {replay['scenes']}")
    if not 0 < rec["frames_rms_rel"] <= REPLAY_RMS_REL:
        raise AssertionError(f"[replay] frames {rec['frames_rms_rel']:.4e} rms relative from "
                             f"K7's, not in (0, {REPLAY_RMS_REL}]")
    log(f"[replay] {CAMPAIGN['scenes']} scenes: K7 {k7['launches'][name]} launches, the replay "
        f"{replay['replay_calls']} calls; frames {rec['frames_rms_rel']:.4e} rms relative from "
        f"K7's (bound {REPLAY_RMS_REL}); served mean {k7['full_frame_psnr']:.4f} → "
        f"{replay['full_frame_psnr']:.4f} ({rec['delta']['full_frame_psnr']:+.4f} dB), "
        f"validation {k7['val_psnr']:.4f} → {replay['val_psnr']:.4f} "
        f"({rec['delta']['val_psnr']:+.4f} dB); phase 19 "
        f"{time.perf_counter() - t_phase:.2f} s; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the trainer set them; as main did
    torch.backends.cudnn.allow_tf32 = False


# phase 20: `trainer.deterministic` (the default) on the card. `train.main`
# at phase 11's config and cut (its patch store, synthetic 512² scenes, 100
# patches an image, batch 8 × 128², bf16, the kernels on, the float32
# critic), 1 epoch, each run in a fresh process; the runs of a pair
# repeat to the bit. The control pair trains with the determinism settings
# left at torch's defaults (`training.trainer.deterministic_algorithms`
# replaced by a no-op in its processes): the trainer as it ran before it
# set them. Three processes share the card at a time.
DETERMINISM = dict(epochs=1, parallel=3, blocks=4, steps=10, warmup=2)
DETERMINISM_RUNS = (("afgsa", True), ("afgsa", True), ("mamba", True), ("mamba", True),
                    ("afgsa", False), ("afgsa", False))
DETERMINISM_MAIN = """
import sys
import pixel_heal_thyself_tpu_torch.training.trainer as trainer
from pixel_heal_thyself_tpu_torch import _build, train
if sys.argv[1] == "defaults":
    trainer.deterministic_algorithms = lambda: None
_build.lib()
train.main(sys.argv[2:])
"""
WARNED_OP = re.compile(r"(\S+) does not have a deterministic implementation")


def determinism_runs(workdir: str) -> list[dict]:
    """DETERMINISM_RUNS in fresh processes in `workdir` (phase 11's), at
    most DETERMINISM["parallel"] at a time (the first alone when the patch
    store is not there yet): each run's directory, its output and its
    seconds."""
    repo = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    env["PYTHONPATH"] = str(repo)
    alone = not any(Path(workdir).glob("data/*/patches_*"))
    runs, running = [], []

    def finish(job):
        proc, rec, t0 = job
        if proc.wait(timeout=900) != 0:
            raise AssertionError(f"[determinism] {rec['model']} run {rec['run_num']} exited "
                                 f"{proc.returncode}:\n{Path(rec['log']).read_text()[-3000:]}")
        rec["seconds"] = time.perf_counter() - t0
        rec["output"] = Path(rec["log"]).read_text()

    for i, (model, deterministic) in enumerate(DETERMINISM_RUNS):
        if len(running) == DETERMINISM["parallel"] or (alone and i == 1):
            finish(running.pop(0))
        run_num = 20 + i
        rec = {"model": model, "deterministic": deterministic, "run_num": run_num,
               "log": str(Path(workdir, f"determinism_{run_num}.log"))}
        argv = (["-cn", TRAINER_CONFIG] + (["model=mamba"] if model == "mamba" else [])
                + TRAINER_ARGS + [f"trainer.epochs={DETERMINISM['epochs']}",
                                  f"run_num={run_num}"])
        with open(rec["log"], "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-c", DETERMINISM_MAIN,
                 "trainer" if deterministic else "defaults", *argv],
                stdout=out, stderr=subprocess.STDOUT, cwd=workdir, env=env)
        running.append((proc, rec, time.perf_counter()))
        runs.append(rec)
    for job in running:
        finish(job)
    for rec in runs:
        rec["dir"] = next(Path(workdir).glob(
            f"outputs/runs/{rec['model']}_*/run{rec['run_num']:03d}"))
    return runs


def same_run(a: Path, b: Path) -> dict:
    """Whether two run directories end equal: the last checkpoint's G, D
    and Adam states (`checkpoints.digest`), and `train_loss.txt` and
    `evaluation.txt` byte for byte."""
    from pixel_heal_thyself_tpu_torch.training import checkpoints

    ckpt = f"model_epoch{DETERMINISM['epochs']}/state"
    da, db = checkpoints.digest(a / ckpt), checkpoints.digest(b / ckpt)
    out = {part: da[part] == db[part] for part in da}
    for name in ("train_loss.txt", "evaluation.txt"):
        out[name] = (a / name).read_bytes() == (b / name).read_bytes()
    return out


def step_cost(device, smi: str) -> dict:
    """The prod GAN step of each generator (phases 5 and 8: batch 8 ×
    128², the float32 critic, TF32 on) under the trainer's determinism
    settings and under torch's defaults, in DETERMINISM["blocks"] blocks of
    DETERMINISM["steps"] timed steps (defaults, trainer, trainer,
    defaults; each block after DETERMINISM["warmup"] steps): the median
    seconds a step of each setting and the ops warned of. cuBLAS's
    workspace stays as the process made it."""
    import warnings

    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs
    from pixel_heal_thyself_tpu_torch.models.discriminators import GP_CRITIC_DTYPE
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet, mamba_prod_kwargs
    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import (
        arithmetic,
        switches_now,
        trainer_setting,
    )
    from pixel_heal_thyself_tpu_torch.training.trainer import deterministic_algorithms

    with arithmetic(switches_now()):
        deterministic_algorithms()
        trainer = {**switches_now(), "tf32": True}
    settings = {"torch defaults": trainer_setting(), "trainer": trainer}
    order = ("torch defaults", "trainer", "trainer", "torch defaults")[:DETERMINISM["blocks"]]
    out = {}
    for name, net, kwargs in (("afgsa", AFGSANet, afgsa_prod_kwargs()),
                              ("mamba", MambaDenoiserNet, mamba_prod_kwargs())):
        g, d, data = _train_state(device, GP_CRITIC_DTYPE, kwargs, TRAIN["patch"], TRAIN["batch"],
                                  seed=0, net=net)
        step = make_step(g, d)
        gen = torch.Generator(device=device).manual_seed(7)
        secs = {k: [] for k in settings}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for setting in order:
                with arithmetic(settings[setting]):
                    for i in range(DETERMINISM["warmup"] + DETERMINISM["steps"]):
                        t0 = time.perf_counter()
                        step(data, generator=gen)["d_loss"].item()
                        if i >= DETERMINISM["warmup"]:
                            secs[setting].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in secs.items()}
        ops = sorted({m[1] for w in caught for m in [WARNED_OP.search(str(w.message))] if m})
        out[name] = {"median_s": med, "cost": med["trainer"] / med["torch defaults"] - 1,
                     "steps": {k: len(v) for k, v in secs.items()}, "warned_ops": ops}
        log(f"[determinism] {name} prod GAN step (batch {TRAIN['batch']} × {TRAIN['patch']}², "
            f"float32 critic, TF32 on): median {med['trainer']:.5f} s with the trainer's "
            f"determinism settings {settings['trainer']}, {med['torch defaults']:.5f} s with "
            f"torch's defaults ({len(secs['trainer'])} steps each, blocks {order}): "
            f"{out[name]['cost'] * 100:+.2f}%; ops warned of {ops}; {smi}")
        del g, d, data, step
        torch.cuda.empty_cache()
    return out


def phase_determinism(device, smi: str, workdir: str) -> None:
    """Phase 20: `trainer.deterministic` on the card. In `workdir`
    (phase 11's, with its patch store), `train.main -cn prod` twice and
    `-cn prod model=mamba` twice, 1 epoch each, each in a fresh process:
    each pair's last checkpoint (G, D, both Adam states) equal to the bit
    and its text files byte-equal. Prints the ops torch warned of, one
    control pair with torch's default settings (equal or not; not a
    condition), each generator's step-time cost of the settings
    (`step_cost`) and the phase's seconds."""
    t_phase = time.perf_counter()
    runs = determinism_runs(workdir)
    warned = sorted({m[1] for rec in runs if rec["deterministic"]
                     for m in WARNED_OP.finditer(rec["output"])})
    for a, b in zip(runs[::2], runs[1::2]):
        same = same_run(a["dir"], b["dir"])
        label = (f"{a['model']}, the trainer's settings" if a["deterministic"]
                 else f"{a['model']}, control with torch's defaults")
        log(f"[determinism] {label}: runs {a['run_num']} and {b['run_num']} "
            f"({a['seconds']:.1f} s, {b['seconds']:.1f} s) equal: {same}")
        if a["deterministic"] and not all(same.values()):
            raise AssertionError(f"[determinism] {label}: two runs differ: {same}")
    log(f"[determinism] ops torch warned of under warn_only in the trainer's runs: {warned}")
    step_cost(device, smi)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main set them
    torch.backends.cudnn.allow_tf32 = False
    log(f"[determinism] phase 20 {time.perf_counter() - t_phase:.2f} s; {smi}")


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
    rates = {"afgsa": afgsa_rate, "mamba": mamba_rate}
    with tempfile.TemporaryDirectory() as trainer_dir:
        phase_trainer(device, frames[0], rates, smi, trainer_dir)
        phase_gan_steps(device, frames[0], training, mamba_training, smi)
        phase_gan_trainer(smi)
        phase_export(device, frames, smi)
        phase_sharded(device, frames[0], smi)
        phase_dp_training(device, smi)
        phase_tools(device, rates, smi)
        with tempfile.TemporaryDirectory() as tmp:
            phase_campaign(smi, tmp)
            phase_critic(smi)
            phase_replay(smi, tmp)
        phase_determinism(device, smi, trainer_dir)
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

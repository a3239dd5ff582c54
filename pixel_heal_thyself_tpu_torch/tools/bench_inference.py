"""Benchmark full-frame tiled inference: seconds per frame and Mpix/s.

Port of the JAX package's `tools/bench_inference.py`. The serving path
runs the generator over overlapping tiles of a whole frame (720p by
default). Two levers are measured:

1. **Tile geometry.** Tile 64 + margin 32 (the training-parity default)
   computes each output pixel 4× ((128/64)²); tile 96 + margin 16 and
   tile 112 + margin 8 keep the same 128² window (the same kernel shapes)
   and cut the windows 2.1× and 2.9×. Whether the smaller margin still
   covers the receptive field is measured: the same frame with the same
   weights under each geometry, and the seam PSNR of its output against
   tile 64's (`consistency_psnr_vs_m32`; equal interiors, so any
   difference is lost boundary context).
2. **Dispatch.** The default (`denoise_frame`) queues every tile batch's
   copy and launches, then copies the outputs back. `--sync` copies each
   batch's output to the host before the next batch is dispatched.
   `--fused` keeps the frame on the device (`make_fused_frame_apply`: edge
   padding, window gathers and stitching there).

Every timed frame is a fresh random frame, made before the clock starts
(the JAX tool's clock also takes in drawing the frame's 9.2 M random
values, about 0.1–0.2 s at 720p). Times are host clock around a frame,
which ends in a copy to the host; the first frame of each geometry (kernel
library load, allocator warm-up) is not timed.

    python -m pixel_heal_thyself_tpu_torch.tools.bench_inference \
        [--model afgsa|mamba] [--height 720 --width 1280] [--iters 3] \
        [--sync | --fused] [--device cuda|cpu]

On the card by default (prod width, bf16, seeded weights, num_gcp 0);
`--device cpu` runs the same on the CPU through the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# every geometry keeps the 128² window: tile + 2 · margin
GEOMETRIES = ((64, 32), (96, 16), (112, 8))
BATCH_TILES = 8
VARIANTS = ("pipelined", "sync", "fused")


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    peak = float(max(a.max(), b.max(), 1e-8))
    return 10.0 * np.log10(peak * peak / mse)


def make_frame(seed: int, h: int, w: int) -> dict[str, np.ndarray]:
    r = np.random.default_rng(seed)
    return {
        "noisy": np.abs(r.standard_normal((h, w, 3))).astype(np.float32),
        "aux": r.standard_normal((h, w, 7)).astype(np.float32),
    }


def frame_fn(apply_fn, hw: tuple[int, int], tile: int, margin: int, variant: str, device):
    """`data -> denoised [H, W, 3]` through `variant`'s dispatch."""
    from pixel_heal_thyself_tpu_torch.inference import (
        denoise_frame,
        denoise_frame_fused,
        make_fused_frame_apply,
    )

    if variant == "fused":
        fused = make_fused_frame_apply(apply_fn, hw, tile=tile, margin=margin,
                                       batch_tiles=BATCH_TILES, device=device)
        return lambda data: denoise_frame_fused(fused, data, device=device)
    if variant == "sync":
        # each batch's output on the host before the next batch is dispatched
        def apply(noisy, aux):
            return apply_fn(noisy, aux).float().cpu()
    elif variant == "pipelined":
        apply = apply_fn
    else:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    return lambda data: denoise_frame(apply, data, tile=tile, margin=margin,
                                      batch_tiles=BATCH_TILES, device=device)


def run(apply_fn, height: int = 720, width: int = 1280, iters: int = 3,
        variant: str = "pipelined", geometries=GEOMETRIES, device="cuda",
        log=print) -> tuple[list[dict], dict]:
    """Time `apply_fn` (a generator, or any `(noisy, aux) -> out` on
    `device`) over `iters` fresh frames per geometry after one untimed
    frame, the same first frame for every geometry. Returns (one result
    dict per geometry, that first frame's output per (tile, margin)),
    printing each result as a JSON line through `log`."""
    device = torch.device(device)
    h, w = height, width
    frame0 = make_frame(1, h, w)
    outputs, results = {}, []
    for tile, margin in geometries:
        run_frame = frame_fn(apply_fn, (h, w), tile, margin, variant, device)
        out = run_frame(frame0)
        outputs[(tile, margin)] = out
        frames = [make_frame(10 + i, h, w) for i in range(iters)]
        t0 = time.perf_counter()
        for data in frames:
            run_frame(data)
        dt = (time.perf_counter() - t0) / iters
        seam = None if (tile, margin) == tuple(geometries[0]) else psnr(
            out, outputs[tuple(geometries[0])])
        results.append({
            "tile": tile, "margin": margin, "sec_per_frame": dt,
            "mpix_per_sec": h * w / dt / 1e6,
            "consistency_psnr_vs_m32": None if seam == float("inf") else seam,
        })
        log(json.dumps(results[-1]))
    return results, outputs


def main(argv=None) -> dict:
    from pixel_heal_thyself_tpu_torch.tools import card_line, prod_generator, resolve_device

    ap = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.bench_inference")
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--model", choices=["afgsa", "mamba"], default="afgsa")
    ap.add_argument("--fused", action="store_true",
                    help="keep each frame on the device (make_fused_frame_apply)")
    ap.add_argument("--sync", action="store_true",
                    help="copy each tile batch's output to the host before dispatching the "
                         "next")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.sync and args.fused:
        ap.error("--sync copies each host tile batch back, but --fused never leaves the "
                 "device between batches; pick one")
    device = resolve_device(args.device, "bench_inference")
    card = card_line(device)
    if card:
        print(card, flush=True)
    model = prod_generator(args.model, device).eval()
    variant = "sync" if args.sync else "fused" if args.fused else "pipelined"
    results, _ = run(model, args.height, args.width, args.iters, variant, device=device,
                     log=lambda s: print(s, flush=True))
    summary = {"model": args.model, "frame": [args.height, args.width], "sync": args.sync,
               "fused": args.fused, "backend": device.type, "card": card, "results": results}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

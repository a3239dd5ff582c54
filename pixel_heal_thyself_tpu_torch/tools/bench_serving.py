"""Serving evidence on the card: export the prod AFGSA generator and time
the artifact against the live model.

Port of the JAX package's `tools/bench_serving.py`:

1. builds the prod AFGSANet (bf16, kernels on, seeded weights) and exports
   it through `serving.export_denoiser` (`platforms=("cuda",)`, window 128,
   8 tiles a batch); reports the artifact's bytes and the export seconds,
   and the `pht::` ops in the saved graph (`ops.library.graph_ops`), each
   beside its calls in one live forward: where the JAX tool looks for the
   Mosaic `tpu_custom_call` in the StableHLO, these ops are the kernels
   that survived the export;
2. loads the artifact back (`serving.load_exported`, timed);
3. times tiled full-frame inference (`inference.denoise_frame`, 720p,
   tile 64 + margin 32, a fresh random frame each, made before the clock
   starts) through the exported `apply_fn` and through the live model:
   first call and steady s/frame, their ratio, and the largest difference
   between the two frames.

    python -m pixel_heal_thyself_tpu_torch.tools.bench_serving \
        [--frames 3] [--height 720 --width 1280] [--out-dir D] [--device cuda|cpu]

On the card by default; `--device cpu` exports and serves a `("cpu",)`
artifact through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

WINDOW, BATCH_TILES = 128, 8
TILE, MARGIN = 64, 32  # the training-parity geometry: tile + 2·margin = window


def live_ops(model, noisy: torch.Tensor, aux: torch.Tensor) -> dict[str, int]:
    """Calls of each `pht::` op (the functions of `ops/library.py`) in one
    no-grad forward of `model`."""
    from pixel_heal_thyself_tpu_torch.ops import library

    saved = {name: fn for name, fn in vars(library).items() if hasattr(fn, "op")}
    counts: dict[str, int] = {}

    def counting(name, fn):
        def call(*args):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args)
        return call

    for name, fn in saved.items():
        setattr(library, name, counting(name, fn))
    try:
        with torch.no_grad():
            model(noisy, aux)
    finally:
        for name, fn in saved.items():
            setattr(library, name, fn)
    return counts


def run(model, out_dir: str, frames: int = 3, height: int = 720, width: int = 1280,
        device="cuda", log=print) -> tuple[dict, dict]:
    """Export `model` (its parameters on `device`) into `out_dir`, load it
    back and time both through `denoise_frame`. Returns (the JSON result,
    the last frame of each: {"live", "exported"})."""
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame
    from pixel_heal_thyself_tpu_torch.ops.library import graph_ops
    from pixel_heal_thyself_tpu_torch.serving import MODULE_FILE, export_denoiser, load_exported
    from pixel_heal_thyself_tpu_torch.tools.bench_inference import make_frame

    device = torch.device(device)
    zeros = (torch.zeros(BATCH_TILES, WINDOW, WINDOW, 3, device=device),
             torch.zeros(BATCH_TILES, WINDOW, WINDOW, 7, device=device))
    live = live_ops(model, *zeros)
    t0 = time.perf_counter()
    export_denoiser(model, out_dir, window=WINDOW, batch_tiles=BATCH_TILES,
                    platforms=(device.type,), model_name=f"{type(model).__name__}-prod-bench")
    export_s = time.perf_counter() - t0
    blob = os.path.join(out_dir, MODULE_FILE)
    t0 = time.perf_counter()
    exported_fn, manifest = load_exported(out_dir, device=device)
    load_s = time.perf_counter() - t0
    in_graph = graph_ops(torch.export.load(blob).graph)

    def time_frames(apply_fn, tag: str) -> tuple[float, float, np.ndarray]:
        first = make_frame(100, height, width)
        t0 = time.perf_counter()
        out = denoise_frame(apply_fn, first, tile=TILE, margin=MARGIN, batch_tiles=BATCH_TILES,
                            device=device)
        first_s = time.perf_counter() - t0
        data = [make_frame(101 + i, height, width) for i in range(frames)]
        t0 = time.perf_counter()
        for frame in data:
            out = denoise_frame(apply_fn, frame, tile=TILE, margin=MARGIN,
                                batch_tiles=BATCH_TILES, device=device)
        steady = (time.perf_counter() - t0) / frames
        log(f"{tag:10s} first call {first_s:.4f} s   steady {steady:.4f} s/frame")
        return first_s, steady, out

    live_first, live_s, live_out = time_frames(model, "live")
    exp_first, exp_s, exp_out = time_frames(exported_fn, "exported")
    result = {
        "artifact_bytes": os.path.getsize(blob),
        "artifact_mb": os.path.getsize(blob) / 1e6,
        "export_s": export_s,
        "load_s": load_s,
        "pht_ops_in_artifact": in_graph,
        "pht_ops_in_live_forward": live,
        "live_ops_all_in_artifact": all(in_graph.get(op, 0) == n for op, n in live.items()),
        "platforms": manifest["platforms"],
        "live_first_s": live_first,
        "exported_first_s": exp_first,
        "live_s_per_frame": live_s,
        "exported_s_per_frame": exp_s,
        "exported_vs_live": exp_s / live_s,
        "max_abs_delta": float(np.max(np.abs(live_out - exp_out))),
        "geometry": f"{height}x{width} tile{TILE} margin{MARGIN}",
    }
    return result, {"live": live_out, "exported": exp_out}


def main(argv=None) -> dict:
    from pixel_heal_thyself_tpu_torch.tools import card_line, prod_generator, resolve_device

    ap = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.bench_serving")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--out-dir", default=None, help="artifact dir (default: a temporary one)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "bench_serving")
    card = card_line(device)
    if card:
        print(card, flush=True)
    model = prod_generator("afgsa", device).eval()
    with tempfile.TemporaryDirectory(prefix="pht_export_") as tmp:
        result, _ = run(model, args.out_dir or tmp, args.frames, args.height, args.width,
                        device, log=lambda s: print(s, flush=True))
    result["card"] = card
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

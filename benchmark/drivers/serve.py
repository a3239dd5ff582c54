"""Serving traffic: frames denoised one after another (a closed loop).

The mix file gives the frame size, the pool of distinct frames made from
the seed and cycled, the tiler's tile, margin and batch, how many frames
set-up serves, and, for `--trace 1`, where the traced stretch starts and
how many frames it covers. Each frame is timed on the host clock from the
call to the returned numpy frame. After the window a sample of the served
frames, drawn from the seed, is held against the plain reference.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import counts, program, reference, scenes, weights
from benchmark.reference.frames import denoise_frame
from benchmark.reference.nn import Arith, no_tf32
from benchmark.trace import Schedule, maybe_span as _maybe, span


def make_frames(cell, device) -> list:
    """The pool of frames as the program is handed them: host float32
    {"noisy" [H,W,3], "aux" [H,W,C]}."""
    t = cell.traffic
    h, w = t["frame"]
    sc = scenes.scenes(weights.stream(cell.seed, weights.FRAMES, device), t["pool"], h, w, device,
                       spp=t["spp"], gt_spp=None, noise_scale=t["noise_scale"],
                       hdr_scale=t["hdr_scale"])
    noisy, aux = sc["noisy"].cpu().numpy(), sc["aux"].cpu().numpy()
    return [{"noisy": noisy[i], "aux": aux[i]} for i in range(t["pool"])]


def generator_state(cell, device) -> dict:
    with torch.device("meta"):
        meta = reference.generator(cell.config, "meta")
    return weights.model_state(meta, weights.stream(cell.seed, weights.GENERATOR, device), device)


def sample(cell, served: int) -> list:
    """The indices of the served frames the comparison reads."""
    rng = np.random.default_rng(weights.subseed(cell.seed, weights.SAMPLE))
    k = min(cell.traffic["sample"], served)
    return sorted(int(i) for i in rng.choice(served, size=k, replace=False))


def reference_frames(cell, frames: list, pool_ids: list, arith: Arith, device,
                     model_fault=None) -> dict:
    """{pool index: the reference's linear frame (numpy)} in `arith`;
    `model_fault(model)` returns a broken stand-in for the model."""
    t = cell.traffic
    model = reference.generator(cell.config, device)
    model.load_state_dict(generator_state(cell, device))
    if model_fault is not None:
        model = model_fault(model)
    out = {}
    with no_tf32():
        for i in sorted(set(pool_ids)):
            f = frames[i]
            out[i] = denoise_frame(model, torch.from_numpy(f["noisy"]).to(device),
                                   torch.from_numpy(f["aux"]).to(device), tile=t["tile"],
                                   margin=t["margin"], batch=t["batch"], arith=arith
                                   ).cpu().numpy()
    return out


def compare(outputs: dict, refs: dict, frames: list, tile: int) -> dict:
    """The numbers compared, over served frames {served index: (pool index,
    frame)}, each the worst frame's: the rms gap to the reference over the
    frame, and over its worst tile, both relative to the rms of the
    reference frame."""
    frame_gap = tile_gap = 0.0
    for pool, out in outputs.values():
        ref = refs[pool].astype(np.float64)
        scale = np.sqrt(np.mean(ref ** 2))
        err = (out.astype(np.float64) - ref) ** 2
        frame_gap = max(frame_gap, float(np.sqrt(err.mean()) / scale))
        h, w, c = err.shape
        ht, wt = -(-h // tile), -(-w // tile)
        padded = np.zeros((ht * tile, wt * tile, c))
        padded[:h, :w] = err
        tiles = padded.reshape(ht, tile, wt, tile, c).mean(axis=(1, 3, 4))
        tile_gap = max(tile_gap, float(np.sqrt(tiles.max()) / scale))
    return {"frame_rel_rms": frame_gap, "tile_rel_rms": tile_gap}


def detail(outputs: dict, refs: dict, frames: list) -> dict:
    """Per compared frame: the rms of the reference's correction (ref −
    noisy), of the reference itself, and of the gap."""
    rows = []
    for pool, out in outputs.values():
        ref = refs[pool].astype(np.float64)
        rms = {"correction_rms": ref - frames[pool]["noisy"], "ref_rms": ref,
               "gap_rms": out.astype(np.float64) - ref}
        rows.append({k: float(np.sqrt(np.mean(v ** 2))) for k, v in rms.items()})
    return {"frames": rows}


class BlockSpans:
    """Forward hooks on `model.blocks`: a harness span (it names the host's
    idle gaps) and CUDA events from the first block's entry to the last
    block's exit, per call. The events time the blocks: the profiler's
    attribution of kernels to the span by their launch read more than the
    events around the same calls (150 against 123 ms over two 512² frames on
    an H100), which serial kernels cannot."""

    def __init__(self, model) -> None:
        blocks = model.blocks
        self.events, self.range = [], None
        self.handles = [blocks[0].register_forward_pre_hook(self._enter),
                        blocks[-1].register_forward_hook(self._exit)]

    def _enter(self, *_):
        self.range = span("bench.blocks")
        self.range.__enter__()
        if torch.cuda.is_available():
            self.events.append([torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)])
            self.events[-1][0].record()

    def _exit(self, *_):
        if self.events:
            self.events[-1][1].record()
        self.range.__exit__(None, None, None)

    def close(self) -> None:
        for h in self.handles:
            h.remove()

    def events_s(self) -> float:
        """The CUDA events' seconds over the calls (0 with no card)."""
        if not self.events:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) * 1e-3


def setup(cell):
    """(model, frame pool, serve) of the program, warmed up on the cell's
    frames."""
    t, device = cell.traffic, cell.device
    cfg = program.config(cell.config, weights.subseed(cell.seed, 0))
    model = program.serving_model(cfg, generator_state(cell, device), device)
    frames = make_frames(cell, device)
    serve = program.frame_server(model, tuple(t["frame"]), t["tile"], t["margin"], t["batch"],
                                 device)
    for i in range(t["warmup_frames"]):
        serve(frames[i % t["pool"]])
    return model, frames, serve


def run(cell) -> dict:
    t, device = cell.traffic, cell.device
    model, frames, serve = setup(cell)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - cell.t0

    spans = []
    sched = Schedule(cell.trace, t["trace_after"], t["trace_items"], t["attrib_items"],
                     hooks=lambda: spans.append(BlockSpans(model)) or spans[-1])
    outputs, lats = [], []
    start = time.perf_counter()
    while time.perf_counter() - start < cell.seconds:
        i = len(outputs)
        sched.before(i)
        t0 = time.perf_counter()
        with _maybe("bench.frame", sched.active is not None and sched.active is sched.attrib):
            outputs.append(serve(frames[i % t["pool"]]))
        lats.append(time.perf_counter() - t0)
        sched.after(i)
    sched.finish()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    readings, trace = {"kind": "serve"}, None
    if cell.trace:
        trace = sched.readings(len(outputs), window_s)
        w = cell.config["widths"]
        windows = counts.frame_windows(tuple(t["frame"]), t["tile"])
        pixels = windows * (t["tile"] + 2 * t["margin"]) ** 2
        # the blocks' least time over the windows a frame needs
        bound = w["num_blocks"] * counts.bound_s(counts.block_fwd_flops(w, pixels),
                                                 counts.block_bytes(w, pixels, False))
        readings.update(
            trace=trace, items_per_s=sched.rate(len(outputs), window_s),
            flops_per_item=windows * counts.g_fwd_flops(w, t["tile"] + 2 * t["margin"]),
            blocks={"bound_s": sched.attrib_items(len(outputs)) * bound,
                    "device_s": spans[0].events_s() if spans else 0.0})
    del serve, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    picked = sample(cell, len(outputs))
    pool_of = {i: i % t["pool"] for i in picked}
    refs = reference_frames(cell, frames, list(pool_of.values()), Arith("f32"), device)
    checks = compare({i: (pool_of[i], outputs[i]) for i in picked}, refs, frames, t["tile"])
    failed = sum(not np.isfinite(o).all() for o in outputs)
    lat_ms = np.array(lats) * 1e3
    return {
        "setup_s": setup_s, "attempted": len(outputs), "failed": int(failed),
        "end_to_end": {"frames_per_s": len(outputs) / window_s,
                       "frame_p90_ms": float(np.percentile(lat_ms, 90)),
                       "peak_mem_gib": peak / 2**30},
        "memory_peak_bytes": peak, "checks": checks, "readings": readings, "trace": trace,
    }

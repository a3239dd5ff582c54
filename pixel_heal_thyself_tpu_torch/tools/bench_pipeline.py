"""Split the GAN train step's input pipeline into its stages.

Port of the JAX package's `tools/bench_pipeline.py`. The prod AFGSA step
(`training.train_step.make_train_step`, WGAN-GP + L1 against
DiscriminatorVGG, bf16, batch 8 × 128²) is fed its batches seven ways:

  resident        every batch already on the device (no input traffic:
                  the upper bound)
  upload_sync     each batch copied to the device and waited for on the
                  host before the step is launched: the copy on the
                  critical path
  upload_async    the next batch's copy queued one step ahead on a side
                  stream, never waited for on the host (the
                  `PrefetchLoader` pattern)
  upload_eager    like upload_async, but the host waits for each copy as
                  soon as it is queued
  upload_fused    one packed [b, p, p, 13] tensor a step instead of three
                  (split into noisy / gt / aux on the device), queued one
                  step ahead and waited for as in upload_eager
  upload_deep     packed copies four in flight
  resident_gather the whole patch store on the device; each step sends
                  only the batch's indices and gathers the batch there
                  (`data.dataset.DeviceLoader`)

The CUDA counterparts of the JAX puts: host batches are pinned tensors,
copied `non_blocking` on a side stream; the step's stream waits for its
batch's copy (an event recorded after the copy: a `wait_stream` on the
side stream would also wait for the later batches queued behind it), and
each copied tensor is `record_stream`ed on the consuming stream so that the
caching allocator does not hand its memory to a later copy while the
step still reads it. A `non_blocking` copy from pageable memory does not
overlap with compute, so every upload is from pinned memory.

Every mode starts from the same model state (the state after the
warm-up), a fresh step (Adam and schedule) and the same GP mix `alpha`,
and consumes the same batches in the same order, so the modes compute
the same losses. Patches/s is host clock over the mode's steps, ending in
a copy of the last loss to the host.

    python -m pixel_heal_thyself_tpu_torch.tools.bench_pipeline \
        [--iters 20] [--batch 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MODES = ("resident", "upload_sync", "upload_async", "upload_eager", "upload_fused",
         "upload_deep", "resident_gather")
KEYS = ("noisy", "gt", "aux")
SPLITS = (3, 3, 7)  # channels of each key in a packed batch
DEEP = 4  # packed copies in flight in upload_deep
WARMUP = 2


def host_batches(n: int, b: int, p: int, seed: int = 0) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [{
        "noisy": np.abs(rng.standard_normal((b, p, p, 3))).astype(np.float32),
        "gt": np.abs(rng.standard_normal((b, p, p, 3))).astype(np.float32),
        "aux": rng.standard_normal((b, p, p, 7)).astype(np.float32),
    } for _ in range(n)]


def pack(batch: dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate([batch[k] for k in KEYS], axis=-1)


def unpack(wire: torch.Tensor) -> dict[str, torch.Tensor]:
    """A packed [b, p, p, 13] batch split on its device."""
    return {k: t.contiguous() for k, t in zip(KEYS, torch.split(wire, SPLITS, dim=-1))}


class Uploader:
    """Host → device copies on a side stream (a card), or none (the CPU)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def host(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(array)
        return t.pin_memory() if self.cuda else t

    def put(self, tensors: dict) -> tuple[dict, object]:
        """Queue the copies; returns (device tensors, the copies' event)."""
        if not self.cuda:
            return dict(tensors), None
        with torch.cuda.stream(self.stream):
            out = {k: v.to(self.device, non_blocking=True) for k, v in tensors.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def block(self, pending: tuple[dict, object]) -> None:
        """Wait on the host until `pending`'s copies are done."""
        if pending[1] is not None:
            pending[1].synchronize()

    def take(self, pending: tuple[dict, object]) -> dict:
        """`pending`'s tensors for the current stream, after their copies."""
        tensors, event = pending
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors


def _store_loader(batches: list[dict[str, np.ndarray]], tmp: str, device):
    """`DeviceLoader` over a store of `batches` (a `PatchDataset` split in
    `tmp`), unshuffled: its batches are `batches`, in order."""
    from pixel_heal_thyself_tpu_torch.data.dataset import DeviceLoader, PatchDataset

    for k in KEYS:
        np.save(Path(tmp) / f"{k}.npy", np.concatenate([hb[k] for hb in batches]))
    dataset = PatchDataset(tmp, cache_in_ram=True)
    return DeviceLoader(dataset, len(batches[0]["noisy"]), shuffle=False, device=device)


def run(g, d, batches: list[dict[str, np.ndarray]], device="cuda", probe=None,
        log=print) -> dict:
    """Train `g` against `d` (on `device`) through each of MODES, every
    mode over all of `batches`, after WARMUP steps. `probe(mode)`, a context manager factory,
    is entered around each mode's steps. Returns {mode: {"patches_per_sec",
    "losses": [g_loss per step]}}; the models end in the last mode's state."""
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    device = torch.device(device)
    up = Uploader(device)
    b = len(batches[0]["noisy"])
    spec = make_optimizer(1e-4, [2], 0.5, 100)
    alpha = torch.rand(b, 1, 1, 1, generator=torch.Generator().manual_seed(7)).to(device)
    host = [{k: up.host(v) for k, v in hb.items()} for hb in batches]
    packed = [up.host(pack(hb)) for hb in batches]

    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    for _ in range(WARMUP):  # allocator, cuDNN and kernel library warm-up
        step(up.take(up.put(host[0])), alpha=alpha)["g_loss"].item()
    state = copy.deepcopy((g.state_dict(), d.state_dict()))

    def resident(step):
        dev = [up.take(up.put(hb)) for hb in host]
        t0 = time.perf_counter()
        return t0, [step(db, alpha=alpha) for db in dev]

    def upload_sync(step):
        t0, out = time.perf_counter(), []
        for hb in host:
            pending = up.put(hb)
            up.block(pending)
            out.append(step(up.take(pending), alpha=alpha))
        return t0, out

    def ahead(step, wire: bool, eager: bool, depth: int = 1):
        src = packed if wire else host
        t0, out = time.perf_counter(), []
        inflight = []
        for i in range(min(depth, len(src))):
            inflight.append(up.put({"wire": src[i]} if wire else src[i]))
            if eager:
                up.block(inflight[-1])
        for i in range(len(src)):
            pending = inflight.pop(0)
            if i + depth < len(src):  # the next copy, queued before this step
                inflight.append(up.put({"wire": src[i + depth]} if wire else src[i + depth]))
                if eager:
                    up.block(inflight[-1])
            tensors = up.take(pending)
            out.append(step(unpack(tensors["wire"]) if wire else tensors, alpha=alpha))
        return t0, out

    def gather(step, loader):
        t0 = time.perf_counter()
        return t0, [step(db, alpha=alpha) for db in loader]

    results = {}
    with tempfile.TemporaryDirectory(prefix="pht_pipeline_") as tmp:
        loader = _store_loader(batches, tmp, device)
        runs = {
            "resident": resident,
            "upload_sync": upload_sync,
            "upload_async": lambda s: ahead(s, wire=False, eager=False),
            "upload_eager": lambda s: ahead(s, wire=False, eager=True),
            "upload_fused": lambda s: ahead(s, wire=True, eager=True),
            "upload_deep": lambda s: ahead(s, wire=True, eager=False, depth=DEEP),
            "resident_gather": lambda s: gather(s, loader),
        }
        for mode in MODES:
            g.load_state_dict(state[0])
            d.load_state_dict(state[1])
            step = make_train_step(g, d, LossesConfig(), False, spec, spec)
            with probe(mode) if probe else contextlib.nullcontext():
                t0, metrics = runs[mode](step)
                metrics[-1]["g_loss"].item()
                elapsed = time.perf_counter() - t0
            results[mode] = {"patches_per_sec": b * len(batches) / elapsed,
                             "losses": [m["g_loss"].item() for m in metrics]}
            log(f"{mode:16s} {results[mode]['patches_per_sec']:9.3f} patches/sec")
    return results


def main(argv=None) -> dict:
    from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG
    from pixel_heal_thyself_tpu_torch.tools import card_line, prod_generator, resolve_device, seeded

    ap = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.bench_pipeline")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "bench_pipeline")
    card = card_line(device)
    if card:
        print(card, flush=True)
    p = 128
    g = prod_generator("afgsa", device).train()
    d = seeded(DiscriminatorVGG, dict(in_nc=3, base_nf=64, input_size=p, dtype=torch.bfloat16),
               device, seed=1).train()
    batches = host_batches(args.iters, args.batch, p)
    res = run(g, d, batches, device, log=lambda s: print(s, flush=True))
    out = {mode: r["patches_per_sec"] for mode, r in res.items()}
    out["batch_mb"] = sum(a.nbytes for a in batches[0].values()) / 1e6
    out["finite"] = all(np.isfinite(r["losses"]).all() for r in res.values())
    out["card"] = card
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

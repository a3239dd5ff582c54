"""The round-5 quality campaign on the port: train both denoisers for 12
epochs through the hand kernels, serve them over every scene, and hold the
results against round 5's.

Port of the JAX package's `tools/r5_quality_campaign.sh`, with its legs:

  1   the synthetic datasets (`data/synthetic.generate_dataset`, the
      script's scenes, 512² frames, noise_scale and seeds): the clean05
      channel (noise_scale 0.5) and the clean channel (0.75), each a
      training directory of 10 scenes and a held-out one of 2; a directory
      that exists is kept
  2a  `train -cn prod model.num_gradient_checkpoints=0` (AFGSA) on clean05
  2b  `train -cn stag model=mamba` on clean05
  3   `train -cn stag model=mamba` on the 0.75 channel
  4   `inference` with the last checkpoint of 2a (`-cn prod`) and of 2b
      (`-cn stag model=mamba`) over clean05's training and held-out scenes,
      one `<scene>_32_evaluation.txt` each
  2a-d32, 2a-d16, 2a-abc, 2b-d16
      diagnostic variants of 2a and 2b (`DIAGNOSTIC`, each held against
      its base leg's numbers and served by leg 4 as its base would be;
      none is in the default legs): the critic in float32 (as the trainer
      builds it) or in bf16 (as the JAX package does) with G in bf16
      through the kernels, or the card's three arithmetic switches moved
      toward true float32 over the trainer's ((a) no bf16 split-K sums,
      (b) cuDNN's deterministic algorithms, (c) no TF32)
  2b-s<seed>-d16, 2b-s<seed>-d32, 2a-s<seed>-d16, 2a-s<seed>-d32
      seed legs (`SEED_LEGS`, diagnostic too): 2b and 2a at another
      top-level `seed` (SEEDS), each with the bf16 and the float32 critic;
      2a's are read at 3 epochs (`trainer.epochs=3`) by their critic's
      course (`critic_class`) and at the configs' 12, served, by 2a's
      bands (`spread_2a12`). `--replay` also runs each served 2b leg's
      checkpoint through `tools.tpu_rounding`
  5   the analysis tools (`tools/runs_analysis.py`,
      `tools/runs_inference_analysis.py`: pandas and matplotlib, which the
      card's machine lacks) over the text files of legs 2–4 against a
      baseline campaign's, on the CPU

Each leg runs in this process through the port's `train.main` and
`inference.main`, on the card unless `--device cpu` is given (`cuda`
never falls back to the CPU). Datasets and run directories go under
`--root` (`data/`, `outputs/runs/`), the reports under `--out`: each
training leg's `train_loss.txt` and `evaluation.txt` as
`<run tag>_{train_loss,evaluation}.txt`, leg 4's per-scene files in
`<out>/<model>/`, and `legs/<leg>.json`, one record a leg. The text files
are also printed. The last line printed is one JSON object: for each leg
in `--out`, its final validation PSNR and 1-SSIM, leg 4's full-frame mean
PSNR over the served scenes and the held-out pair, the round-5 numbers
each is held against with their bands, the epoch rates, io shares,
validation seconds, peak memory and kernel launches a step and a
validation batch; and the card (`nvidia-smi` name and power limit).

    python -m pixel_heal_thyself_tpu_torch.tools.quality_campaign \
        [--legs 1,2a,2b,3,4] [--root .] [--out reports/port_r5_quality] \
        [--device cuda|cpu] [--replay] [override ...]
    python -m pixel_heal_thyself_tpu_torch.tools.quality_campaign --legs 5 \
        [--out reports/port_r5_quality] [--baseline reports/r5_quality] [--header TEXT]
    python -m pixel_heal_thyself_tpu_torch.tools.quality_campaign --legs spread \
        --out reports/port_r5_quality/seeds      # or .../seeds12: 12-epoch 2a legs

An override is appended to every leg's command line, training and
serving.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch.tools import card_line, resolve_device
from pixel_heal_thyself_tpu_torch.tools.make_synthetic_datasets import (
    HELDOUT_SCENES,
    TRAIN_SCENES,
)

TRAIN_SEED, HELDOUT_SEED = 990819, 77
# channel → noise_scale of its synthetic renders
CHANNELS = {"clean05": 0.5, "clean": 0.75}


@dataclass(frozen=True)
class Leg:
    name: str
    model: str  # afgsa | mamba
    config: str  # the env config, -cn
    channel: str  # the channel trained on
    overrides: tuple[str, ...]
    # a diagnostic variant: the leg it is held against, its critic's
    # dtype and the arithmetic switches (`critic_numerics.set_switches`)
    # it sets over the trainer's
    base: str | None = None
    critic_dtype: torch.dtype | None = None
    arithmetic: tuple[tuple[str, bool], ...] = ()


TRAINING = (
    Leg("2a", "afgsa", "prod", "clean05", ("model.num_gradient_checkpoints=0",)),
    Leg("2b", "mamba", "stag", "clean05", ("model=mamba",)),
    Leg("3", "mamba", "stag", "clean", ("model=mamba",)),
)
# one-factor variants of legs 2a and 2b, each changing one thing of the run
# (no config key has it; the trainer takes it as an argument): the critic in
# float32 (the trainer's own choice, `models.discriminators.GP_CRITIC_DTYPE`)
# or in bf16 (the JAX package's) with G in bf16 through the kernels, and
# the card's arithmetic switches moved toward true float32 together: (a) no
# bf16 split-K sums in cuBLAS, (b) cuDNN's deterministic algorithms, (c) no
# TF32
_BASE = {leg.name: leg for leg in TRAINING}
DIAGNOSTIC = tuple(
    Leg(name, _BASE[base].model, _BASE[base].config, _BASE[base].channel,
        _BASE[base].overrides, base, dtype, switches)
    for name, base, dtype, switches in (
        ("2a-d32", "2a", torch.float32, ()),
        ("2a-d16", "2a", torch.bfloat16, ()),
        ("2a-abc", "2a", None, (("bf16_reduced_reduction", False),
                                ("cudnn_deterministic", True), ("tf32", False))),
        ("2b-d16", "2b", torch.bfloat16, ()),
    ))
# The seed legs, fixed before any of them ran: legs 2b and 2a again at
# another top-level `seed` (the configs' 990819 seeds the initial weights,
# patch sampling, the shuffle and the GP draws), each with the bf16 critic
# and the float32 one; the datasets' seeds (TRAIN_SEED, HELDOUT_SEED) stay,
# so every leg trains and serves on the same scenes. Seed 990819 itself is
# legs 2b, 2b-d16, 2a-d32 and 2a-d16.
SEEDS = (990820, 990821, 990822)
CRITICS = (("d16", torch.bfloat16), ("d32", torch.float32))
SEED_LEGS = tuple(
    Leg(f"{base}-s{seed}-{tag}", _BASE[base].model, _BASE[base].config, _BASE[base].channel,
        _BASE[base].overrides + (f"seed={seed}",), base, dtype)
    for base, seeds in (("2b", SEEDS), ("2a", SEEDS[:2]))
    for seed in seeds for tag, dtype in CRITICS)
# the store of a leg that sets its seed: the store's directory does not name
# the seed, and a complete store is reused, so without this every seed would
# train on the patches of the seed that built the store first
SEED_STORE = "data.patches.dir=${data.images.dir}/patches_${_base_pattern}_seed${seed}"
SERVED = ("2a", "2b")  # leg 4 serves these legs' last checkpoints
LEGS = ("1", "2a", "2b", "3", "4")  # the card's legs; 5 runs on the CPU

# Round 5 (the JAX package on a TPU, reports/r5_quality/, BASELINE.md's
# round-5 campaign): what each leg is held against. val_psnr: the final
# validation PSNR, full_frame: the mean PSNR over leg 4's 12 scenes (both
# runs for 2a: the XLA route and the megakernel, the same data and seed);
# the bands are ±0.3 dB around them. The held-out pair is reported with no
# band.
REFERENCE = {
    "2a": {"val_psnr": [37.1709, 37.0968], "val_band": [36.80, 37.47],
           "full_frame_psnr": [37.6693, 37.6039], "full_frame_band": [37.30, 37.97],
           "heldout_psnr": {"heldout0_0": 38.3622, "heldout1_0": 36.8507}},
    "2b": {"val_psnr": [38.9675], "val_band": [38.67, 39.27],
           "full_frame_psnr": [38.3803], "full_frame_band": [38.08, 38.68],
           "heldout_psnr": {"heldout0_0": 39.1132, "heldout1_0": 37.5182}},
    "3": {"val_psnr": [36.6909], "val_band": [36.39, 36.99]},
}
# the round-5 run of each leg, as the JAX script named its text files
R5_RUNS = {"2a": "afgsa_p128_n400_r1.0_run000", "2b": "mamba_p64_n200_r0.5_run000",
           "3": "mamba_p64_n200_r0.5_run001"}
# round 5's leg-4 files, one a scene (`<model>/<scene>_32_evaluation.txt`)
R5_DIR = Path(__file__).resolve().parents[2] / "reports" / "r5_quality"

EPOCH_SUMMARY = re.compile(r"\[Train\] epoch=(\d+) summary: .*\(([\d.]+) patches/sec, "
                           r"io ([\d.]+)s = (\d+)%\)")
EPOCH_LAUNCHES = re.compile(r"\[Train\] epoch=(\d+) kernel launches: (.*); peak memory (\d+) B")
VAL_SUMMARY = re.compile(r"\[Val\] epoch=(\d+) summary: .* time=(\d+)s")
VALIDATION = re.compile(r"Validation: (\d+) \tAvg MRSE: (\S+) \tAvg PSNR: (\S+) "
                        r"\tAvg 1-SSIM: (\S+)")
TRAIN_LOSS = re.compile(r"Epoch: (\d+) \tG loss: (\S+) \tD Loss: (\S+)")
SCENE_PSNR = re.compile(r"PSNR:\s*([\d.eE+-]+)")
SCENE_1_SSIM = re.compile(r"1-SSIM:\s*([\d.eE+-]+)")


def channel_dirs(root: str | Path, channel: str) -> tuple[Path, Path]:
    """The channel's training and held-out dataset directories."""
    data = Path(root) / "data"
    return data / f"images_prod_synth_{channel}", data / f"images_heldout_synth_{channel}"


def make_datasets(root: str | Path, channels=tuple(CHANNELS), size: int = 512,
                  n_scenes: int | None = None, log=print) -> None:
    """Leg 1: each channel's two directories under `root/data`, as the JAX
    script's `generate_dataset` calls (a smaller `size` and the first
    `n_scenes` scenes of each list for a quick check); existing
    directories are kept."""
    from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset

    for channel in channels:
        train_dir, heldout_dir = channel_dirs(root, channel)
        for d, scenes, seed in ((train_dir, TRAIN_SCENES, TRAIN_SEED),
                                (heldout_dir, HELDOUT_SCENES, HELDOUT_SEED)):
            if d.is_dir():
                continue
            log(f"generating {d}")
            generate_dataset(d, scenes=scenes[:n_scenes], height=size, width=size,
                             noise_scale=CHANNELS[channel], seed=seed)


def train_argv(leg: Leg, root: str | Path, overrides=(), device: str = "cuda") -> list[str]:
    """The leg's `train.main` command line."""
    train_dir, _ = channel_dirs(root, leg.channel)
    store = [SEED_STORE] if any(o.startswith("seed=") for o in leg.overrides) else []
    return (["-cn", leg.config, *leg.overrides, f"data.images.dir={train_dir.resolve()}",
             *store, *overrides, "--device", device])


def infer_argv(leg: Leg, ckpt: str | Path, images_dir: str | Path, out_dir: str | Path,
               overrides=(), device: str = "cuda") -> list[str]:
    """Leg 4's `inference.main` command line for one directory of scenes."""
    model = ["model=mamba"] if leg.model == "mamba" else []
    return (["-cn", leg.config, *model, f"trainer.model_path={Path(ckpt).resolve()}",
             f"inference.images_dir={Path(images_dir).resolve()}",
             f"inference.out_dir={Path(out_dir).resolve()}", f"inference.device={device}",
             *overrides])


@contextlib.contextmanager
def log_lines():
    """The port logger's messages while the block runs (still printed)."""
    lg = logging.getLogger("pht_tpu")
    lines: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep(logging.INFO)
    lg.addHandler(keep)
    try:
        yield lines
    finally:
        lg.removeHandler(keep)


def last_validation(path: str | Path) -> dict:
    """The last line of an `evaluation.txt`: epoch, PSNR, 1-SSIM."""
    rows = VALIDATION.findall(Path(path).read_text())
    epoch, _, psnr, one_minus_ssim = rows[-1]
    return {"epoch": int(epoch), "val_psnr": float(psnr), "val_1_ssim": float(one_minus_ssim)}


def course(train_loss: str | Path, evaluation: str | Path) -> dict:
    """A run's D loss and validation PSNR by epoch, from its
    `train_loss.txt` and `evaluation.txt`."""
    losses = TRAIN_LOSS.findall(Path(train_loss).read_text())
    vals = VALIDATION.findall(Path(evaluation).read_text())
    return {"d_loss": [float(d) for _, _, d in losses],
            "val_psnr_by_epoch": [float(psnr) for _, _, psnr, _ in vals]}


def critic_class(d_loss, val_psnr) -> str:
    """A 3-epoch leg 2a read by its epochs 2 and 3: a "weak critic" keeps
    D's loss ≥ 0 at both; a "reference-like" one, as round 5's run, has
    D < 0 at epoch 2 and validation falling by epoch 3; anything else is
    "neither"."""
    if d_loss[1] >= 0 and d_loss[2] >= 0:
        return "weak critic"
    if d_loss[1] < 0 and val_psnr[2] < val_psnr[1]:
        return "reference-like"
    return "neither"


def scene_metrics(folder: str | Path) -> dict:
    """{scene: (PSNR, 1-SSIM)} of the `<scene>_32_evaluation.txt` files in
    `folder`."""
    out = {}
    for f in sorted(Path(folder).glob("*_evaluation.txt")):
        text = f.read_text()
        scene = f.name.rsplit("_", 2)[0]
        out[scene] = (float(SCENE_PSNR.search(text)[1]), float(SCENE_1_SSIM.search(text)[1]))
    return out


def scene_deltas(scenes: dict, reference: str | Path) -> dict:
    """{scene: [PSNR, the reference folder's PSNR for the scene, the
    difference]} of `scene_metrics`' scenes that the reference folder
    also holds."""
    ref = scene_metrics(reference) if Path(reference).is_dir() else {}
    return {s: [p, ref[s][0], p - ref[s][0]] for s, (p, _) in scenes.items() if s in ref}


def full_frame_mean(folder: str | Path) -> float:
    """The plain mean of the per-scene PSNRs in `folder`, as round 5's
    37.67 dB is taken."""
    psnrs = [p for p, _ in scene_metrics(folder).values()]
    return float(np.mean(psnrs))


def show(path: Path, log=print) -> None:
    log(f"==> {path} <==")
    log(path.read_text().rstrip("\n"))


def _per_call(total: dict, calls: int) -> dict:
    return {k: v / calls for k, v in total.items() if v} if calls else {}


def run_training(leg: Leg, root: Path, out: Path, overrides=(), device: str = "cuda",
                 log=print) -> tuple[dict, Path]:
    """One training leg: `train.main`, then its text files copied to `out`
    and printed. The process's arithmetic switches, the trainer's
    determinism settings among them, are restored when it returns (the
    record's `arithmetic` is what the leg trained under). Returns (the
    leg's record, with its last checkpoint's digest, and the
    checkpoint)."""
    from pixel_heal_thyself_tpu_torch import train
    from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache
    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import arithmetic, switches_now
    from pixel_heal_thyself_tpu_torch.training import checkpoints
    from pixel_heal_thyself_tpu_torch.training.trainer import kernel_launches

    argv = train_argv(leg, root, overrides, device)
    switches = dict(leg.arithmetic)
    log(f"[campaign] leg {leg.name}: train {' '.join(argv)}")
    reset_run_dirs_cache()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = kernel_launches()
    t0 = time.perf_counter()
    with log_lines() as lines, arithmetic({**switches_now(), **switches}):  # all restored
        trainer = train.main(argv, critic_dtype=leg.critic_dtype, tf32=switches.get("tf32"))
        trained_under = switches_now()
    seconds = time.perf_counter() - t0
    total = {k: v - before[k] for k, v in kernel_launches().items()}
    cfg = trainer.cfg
    run = Path(cfg.paths.output_dir)
    tag = f"{run.parent.name}_{run.name}"
    # seed legs trained in several calls share run numbers: named by leg
    prefix = leg.name if leg in SEED_LEGS else tag
    for name in ("train_loss.txt", "evaluation.txt"):
        shutil.copyfile(run / name, out / f"{prefix}_{name}")
        show(out / f"{prefix}_{name}", log)

    patches = Path(cfg.data.patches.dir)
    n_train = len(np.load(patches / "train" / "aux.npy", mmap_mode="r"))
    n_val = len(np.load(patches / "val" / "aux.npy", mmap_mode="r"))
    epochs = cfg.trainer.epochs - trainer.start_epoch
    steps = epochs * math.ceil(n_train / cfg.trainer.batch_size)
    val_batches = epochs * math.ceil(n_val / max(1, cfg.trainer.val_batch_size))
    step_launches = dict.fromkeys(total, 0)
    peaks = []
    for m in filter(None, map(EPOCH_LAUNCHES.search, lines)):
        peaks.append(int(m[3]))
        for part in filter(None, m[2].split(", ")):
            name, n = part.rsplit(" ", 1)
            step_launches[name] += int(n)
    val_launches = {k: v - step_launches[k] for k, v in total.items()}
    rates = [m for m in map(EPOCH_SUMMARY.search, lines) if m]
    record = {
        "leg": leg.name, "model": leg.model, "config": leg.config, "channel": leg.channel,
        "overrides": list(overrides), "run": tag, "epochs": epochs, "base": leg.base,
        "seed": cfg.seed, "checkpoint": os.path.relpath(run / f"model_epoch{cfg.trainer.epochs}"
                                                        / "state", root),
        "critic_dtype": str(getattr(trainer.state.d, "dtype", trainer.compute_dtype))
        .removeprefix("torch."),
        "arithmetic": trained_under,
        "train_patches": n_train, "val_patches": n_val, **last_validation(run / "evaluation.txt"),
        **course(run / "train_loss.txt", run / "evaluation.txt"),
        "epoch_patches_per_sec": [float(m[2]) for m in rates],
        "epoch_io_percent": [int(m[4]) for m in rates],
        "val_seconds": [int(m[2]) for m in map(VAL_SUMMARY.search, lines) if m],
        "store_build_seconds": trainer.store_build_seconds,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "launches_per_step": _per_call(step_launches, steps),
        "launches_per_val_batch": _per_call(val_launches, val_batches),
        "seconds": seconds,
    }
    if peaks:
        record["epoch_peak_memory_bytes"] = peaks
    if epochs >= 3:
        record["critic_class"] = critic_class(record["d_loss"], record["val_psnr_by_epoch"])
    ckpt = root / record["checkpoint"]
    record["checkpoint_digest"] = checkpoints.digest(ckpt)
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    return record, ckpt


def run_serving(leg: Leg, ckpt: Path, root: Path, out: Path, overrides=(),
                device: str = "cuda", log=print) -> dict:
    """Leg 4 for one training leg: its checkpoint over the channel's
    training and held-out scenes, the per-scene files printed (in
    `<out>/<model>/`, a seed leg's in `<out>/<model>/<leg>/`)."""
    from pixel_heal_thyself_tpu_torch import inference
    from pixel_heal_thyself_tpu_torch.training.trainer import kernel_launches

    folder = out / leg.model / leg.name if leg in SEED_LEGS else out / leg.model
    folder.mkdir(parents=True, exist_ok=True)
    before = kernel_launches()
    t0 = time.perf_counter()
    for images in channel_dirs(root, leg.channel):
        argv = infer_argv(leg, ckpt, images, folder, overrides, device)
        log(f"[campaign] leg 4 ({leg.name}): inference {' '.join(argv)}")
        inference.main(argv)
    seconds = time.perf_counter() - t0
    scenes = scene_metrics(folder)
    for f in sorted(folder.glob("*_evaluation.txt")):
        show(f, log)
    heldout = {s: scenes[s][0] for s in HELDOUT_SCENES if s in scenes}
    return {
        "scene_psnr": scene_deltas(scenes, R5_DIR / leg.model),
        "served_scenes": len(scenes),
        "full_frame_psnr": full_frame_mean(folder),
        "full_frame_1_ssim": float(np.mean([v for _, v in scenes.values()])),
        "heldout_psnr": heldout,
        "serve_launches": {k: v - before[k] for k, v in kernel_launches().items()
                           if v - before[k]},
        "serve_seconds": seconds,
    }


def in_band(value: float | None, band) -> bool | None:
    return None if value is None else band[0] <= value <= band[1]


def summary(out: str | Path, card: str | None = None, device: str | None = None) -> dict:
    """Every leg recorded in `out/legs/`, beside its round-5 numbers and
    whether each banded number lies in its band."""
    legs = {}
    for f in sorted(Path(out, "legs").glob("*.json")):
        rec = json.loads(f.read_text())
        ref = REFERENCE[rec.get("base") or rec["leg"]]
        rec["reference"] = ref
        rec["val_psnr_in_band"] = in_band(rec["val_psnr"], ref["val_band"])
        if "full_frame_band" in ref:
            rec["full_frame_in_band"] = in_band(rec.get("full_frame_psnr"), ref["full_frame_band"])
        legs[rec["leg"]] = rec
    return {"campaign": "r5_quality", "device": device, "card": card, "legs": legs}


def run(root: str | Path = ".", out: str | Path = "reports/port_r5_quality", legs=LEGS,
        overrides=(), device: str = "cuda", size: int = 512, n_scenes: int | None = None,
        replay: bool = False, log=print) -> dict:
    """Legs `legs` (of LEGS) under `root` (relative paths: the working
    directory's), reports in `out` (relative: under `root`). `size` and
    `n_scenes` cut leg 1's datasets for a quick check. Leg 4 serves the
    legs of SERVED trained in this call, and their diagnostic variants;
    with `replay`, each served Mamba leg's checkpoint also goes through
    `tools.tpu_rounding` (its record in `out/replay/<leg>.json`).
    Returns the summary, which is also printed as the last line."""
    unknown = set(legs) - set(LEGS) - {leg.name for leg in DIAGNOSTIC + SEED_LEGS}
    if unknown:
        raise ValueError(f"unknown legs {sorted(unknown)}: the card's legs are {LEGS}, the "
                         f"diagnostic {[leg.name for leg in DIAGNOSTIC]} and the seed legs "
                         f"{[leg.name for leg in SEED_LEGS]} (leg 5 runs alone, on the CPU; so "
                         "does spread)")
    resolve_device(device, "quality_campaign")
    root = Path(root).resolve()
    root.mkdir(parents=True, exist_ok=True)
    out = root / out
    (out / "legs").mkdir(parents=True, exist_ok=True)
    card = card_line(device)
    if card:
        log(f"[campaign] {card}")
    training = [leg for leg in TRAINING + DIAGNOSTIC + SEED_LEGS if leg.name in legs]
    with contextlib.chdir(root):  # run directories go to root/outputs/runs
        if "1" in legs:
            make_datasets(root, sorted({leg.channel for leg in training} or CHANNELS),
                          size=size, n_scenes=n_scenes, log=log)
        for leg in training:
            record, ckpt = run_training(leg, root, out, overrides, device, log)
            if "4" in legs and (leg.base or leg.name) in SERVED:
                record.update(run_serving(leg, ckpt, root, out, overrides, device, log))
                if replay and leg.model == "mamba":
                    from pixel_heal_thyself_tpu_torch.tools import tpu_rounding

                    rec = tpu_rounding.run(ckpt, leg.name, root, overrides, device, log=log)
                    (out / "replay").mkdir(exist_ok=True)
                    (out / "replay" / f"{leg.name}.json").write_text(
                        json.dumps(rec, indent=1) + "\n")
            record["card"] = card
            (out / "legs" / f"{leg.name}.json").write_text(json.dumps(record, indent=1) + "\n")
            log(f"[campaign] leg {leg.name} done in {record['seconds']:.1f} s; {card}")
    result = summary(out, card, device)
    log(json.dumps(result))
    return result


# seed 990819's legs, the configs' own seed (trained by the seed legs'
# training code), under the campaign's reports: the 12-epoch 2b with the
# float32 critic and with the bf16 one, and the 3-epoch 2a with the bf16
# critic and with the float32 one
SEED_990819 = ("legs/2b.json", "diagnostic_d16_2b/legs/2b-d16.json",
               "diagnostic_e/legs/2a.json", "diagnostic_d32/legs/2a-d32.json")
# and the 12-epoch 2a of each critic, both trained before the trainer set
# cuDNN's deterministic algorithms: the bf16 critic's run (its record
# predates the key `critic_dtype`) and the float32 critic's
SEED_990819_2A12 = {"bf16_critic/legs/2a.json": "bfloat16", "legs/2a.json": "float32"}
# 2a's validation PSNR and full-frame mean against round 5's: the mean of
# its two runs, and the band each of the critic's legs at a new seed must
# land in for the critic to take the run's dtype again
ROUND5_2A = {"val_psnr": float(np.mean(REFERENCE["2a"]["val_psnr"])),
             "full_frame_psnr": float(np.mean(REFERENCE["2a"]["full_frame_psnr"]))}
BANDS_2A = {"val_psnr": REFERENCE["2a"]["val_band"],
            "full_frame_psnr": REFERENCE["2a"]["full_frame_band"]}


def _seed_record(path: Path) -> dict:
    """A leg's record with its course and its scenes against round 5's
    (from its text files when the record predates those keys)."""
    rec = json.loads(path.read_text())
    out = path.parent.parent
    if "d_loss" not in rec:
        prefix = out / rec["run"]
        rec.update(course(f"{prefix}_train_loss.txt", f"{prefix}_evaluation.txt"))
    if "scene_psnr" not in rec and rec.get("served_scenes"):
        rec["scene_psnr"] = scene_deltas(scene_metrics(out / rec["model"]), R5_DIR / rec["model"])
    rec.setdefault("seed", 990819)
    return rec


def _kind(rec: dict) -> str | None:
    """What a record adds to the spread: "2b", "2a3" (a 3-epoch 2a) or
    "2a12" (a 12-epoch 2a)."""
    base = rec.get("base") or rec["leg"]
    if base == "2b":
        return "2b"
    if base == "2a" and rec["epochs"] in (3, 12):
        return f"2a{rec['epochs']}"
    return None


def _stats(values) -> dict:
    v = np.array(values, dtype=float)
    return {"n": len(v), "mean": float(v.mean()),
            "sd": float(v.std(ddof=1)) if len(v) > 1 else float("nan"),
            "range": [float(v.min()), float(v.max())]}


def spread_2a12(recs: list[dict]) -> dict:
    """The 12-epoch 2a legs by critic: for each seed its validation PSNR
    and full-frame mean, each in 2a's band or not, and whether it ran
    before the trainer's determinism settings; for each critic the
    statistics of both over its seeds with round 5's z; Welch's t-test
    between the critics on each; and the rule fixed before the new legs
    ran: the critic takes the run's dtype again if and only if both new
    bf16 legs (seeds SEEDS[:2]) land in both bands."""
    from scipy import stats

    out: dict = {"round5": ROUND5_2A, "bands": BANDS_2A, "critics": {}}
    for rec in recs:
        row = out["critics"].setdefault(rec["critic_dtype"], {"seeds": {}})
        row["seeds"][str(rec["seed"])] = {
            **{k: rec[k] for k in BANDS_2A},
            **{f"{k}_in_band": in_band(rec[k], band) for k, band in BANDS_2A.items()},
            "before_repair": bool(rec.get("before_repair"))}
    for row in out["critics"].values():
        for key in BANDS_2A:
            st = _stats([v[key] for v in row["seeds"].values()])
            st["round5_z"] = (ROUND5_2A[key] - st["mean"]) / st["sd"]
            row[key] = st
    if {"float32", "bfloat16"} <= set(out["critics"]):
        seeds = {c: out["critics"][c]["seeds"].values() for c in ("float32", "bfloat16")}
        out["welch"] = {}
        for key in BANDS_2A:
            a, b = ([v[key] for v in seeds[c]] for c in ("float32", "bfloat16"))
            t = stats.ttest_ind(a, b, equal_var=False)
            out["welch"][key] = {"t": float(t.statistic), "p": float(t.pvalue),
                                 "float32_minus_bfloat16": float(np.mean(a) - np.mean(b))}
    new_bf16 = {s: v for s, v in out["critics"].get("bfloat16", {}).get("seeds", {}).items()
                if s in map(str, SEEDS[:2])}
    complete = sorted(new_bf16) == sorted(map(str, SEEDS[:2]))
    returns = complete and all(v["val_psnr_in_band"] and v["full_frame_psnr_in_band"]
                               for v in new_bf16.values())
    out["rule"] = {"bf16_legs": sorted(new_bf16), "complete": complete,
                   "critic": ("the run's dtype" if returns else "float32") if complete
                   else "undecided"}
    return out


def spread(out: str | Path = "reports/port_r5_quality/seeds",
           seed_runs: str | Path | None = None, log=print) -> dict:
    """The seed legs in `out/legs/` with seed 990819's of the same kinds
    (SEED_990819 and SEED_990819_2A12 under `seed_runs`, by default
    `out`'s parent), on the CPU: for each critic, 2b's full-frame means
    over the seeds (mean, sample SD, range), where round 5's number lies
    among them, Welch's t-test between the critics (scipy), 2b's
    validation; each 3-epoch 2a seed's critic class; and the 12-epoch 2a
    legs' reading (`spread_2a12`, key `2a_12`). Writes `out/spread.json`
    and `out/report.md`, which gives every leg's ±0.3 dB band verdicts as
    `summary` states them and the seed reading beside them."""
    from scipy import stats

    out = Path(out)
    seed_runs = Path(out.parent if seed_runs is None else seed_runs)
    recs = [_seed_record(f) for f in sorted((out / "legs").glob("*.json"))]
    kinds = {_kind(rec) for rec in recs}  # seed 990819 joins the kinds run here
    for f in SEED_990819:
        if (seed_runs / f).is_file() and _kind(rec := _seed_record(seed_runs / f)) in kinds:
            recs.append(rec)
    if "2a12" in kinds:
        for f, critic in SEED_990819_2A12.items():
            if (seed_runs / f).is_file():
                rec = _seed_record(seed_runs / f)
                rec.setdefault("critic_dtype", critic)
                recs.append(dict(rec, before_repair=True))
    ref = REFERENCE["2b"]["full_frame_psnr"][0]
    result = {"round5_full_frame_psnr": ref, "2b": {}, "2a": {}}
    if "2a12" in kinds:
        result["2a_12"] = spread_2a12([rec for rec in recs if _kind(rec) == "2a12"])
    for rec in recs:
        base = rec.get("base") or rec["leg"]
        critic = rec["critic_dtype"]
        if base == "2b":
            row = result["2b"].setdefault(critic, {"seeds": {}})
            row["seeds"][str(rec["seed"])] = {
                "full_frame_psnr": rec["full_frame_psnr"], "val_psnr": rec["val_psnr"],
                "scene_delta_range": ([min(d for *_, d in rec["scene_psnr"].values()),
                                       max(d for *_, d in rec["scene_psnr"].values())]
                                      if rec.get("scene_psnr") else None)}
        elif base == "2a" and rec["epochs"] == 3:
            result["2a"].setdefault(critic, {})[str(rec["seed"])] = {
                "d_loss": rec["d_loss"], "val_psnr_by_epoch": rec["val_psnr_by_epoch"],
                "class": critic_class(rec["d_loss"], rec["val_psnr_by_epoch"])}
    means = {}
    for critic, row in result["2b"].items():
        ff = np.array([v["full_frame_psnr"] for v in row["seeds"].values()])
        val = np.array([v["val_psnr"] for v in row["seeds"].values()])
        sd = float(ff.std(ddof=1)) if len(ff) > 1 else float("nan")
        means[critic] = ff
        row.update({"n": len(ff), "mean": float(ff.mean()), "sd": sd,
                    "range": [float(ff.min()), float(ff.max())],
                    "round5_z": (ref - float(ff.mean())) / sd,
                    "round5_below_all": bool(ref < ff.min()),
                    "val_mean": float(val.mean()),
                    "val_sd": float(val.std(ddof=1)) if len(val) > 1 else float("nan")})
    if {"float32", "bfloat16"} <= set(means):
        t = stats.ttest_ind(means["float32"], means["bfloat16"], equal_var=False)
        result["welch"] = {"t": float(t.statistic), "p": float(t.pvalue),
                           "float32_minus_bfloat16": float(means["float32"].mean()
                                                           - means["bfloat16"].mean())}
    (out / "spread.json").write_text(json.dumps(result, indent=1) + "\n")
    bands = summary(out)["legs"]
    lines = ["# Seed legs of the round-5 quality campaign", "",
             "Each leg's ±0.3 dB band verdicts as the campaign states them, and "
             "the seed reading beside them (`spread.json`).", "",
             "| leg | seed | critic | final val PSNR | in band | full-frame mean | in band "
             "| scene − round 5 (dB) | 2a class |", "|---|---|---|---|---|---|---|---|---|"]
    for name, rec in bands.items():
        deltas = [d for *_, d in rec.get("scene_psnr", {}).values()]
        lines.append("| " + " | ".join([
            name, str(rec["seed"]), rec["critic_dtype"], f"{rec['val_psnr']:.4f}",
            str(rec["val_psnr_in_band"]),
            f"{rec['full_frame_psnr']:.4f}" if "full_frame_psnr" in rec else "—",
            str(rec.get("full_frame_in_band")) if "full_frame_psnr" in rec else "—",
            f"{min(deltas):+.4f} to {max(deltas):+.4f}" if deltas else "—",
            critic_class(rec["d_loss"], rec["val_psnr_by_epoch"]) if rec["epochs"] == 3
            else "—"]) + " |")
    lines += ["", *spread_lines(result)]
    (out / "report.md").write_text("\n".join(lines) + "\n")
    log(json.dumps(result))
    return result


def spread_lines(result: dict) -> list[str]:
    """`spread`'s reading as markdown lines."""
    lines = [f"2b's full-frame mean over the seeds against round 5's "
             f"{result['round5_full_frame_psnr']}:"] if result["2b"] else []
    for critic, row in result["2b"].items():
        lines.append(f"- {critic} critic, {row['n']} seeds: mean {row['mean']:.4f}, SD "
                     f"{row['sd']:.4f}, range {row['range'][0]:.4f}–{row['range'][1]:.4f}; "
                     f"round 5 at {row['round5_z']:+.1f} SD; validation {row['val_mean']:.4f}"
                     f" (SD {row['val_sd']:.4f})")
    if "welch" in result:
        lines.append(f"- Welch's t-test, float32 against bf16: t {result['welch']['t']:.3f}, "
                     f"p {result['welch']['p']:.4g}")
    for critic, seeds in result["2a"].items():
        lines.append(f"- 2a, {critic} critic: " + ", ".join(
            f"{s} {v['class']}" for s, v in sorted(seeds.items())))
    if "2a_12" in result:
        r = result["2a_12"]
        lines.append(f"2a at 12 epochs against round 5's {r['round5']['val_psnr']:.4f} "
                     f"(validation, band {r['bands']['val_psnr']}) and "
                     f"{r['round5']['full_frame_psnr']:.4f} (full-frame mean, band "
                     f"{r['bands']['full_frame_psnr']}); * ran before the trainer set cuDNN's "
                     "deterministic algorithms:")
        for critic, row in r["critics"].items():
            lines.append(f"- {critic} critic, {row['full_frame_psnr']['n']} seeds: " + "; ".join(
                f"{s}{'*' if v['before_repair'] else ''} {v['val_psnr']:.4f} / "
                f"{v['full_frame_psnr']:.4f}" for s, v in sorted(row["seeds"].items())))
            for key in BANDS_2A:
                st = row[key]
                lines.append(f"  - {key}: mean {st['mean']:.4f}, SD {st['sd']:.4f}, range "
                             f"{st['range'][0]:.4f}–{st['range'][1]:.4f}; round 5 at "
                             f"{st['round5_z']:+.1f} SD")
        for key, w in r.get("welch", {}).items():
            lines.append(f"- Welch's t-test on {key}, float32 against bf16: t {w['t']:.3f}, "
                         f"p {w['p']:.4g}")
        rule = r["rule"]
        lines.append(f"- The rule (both new bf16 legs, seeds {list(SEEDS[:2])}, in both bands): "
                     f"bf16 legs {rule['bf16_legs']}, the critic: {rule['critic']}")
    return lines


def analyse(out: str | Path = "reports/port_r5_quality",
            baseline: str | Path = "reports/r5_quality", header: str | None = None,
            log=print) -> None:
    """Leg 5 on the CPU: `tools/runs_inference_analysis.py` with the
    baseline campaign's AFGSA as its baseline and the baseline's Mamba and
    this campaign's two served generators as variants (`out/comparison/`),
    and `tools/runs_analysis.py` over the six training runs, each in a
    run directory of its own named `<source>_leg<leg>`
    (`out/training_analysis/`); then `out/report.md`: `header`, and each
    leg's banded numbers against the baseline's."""
    out, baseline = Path(out), Path(baseline)
    tools = Path(__file__).resolve().parents[2] / "tools"
    comparison = [sys.executable, str(tools / "runs_inference_analysis.py"),
                  "--baseline-dirs", str(baseline / "afgsa")]
    for name, folder in (("port_afgsa", out / "afgsa"), ("mamba", baseline / "mamba"),
                         ("port_mamba", out / "mamba")):
        if folder.is_dir():
            comparison += ["--variant", f"{name}={folder}"]
    subprocess.run(comparison + ["--output-dir", str(out / "comparison")], check=True)
    result = summary(out)
    with tempfile.TemporaryDirectory() as tmp:
        runs = [("r5", leg, baseline / tag) for leg, tag in R5_RUNS.items()]
        runs += [("port", name, out / rec["run"]) for name, rec in result["legs"].items()]
        for source, leg, prefix in runs:
            run_dir = Path(tmp, f"{source}_leg{leg}", "run000")
            run_dir.mkdir(parents=True)
            for name in ("train_loss.txt", "evaluation.txt"):
                shutil.copyfile(f"{prefix}_{name}", run_dir / name)
        # from inside the tree, so that the CSV names each run by its own dirs
        subprocess.run([sys.executable, str(tools / "runs_analysis.py"), ".", "--output-dir",
                        str((out / "training_analysis").resolve()), "--tail-epochs", "5"],
                       check=True, cwd=tmp)
    lines = [f"# The port's round-5 quality campaign against `{baseline}`", ""]
    if header:
        lines += [header, ""]
    lines += ["| leg | model, config, channel | final val PSNR | round 5 | band | in band "
              "| full-frame mean PSNR | round 5 | band | in band | held-out PSNR | round 5 |",
              "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for name, rec in result["legs"].items():
        ref = rec["reference"]
        cells = [name, f"{rec['model']} {rec['config']} {rec['channel']}",
                 f"{rec['val_psnr']:.4f}", " / ".join(map(str, ref["val_psnr"])),
                 "–".join(map(str, ref["val_band"])), str(rec["val_psnr_in_band"])]
        if "full_frame_band" in ref and "full_frame_psnr" in rec:
            cells += [f"{rec['full_frame_psnr']:.4f}",
                      " / ".join(map(str, ref["full_frame_psnr"])),
                      "–".join(map(str, ref["full_frame_band"])), str(rec["full_frame_in_band"]),
                      " / ".join(f"{rec['heldout_psnr'][s]:.4f}" for s in HELDOUT_SCENES),
                      " / ".join(str(ref["heldout_psnr"][s]) for s in HELDOUT_SCENES)]
        else:
            cells += ["—"] * 6
        lines.append("| " + " | ".join(cells) + " |")
    seeds = out / "seeds" / "spread.json"
    if seeds.is_file():
        lines += ["", "Beside the band verdicts above (`seeds/report.md`, `--legs spread`): the "
                  "seed legs' spread.", *spread_lines(json.loads(seeds.read_text()))]
    lines += ["", "Per-scene comparison: `comparison/report.md`, `comparison/summary.txt`; "
              "training curves: `training_analysis/metrics_report.txt`, "
              "`training_analysis/runs_data.csv`; each leg's record: `legs/<leg>.json`."]
    (out / "report.md").write_text("\n".join(lines) + "\n")
    log(f"Wrote {out / 'report.md'}")


def main(argv=None) -> dict | None:
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.quality_campaign",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--legs", default=",".join(LEGS),
                        help="comma-separated legs: of 1,2a,2b,3,4 (the card's), the "
                             "diagnostic 2a-d32,2a-d16,2a-abc,2b-d16 and the seed legs "
                             "(SEED_LEGS), or 5 or spread alone")
    parser.add_argument("--root", default=".", help="where data/ and outputs/ go")
    parser.add_argument("--out", default="reports/port_r5_quality",
                        help="the reports' directory (relative: under --root)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--baseline", default="reports/r5_quality",
                        help="leg 5: the campaign to compare with")
    parser.add_argument("--header", default=None, help="leg 5: report.md's header line")
    parser.add_argument("--replay", action="store_true",
                        help="also run each served Mamba leg's checkpoint through "
                             "tools.tpu_rounding")
    parser.add_argument("overrides", nargs="*", help="key=value appended to every leg")
    args = parser.parse_intermixed_args(argv)
    legs = tuple(args.legs.split(","))
    if legs == ("spread",):
        spread(Path(args.root, args.out))
        return None
    if legs == ("5",):
        analyse(Path(args.root, args.out), args.baseline, args.header)
        return None
    return run(args.root, args.out, legs, args.overrides, args.device, replay=args.replay)


if __name__ == "__main__":
    main()

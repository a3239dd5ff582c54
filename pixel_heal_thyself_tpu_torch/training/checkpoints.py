"""Trainer checkpoints: the whole train state, with a working resume.

Port of `pixel_heal_thyself_tpu/training/checkpoints.py` (which writes
Orbax state; the reference saved only the networks' state dicts,
`pht/models/base_trainer.py:487-533`). A checkpoint is a directory,
`<run>/model_epoch<N>/state/`, holding `checkpoint.pt`: one `torch.save`
of both networks' state dicts (the multiscale critic's spectral-norm `u`
buffers with D's), both Adam states, both LR schedules, the
state of the generator the GP weights are drawn from, and the epoch. It
is written under a temporary name and renamed, so a `checkpoint.pt` is
always whole, and restored to the bit.

The JAX package's Orbax checkpoints reach the port through
`tools/export_params_npz.py` and `params.py`.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch

from pixel_heal_thyself_tpu_torch.training.train_step import TrainState

FILE = "checkpoint.pt"


def _save(obj, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str | Path, state: TrainState, epoch: int) -> None:
    """Write `state` and the (0-based) `epoch` it finished to `path/`."""
    _save({
        "g": state.g.state_dict(),
        "d": state.d.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_sched": state.g_sched.state_dict(),
        "d_sched": state.d_sched.state_dict(),
        "generator": None if state.generator is None else state.generator.get_state(),
        "epoch": int(epoch),
    }, Path(path) / FILE)


def restore_checkpoint(path: str | Path, state: TrainState) -> int:
    """Load the checkpoint at `path/` into `state` (built as the saving run
    built it) in place; returns the epoch it finished. Read onto the CPU:
    `load_state_dict` moves each tensor to its parameter's device and
    keeps Adam's step counts on the CPU, where Adam keeps them."""
    ckpt = torch.load(Path(path) / FILE, map_location="cpu", weights_only=True)
    state.g.load_state_dict(ckpt["g"])
    state.d.load_state_dict(ckpt["d"])
    state.g_opt.load_state_dict(ckpt["g_opt"])
    state.d_opt.load_state_dict(ckpt["d_opt"])
    state.g_sched.load_state_dict(ckpt["g_sched"])
    state.d_sched.load_state_dict(ckpt["d_sched"])
    if state.generator is not None and ckpt["generator"] is not None:
        state.generator.set_state(ckpt["generator"])
    return int(ckpt["epoch"])


def save_params(path: str | Path, model: torch.nn.Module | dict) -> None:
    """Params-only export of `model`, a module or its state dict (a deploy
    artifact), to the file `path`."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    _save({k: v.detach().cpu() for k, v in state.items()}, Path(path))


def restore_params(path: str | Path) -> dict:
    """The generator state dict, on the CPU, of a trainer checkpoint
    directory or of a params-only file written by `save_params`."""
    path = Path(path)
    if path.is_dir():
        return torch.load(path / FILE, map_location="cpu", weights_only=True)["g"]
    return torch.load(path, map_location="cpu", weights_only=True)

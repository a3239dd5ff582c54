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

Under several ranks (`parallel.mesh`), every rank calls `save_checkpoint`
and only rank 0 writes: the same file that one process writes. With
tensor parallelism each Adam moment is first gathered from the ranks'
shards (`ParamShards.full_optimizer_state`); `restore_checkpoint` reads
the full file on every rank and cuts each rank's shards from it, so the
ranks of a resumed run start equal.

The JAX package's Orbax checkpoints reach the port through
`tools/export_params_npz.py` and `params.py`.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path

import torch

from pixel_heal_thyself_tpu_torch.parallel.distributed import is_main_process
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


def _opt_state(opt, shards) -> dict:
    return opt.state_dict() if shards is None else shards.full_optimizer_state(opt)


def save_checkpoint(path: str | Path | None, state: TrainState, epoch: int) -> None:
    """Write `state` and the (0-based) `epoch` it finished to `path/`; on
    rank 0 only, after the gathers every rank takes part in (`path` is
    not read elsewhere)."""
    g_opt, d_opt = _opt_state(state.g_opt, state.g_shards), _opt_state(state.d_opt, state.d_shards)
    if not is_main_process():
        return
    _save({
        "g": state.g.state_dict(),
        "d": state.d.state_dict(),
        "g_opt": g_opt,
        "d_opt": d_opt,
        "g_sched": state.g_sched.state_dict(),
        "d_sched": state.d_sched.state_dict(),
        "generator": None if state.generator is None else state.generator.get_state(),
        "epoch": int(epoch),
    }, Path(path) / FILE)


def _load_opt(opt, shards, sd: dict) -> None:
    if shards is None:
        opt.load_state_dict(sd)
    else:
        shards.load_full_optimizer_state(opt, sd)


def restore_checkpoint(path: str | Path, state: TrainState) -> int:
    """Load the checkpoint at `path/` into `state` (built as the saving run
    built it) in place, on every rank; returns the epoch it finished. Read
    onto the CPU:
    `load_state_dict` moves each tensor to its parameter's device and
    keeps Adam's step counts on the CPU, where Adam keeps them."""
    ckpt = torch.load(Path(path) / FILE, map_location="cpu", weights_only=True)
    state.g.load_state_dict(ckpt["g"])
    state.d.load_state_dict(ckpt["d"])
    for shards in (state.g_shards, state.d_shards):
        if shards is not None:
            shards.reshard()
    _load_opt(state.g_opt, state.g_shards, ckpt["g_opt"])
    _load_opt(state.d_opt, state.d_shards, ckpt["d_opt"])
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


def digest(path: str | Path) -> dict[str, str]:
    """The sha256 of G (with any `u`), D and both Adam states in the
    checkpoint in `path/`, each over its keys in order, every tensor's
    dtype, shape and bytes and every other value's repr. Two runs that
    repeat to the bit have equal digests."""
    state = torch.load(Path(path) / FILE, map_location="cpu", weights_only=True)

    def feed(h, key: str, value) -> None:
        if isinstance(value, dict):
            for k in sorted(value, key=str):
                feed(h, f"{key}/{k}", value[k])
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                feed(h, f"{key}/{i}", v)
        elif isinstance(value, torch.Tensor):
            v = value.detach().contiguous().reshape(-1)
            h.update(f"{key}:{v.dtype}:{tuple(value.shape)}".encode())
            h.update(v.view(torch.uint8).numpy().tobytes())
        else:
            h.update(f"{key}={value!r}".encode())

    out = {}
    for part in ("g", "d", "g_opt", "d_opt"):
        h = hashlib.sha256()
        feed(h, part, state[part])
        out[part] = h.hexdigest()
    return out

"""Rank programs of the port's sharded-serving CPU tests.

Each function runs in every rank of a gloo process group started by
`pixel_heal_thyself_tpu_torch.parallel.distributed.spawn_world` (one
torch thread a rank); rank 0 saves every output into `out_dir` with
`torch.save`, and the test files compare them with the JAX package in the
parent process. This module imports torch, numpy and the port only: the
ranks never load JAX.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pixel_heal_thyself_tpu_torch.parallel.mesh import row_axis


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _axes() -> dict:
    """The row axes of the tests, by rank count: every rank of the world
    (4) and the subgroup of ranks 0 and 1 (2; None on the other ranks)."""
    sub = dist.new_group([0, 1])  # a collective: every rank creates it
    return {dist.get_world_size(): row_axis(),
            2: row_axis(sub) if dist.get_rank() < 2 else None}


def _rows(x: np.ndarray, axis, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous strip of `x` along `dim`."""
    strip = x.shape[dim] // axis.size
    return _t(np.take(x, range(axis.index * strip, (axis.index + 1) * strip), axis=dim))


def _gathered(local: torch.Tensor, axis, dim: int = 1) -> np.ndarray:
    return torch.cat(list(axis.all_gather(local.contiguous())), dim=dim).numpy()


def _save(out_dir: str, outputs: dict) -> None:
    """Rank 0 saves `outputs`, and whether this rank's process loaded JAX."""
    if dist.get_rank() == 0:
        outputs["jax_loaded"] = any(m.split(".")[0] in ("jax", "flax", "pixel_heal_thyself_tpu")
                                    for m in sys.modules)
        torch.save(outputs, Path(out_dir, "outputs.pt"))


def ops_rank(out_dir: str, cases: dict) -> None:
    """`ssd_sharded`, `make_row_halo_pad`, the conv1d with the previous
    rank's tail tokens and the merged encoder under halo padding."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import MultiScaleEncoder
    from pixel_heal_thyself_tpu_torch.ops.conv import causal_depthwise_conv1d
    from pixel_heal_thyself_tpu_torch.ops.padding import make_row_halo_pad
    from pixel_heal_thyself_tpu_torch.ops.ssd import ssd_sharded

    axes = _axes()
    out = {}
    for name, (ranks, chunk, inp) in cases["ssd"].items():
        axis = axes[ranks]
        if axis is None:
            continue
        x, dt, B, C = (_rows(inp[k], axis) for k in ("x", "dt", "B", "C"))
        y = ssd_sharded(x, dt, _t(inp["A"]), B, C, _t(inp["D"]), axis=axis, chunk=chunk)
        out[f"ssd/{name}"] = _gathered(y, axis)
    for ranks in (2, 4):
        axis = axes[ranks]
        if axis is None:
            continue
        pad_fn = make_row_halo_pad(axis)
        for mode in ("zeros", "reflect", "replicate"):
            for pad in (1, 2):
                local = pad_fn(_rows(cases["image"], axis), pad, mode)
                out[f"halo/{ranks}/{mode}/{pad}"] = _gathered(local, axis)
    axis = axes[4]
    conv = cases["conv1d"]
    x = _rows(conv["x"], axis)
    k = conv["w"].shape[0]
    tail, _ = axis.exchange(x[:, -(k - 1):], None)
    y = causal_depthwise_conv1d(x, _t(conv["w"]), _t(conv["b"]), initial_tokens=tail)
    out["conv1d"] = _gathered(y, axis)
    enc = cases["encoder"]
    for mode in ("reflect", "replicate"):
        module = MultiScaleEncoder(enc["x"].shape[-1], enc["features"], enc["slopes"], mode,
                                   torch.float32, None)
        module.load_state_dict({key: _t(v) for key, v in enc["state"].items()})
        with torch.no_grad():
            local = module(_rows(enc["x"], axis), make_row_halo_pad(axis))
        out[f"encoder/{mode}"] = _gathered(local, axis)
    _save(out_dir, out)


def spatial_rank(out_dir: str, cases: dict) -> None:
    """`sharded_apply_rows` and `denoise_frame_spatial` of a small
    AFGSANet (float32) over every rank."""
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame_spatial
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.parallel.spatial import (
        make_sharded_apply_rows,
        sharded_apply_rows,
    )

    axis = row_axis()
    model = AFGSANet(**cases["kwargs"]).eval()
    model.load_state_dict({key: _t(v) for key, v in cases["state"].items()})
    out = {}
    with torch.no_grad():
        rows = cases["rows"]
        out["rows"] = sharded_apply_rows(model, rows["margin"], _t(rows["noisy"]),
                                         _t(rows["aux"]), axis).numpy()
    frame = cases["frame"]
    out["frame"] = denoise_frame_spatial(
        make_sharded_apply_rows(model, frame["margin"], axis), frame["data"], axis.size,
        margin=frame["margin"], device="cpu",
    )
    _save(out_dir, out)


def sequence_rank(out_dir: str, cases: dict) -> None:
    """MambaDenoiserNets in `seq_axis` mode over the whole world or the
    subgroup of 2: on whole [1, H, W, C] inputs through
    `make_seq_sharded_apply`, or, for a case with a frame `data`, through
    `denoise_frame_sequence`."""
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame_sequence
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet
    from pixel_heal_thyself_tpu_torch.parallel.sequence import make_seq_sharded_apply

    axes = _axes()
    out = {}
    for name, case in cases.items():
        axis = axes[case["ranks"]]
        if axis is None:
            continue
        model = MambaDenoiserNet(**case["kwargs"]).eval()
        model.load_state_dict({key: _t(v) for key, v in case["state"].items()})
        apply = make_seq_sharded_apply(model, axis)
        if "data" in case:
            out[name] = denoise_frame_sequence(apply, case["data"], axis.size, device="cpu")
            continue
        with torch.no_grad():
            out[name] = apply(_t(case["noisy"]), _t(case["aux"])).float().numpy()
    _save(out_dir, out)


def cli_rank(out_dir: str, runs: dict) -> None:
    """`run_inference(spatial=True, device="cpu")` of each model, every rank
    writing into an out dir of its own: only rank 0 may write."""
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache
    from pixel_heal_thyself_tpu_torch.inference import run_inference

    rank = dist.get_rank()
    out = {}
    for name, run in runs.items():
        reset_run_dirs_cache()
        cfg = ConfigRegistry.create_config(compose("prod", run["overrides"],
                                                   resolve_interpolations=False))
        target = os.path.join(out_dir, f"{name}_rank{rank}")
        out[name] = run_inference(cfg, run["images"], target, margin=run["margin"],
                                  save_exr=True, spatial=True, device="cpu")
    # every rank's results: rank 0 the scores, the others none
    torch.save(out, Path(out_dir, f"results_rank{rank}.pt"))


def failing_rank(out_dir: str) -> None:
    """Rank 1 raises while rank 0 waits in a collective for it."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 failed on purpose")
    dist.barrier()

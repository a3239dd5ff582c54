"""Exported serving artifacts via `torch.export` (PyTorch port).

Port of `pixel_heal_thyself_tpu/serving.py`. A trained denoiser is traced
once into a self-contained, versioned artifact that a serving process
loads and runs with torch and this package's op library alone: no model
class, no checkpoint, no re-trace.

Artifact layout (a directory):
    model.pt2         `torch.export.save` of the ExportedProgram, the
                      weights inside it
    manifest.json     artifact version, model name, input shapes/dtypes,
                      tile geometry, platforms, torch version, the
                      `pht::` kernel ops in the graph

The kernels stay in the artifact: every launch on the serving path sits
behind a `torch.library` op (`ops/library.py`), the counterpart of a
Pallas kernel's Mosaic custom call inside a StableHLO artifact, so the
loaded graph launches K2 → K1 → K3 for an AFGSA block, K1 under FiLM or
`fold_qkv`, and K7 for a Mamba layer, as the live model does. A route
whose launches are not ops (the Mamba literal route's `use_pallas`, K9)
fails the export (`_build.dispatch`) instead of exporting other ops.

Platforms: a single-platform artifact (`("cuda",)` or `("cpu",)`) is
traced on that device and runs only there. A multi-platform artifact
(`("cpu", "cuda")`) is the plain route (no kernel ops), traced on the
CPU; `load_exported` moves it to the card with `move_to_device_pass`.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Sequence

import torch

ARTIFACT_VERSION = 1
MODULE_FILE = "model.pt2"
MANIFEST_FILE = "manifest.json"


def export_denoiser(
    model: torch.nn.Module,
    out_dir: str | Path,
    *,
    window: int,
    batch_tiles: int = 8,
    aux_channels: int = 7,
    platforms: Sequence[str] = ("cuda",),
    model_name: str = "",
    extra_meta: dict | None = None,
) -> Path:
    """Export `model(noisy, aux)` as an artifact in `out_dir`.

    `window` is the serving tile size (tile + 2·margin in `inference.py`
    terms); inputs are [batch_tiles, window, window, 3|aux_channels] fp32
    in the training input domain (log-transformed radiance, preprocessed
    normals), what `inference.denoise_frame` feeds the live model. The
    trace runs under `torch.no_grad()`, so the serving branches are the
    ones captured, on the device of the model's parameters, which must be
    the one platform named, or the CPU for a multi-platform artifact."""
    from pixel_heal_thyself_tpu_torch.ops.library import graph_ops

    platforms = list(platforms)
    device = next(model.parameters()).device
    if len(platforms) == 1 and device.type != platforms[0]:
        raise ValueError(f"a {platforms[0]!r} artifact is traced on that device; the model's "
                         f"parameters are on {device}")
    if len(platforms) > 1 and device.type != "cpu":
        raise ValueError(f"a multi-platform artifact {platforms} is traced on the CPU; the "
                         f"model's parameters are on {device}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    noisy = torch.zeros(batch_tiles, window, window, 3, device=device)
    aux = torch.zeros(batch_tiles, window, window, aux_channels, device=device)
    with torch.no_grad():
        # a call first (one tile) builds what the model makes on its first
        # call, the Mamba positional encoding, on the device in its dtype:
        # the graph then holds it as a constant in that form, not a host
        # array copied and converted on every call
        model(noisy[:1], aux[:1])
        program = torch.export.export(model, (noisy, aux), strict=False)
    ops = graph_ops(program.graph)
    if len(platforms) > 1 and ops:
        raise ValueError(f"a multi-platform artifact {platforms} must be the plain route, but "
                         f"the graph holds the kernel ops {ops}; export with use_kernels off")
    torch.export.save(program, out_dir / MODULE_FILE)

    manifest = {
        "artifact_version": ARTIFACT_VERSION,
        "model_name": model_name or type(model).__name__,
        "window": window,
        "batch_tiles": batch_tiles,
        "inputs": {
            "noisy": {"shape": list(noisy.shape), "dtype": "float32"},
            "aux": {"shape": list(aux.shape), "dtype": "float32"},
        },
        "input_domain": "log1p radiance; normals mapped to [0,1]",
        "output_domain": "log1p radiance (postprocess with expm1)",
        "platforms": platforms,
        "traced_on": device.type,
        "kernel_ops": ops,
        "torch_version": torch.__version__,
        "created_utc": datetime.now(timezone.utc).isoformat(timespec="seconds"),
    }
    if extra_meta:
        manifest.update(extra_meta)
    (out_dir / MANIFEST_FILE).write_text(json.dumps(manifest, indent=2) + "\n")
    return out_dir


def load_manifest(artifact_dir: str | Path) -> dict:
    path = Path(artifact_dir) / MANIFEST_FILE
    manifest = json.loads(path.read_text())
    version = manifest.get("artifact_version")
    if version != ARTIFACT_VERSION:
        raise ValueError(
            f"unsupported artifact version {version!r} at {path} "
            f"(this build reads version {ARTIFACT_VERSION})",
        )
    return manifest


def load_exported(
    artifact_dir: str | Path, device: torch.device | str = "cuda",
) -> tuple[Callable[[torch.Tensor, torch.Tensor], torch.Tensor], dict]:
    """Load an exported artifact onto `device` → (apply_fn, manifest).

    The returned callable has the live model's contract (`apply_fn(noisy,
    aux) -> denoised`, fixed [batch_tiles, window, window, ·] fp32 inputs
    on `device`), so it drops into `inference.denoise_frame` and
    `make_fused_frame_apply`. Refuses an artifact of another version, and
    one not exported for `device`'s type: a CUDA artifact never runs on
    the CPU or the other way round."""
    artifact_dir = Path(artifact_dir)
    manifest = load_manifest(artifact_dir)
    device = torch.device(device)
    platforms = manifest.get("platforms", [])
    if platforms and device.type not in platforms:
        raise ValueError(
            f"artifact at {artifact_dir} was lowered for {platforms}, but this process "
            f"runs on {device.type!r}; re-export with export.platforms including "
            f"{device.type!r} (python -m pixel_heal_thyself_tpu_torch.tools.export_model)",
        )
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"artifact at {artifact_dir} runs on the card, but no CUDA "
                           "device is available")
    from pixel_heal_thyself_tpu_torch.ops import library  # noqa: F401  registers pht::

    program = torch.export.load(artifact_dir / MODULE_FILE)
    if device.type != manifest["traced_on"]:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    module = program.module()

    def apply_fn(noisy: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():  # as traced: the artifact serves, it does not train
            return module(noisy, aux)

    return apply_fn, manifest

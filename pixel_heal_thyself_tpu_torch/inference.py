"""Full-frame tiled inference CLI (PyTorch port).

Port of `pixel_heal_thyself_tpu/inference.py`:

    python -m pixel_heal_thyself_tpu_torch.inference -cn prod \
        trainer.model_path=<ckpt or .npz> inference.images_dir=data/images \
        [inference.out_dir=...] [inference.device=cuda]

`trainer.model_path` names the port trainer's checkpoint
(`<run>/model_epochN/state`) or a flat `.npz` of the flax generator
params (`tools/export_params_npz.py` writes one from a JAX checkpoint).
Frames are denoised in overlapping tiles (tile 64 + margin 32 → 128²
windows, 8 to a batch), stitched by cropping the margins, and scored with
the training metrics into `<scene>_<spp>_evaluation.txt`.

By default (`inference.fused=true`) the padding, window gather, batched
model calls and stitching run on the device (`make_fused_frame_apply`);
`inference.fused=false` takes the host loop (`denoise_frame`). Both
generators are served: `model=afgsa` (AFGSANet) and `model=mamba`
(MambaDenoiserNet).

    python -m pixel_heal_thyself_tpu_torch.inference -cn prod \
        inference.from_export=<artifact dir> inference.images_dir=...

serves an artifact of `tools/export_model.py` (`serving.py`) in place of
the model: no model class and no checkpoint. Its window and batch win
over `inference.tile`/`batch_tiles` (the margin stays; the tile takes the
difference), and both tilers take its `apply_fn` as they take the live
model.

`inference.spatial=true` shards whole frames over the ranks of a
`torch.distributed` process group (`parallel/`): AFGSA row-sharded with
`margin` halo rows from each neighbour (`denoise_frame_spatial`), Mamba
sequence-sharded, exactly the unsharded model (`denoise_frame_sequence`).
Every rank reads each frame and computes its strip; the frame is
gathered to every rank and only rank 0 scores it and writes files. One
process per card:

    python -m torch.distributed.run --nproc-per-node <cards> \
        -m pixel_heal_thyself_tpu_torch.inference -cn prod \
        parallel.multihost=true inference.spatial=true trainer.model_path=...

(`PHT_COORDINATOR`/`PHT_NUM_PROCESSES`/`PHT_PROCESS_ID` instead of the
launcher work too, `parallel/distributed.py`). With no process group,
`spatial` runs the same code with one rank.

Everything runs on the card (`inference.device=cuda`, the default) unless
the caller asks for the CPU (`inference.device=cpu`); with no card the
CLI raises rather than fall back. The config layer (pyyaml) and the
scorers (`metrics`, OpenCV) are imported only by the functions that need
them, so the denoising path needs only torch, numpy and scipy.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch.data.preprocessing import (
    postprocess_specular,
    preprocess_data,
    preprocess_normal,
    preprocess_specular,
)
from pixel_heal_thyself_tpu_torch.logger import logger


def extract_tiles(x: np.ndarray, tile: int, margin: int) -> tuple[np.ndarray, tuple]:
    """Split [H, W, C] into overlapping (tile+2·margin)² tiles at stride
    `tile`, replicate-padding the frame edges. Returns (tiles, meta)."""
    h, w, c = x.shape
    ht = -(-h // tile)
    wt = -(-w // tile)
    ph, pw = ht * tile, wt * tile
    xp = np.pad(
        x, ((margin, margin + ph - h), (margin, margin + pw - w), (0, 0)), mode="edge",
    )
    size = tile + 2 * margin
    tiles = np.empty((ht * wt, size, size, c), np.float32)
    idx = 0
    for ty in range(ht):
        for tx in range(wt):
            y0, x0 = ty * tile, tx * tile
            tiles[idx] = xp[y0 : y0 + size, x0 : x0 + size]
            idx += 1
    return tiles, (h, w, ht, wt)


def stitch_tiles(tiles: np.ndarray, meta: tuple, tile: int, margin: int) -> np.ndarray:
    """Inverse of extract_tiles: crop margins and reassemble to [H, W, C]."""
    h, w, ht, wt = meta
    c = tiles.shape[-1]
    out = np.empty((ht * tile, wt * tile, c), np.float32)
    idx = 0
    for ty in range(ht):
        for tx in range(wt):
            out[ty * tile : (ty + 1) * tile, tx * tile : (tx + 1) * tile] = tiles[
                idx, margin : margin + tile, margin : margin + tile
            ]
            idx += 1
    return out[:h, :w]


def _model_inputs(data: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Log-space noisy radiance and aux with remapped normals."""
    noisy_log = preprocess_specular(data["noisy"]).astype(np.float32)
    aux = data["aux"].astype(np.float32).copy()
    aux[..., :3] = preprocess_normal(aux[..., :3])
    return noisy_log, aux


def denoise_frame(
    apply_fn,
    data: dict[str, np.ndarray],
    tile: int = 64,
    margin: int = 32,
    batch_tiles: int = 8,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Denoise one preprocessed frame dict → linear-HDR output [H, W, 3]
    through the host loop: every tile batch is copied to `device` and run
    by `apply_fn(noisy [N,S,S,3], aux [N,S,S,C]) -> [N,S,S,3]`, and only
    then are the outputs copied back, as the JAX `denoise_frame` does. On a
    card the tiles are pinned once and each batch's copy is `non_blocking`,
    so the host queues every batch's copy and launches ahead of the card.
    (`tools.bench_inference --sync` copies each batch's output back before
    the next batch, for comparison.)"""
    noisy_log, aux = _model_inputs(data)
    noisy_tiles, meta = extract_tiles(noisy_log, tile, margin)
    aux_tiles, _ = extract_tiles(aux, tile, margin)
    n = noisy_tiles.shape[0]
    pad_n = (-n) % batch_tiles
    if pad_n:
        # wrap-around repeat: covers pad_n > n (fewer tiles than a batch)
        reps = np.arange(pad_n) % n
        noisy_tiles = np.concatenate([noisy_tiles, noisy_tiles[reps]], 0)
        aux_tiles = np.concatenate([aux_tiles, aux_tiles[reps]], 0)
    device = torch.device(device)
    noisy_t, aux_t = torch.from_numpy(noisy_tiles), torch.from_numpy(aux_tiles)
    if device.type == "cuda":
        # a pageable copy waits for the card; a pinned one is queued. Both
        # pinned buffers live until the outputs are back on the host.
        noisy_t, aux_t = noisy_t.pin_memory(), aux_t.pin_memory()
    outs = []
    with torch.inference_mode():
        for i in range(0, len(noisy_tiles), batch_tiles):
            outs.append(apply_fn(noisy_t[i : i + batch_tiles].to(device, non_blocking=True),
                                 aux_t[i : i + batch_tiles].to(device, non_blocking=True)))
        out_tiles = np.concatenate([o.float().cpu().numpy() for o in outs], 0)[:n]
    return postprocess_specular(stitch_tiles(out_tiles, meta, tile, margin))


def make_fused_frame_apply(
    apply_fn,
    frame_hw: tuple[int, int],
    tile: int = 64,
    margin: int = 32,
    batch_tiles: int = 8,
    device: torch.device | str = "cuda",
):
    """Build a whole-frame denoiser that keeps the frame on `device`:
    edge-pad, gather each batch of overlapping windows, run the model per
    batch, and write the margin-cropped tiles into the output frame.

    Same windows, batches and edge padding as `denoise_frame`; the
    wrap-around padding tiles are batched FIRST and the originals last,
    so an original tile's output is always the one written last.

    Returns `run(noisy_log [H,W,3] f32, aux [H,W,C] f32) -> [H,W,3] f32`,
    all tensors on `device`, in the model's log space."""
    h, w = frame_hw
    size = tile + 2 * margin
    ht, wt = -(-h // tile), -(-w // tile)
    n = ht * wt
    pad_n = (-n) % batch_tiles
    coords = [(ty * tile, tx * tile) for ty in range(ht) for tx in range(wt)]
    coords = [coords[i % n] for i in range(pad_n)] + coords
    batches = [coords[i : i + batch_tiles] for i in range(0, len(coords), batch_tiles)]
    device = torch.device(device)
    # edge padding as clamped indices of the padded frame's rows/columns
    rows = torch.arange(-margin, ht * tile + margin, device=device).clamp(0, h - 1)
    cols = torch.arange(-margin, wt * tile + margin, device=device).clamp(0, w - 1)
    win = torch.arange(size, device=device)
    # per batch: window row indices [N, S, 1] and column indices [N, 1, S]
    gathers = []
    for batch in batches:
        yx = torch.tensor(batch, device=device)
        gathers.append(((yx[:, :1] + win)[:, :, None], (yx[:, 1:] + win)[:, None, :]))

    def run(noisy_log: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        noisy_p = noisy_log[rows][:, cols]
        aux_p = aux[rows][:, cols]
        out = torch.zeros(ht * tile, wt * tile, noisy_log.shape[-1],
                          dtype=torch.float32, device=device)
        with torch.inference_mode():
            for batch, (iy, ix) in zip(batches, gathers):
                o = apply_fn(noisy_p[iy, ix], aux_p[iy, ix])
                o = o[:, margin : margin + tile, margin : margin + tile].float()
                for i, (y0, x0) in enumerate(batch):
                    out[y0 : y0 + tile, x0 : x0 + tile] = o[i]
        return out[:h, :w]

    return run


def denoise_frame_fused(fused_apply, data: dict[str, np.ndarray],
                        device: torch.device | str = "cuda") -> np.ndarray:
    """`denoise_frame` semantics through a `make_fused_frame_apply`
    program: the host does only the log-space pre/post transforms."""
    noisy_log, aux = _model_inputs(data)
    out_log = fused_apply(
        torch.from_numpy(noisy_log).to(device), torch.from_numpy(aux).to(device),
    )
    return postprocess_specular(out_log.cpu().numpy().astype(np.float32))


def denoise_frame_spatial(sharded_apply, data: dict[str, np.ndarray], n_ranks: int,
                          margin: int = 32, device: torch.device | str = "cuda") -> np.ndarray:
    """Denoise one frame with its rows sharded over `n_ranks` ranks and halo
    exchange between neighbours (`parallel.spatial.make_sharded_apply_rows`,
    built once per run). H is edge-padded to a multiple of 8·n_ranks (each
    strip stays on the attention block grid) and W by `margin` on each side
    plus up to a multiple of 8, as the tiled path sees its borders; with
    `margin` at least the model's receptive reach both paths give the same
    frame. Raises when a strip is shorter than `margin`."""
    noisy_log, aux = _model_inputs(data)
    h, w, _ = noisy_log.shape
    ph = (-h) % (8 * n_ranks)
    strip = (h + ph) // n_ranks
    if strip < margin:
        # the exchange ships `margin` rows a neighbour; a shorter strip has
        # fewer to ship
        raise ValueError(
            f"spatial inference needs per-rank row strips >= margin: frame height {h} over "
            f"{n_ranks} ranks gives {strip}-row strips < margin {margin}; lower "
            "inference.margin, use fewer ranks, or drop inference.spatial for this frame size",
        )
    pad = ((0, ph), (margin, margin + (-w) % 8), (0, 0))
    noisy_p = np.pad(noisy_log, pad, mode="edge")[None]
    aux_p = np.pad(aux, pad, mode="edge")[None]
    with torch.inference_mode():
        out = sharded_apply(torch.from_numpy(noisy_p).to(device),
                            torch.from_numpy(aux_p).to(device))
    out_log = out.float().cpu().numpy()[0, :h, margin:margin + w]
    return postprocess_specular(out_log)


def denoise_frame_sequence(seq_apply, data: dict[str, np.ndarray], n_ranks: int,
                           device: torch.device | str = "cuda") -> np.ndarray:
    """Denoise one frame with its raster-scan token sequence sharded over
    `n_ranks` ranks (`parallel.sequence.make_seq_sharded_apply`): the Mamba
    full-frame path. When the ranks divide the frame height this is the
    unsharded model on the whole frame, up to floating-point reordering. A
    height they do not divide is edge-padded to a multiple first:
    causality keeps the padded rows out of every real row's scan state, but
    the 3×3 conv FFNs after the mixers see the padded rows' activations
    where the unsharded model sees its boundary padding, so the bottom few
    real rows may deviate slightly."""
    noisy_log, aux = _model_inputs(data)
    h = noisy_log.shape[0]
    pad = ((0, (-h) % n_ranks), (0, 0), (0, 0))
    noisy_p = np.pad(noisy_log, pad, mode="edge")[None]
    aux_p = np.pad(aux, pad, mode="edge")[None]
    with torch.inference_mode():
        out = seq_apply(torch.from_numpy(noisy_p).to(device), torch.from_numpy(aux_p).to(device))
    return postprocess_specular(out.float().cpu().numpy()[0, :h])


def tensor2img(image: np.ndarray) -> np.ndarray:
    """HWC linear HDR → tone-mapped uint8, as `pixel_heal_thyself_tpu.utils.
    images.tensor2img` without post-processing. That module imports
    matplotlib when loaded, which the scoring path does not need."""
    img = np.clip(np.maximum(np.asarray(image, np.float64), 0.0) ** (1.0 / 2.2), 0, 1)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def find_frame_pairs(images_dir: str | Path, noisy_spp: int, gt_spp: int):
    noisy_root = Path(images_dir) / f"{noisy_spp}spp"
    gt_root = Path(images_dir) / f"{gt_spp}spp"
    pairs = []
    for f in sorted(os.listdir(gt_root)):
        if not f.endswith(".exr"):
            continue
        # strip only the trailing `_<spp>.exr` — scene names may contain
        # underscores themselves
        stem = f[: -len(".exr")].rsplit("_", 1)[0]
        pairs.append(
            (stem, str(noisy_root / f"{stem}_{noisy_spp}"), str(gt_root / f"{stem}_{gt_spp}")),
        )
    return pairs


def afgsa_kwargs_from_config(cfg) -> dict:
    """`AFGSANet` kwargs from a `Config` (the JAX `AFGSATrainer.
    create_generator` mapping; `use_pallas` selects the kernels)."""
    m = cfg.model
    kernels = bool(cfg.trainer.use_pallas)
    return dict(
        input_channels=m.input_channels, aux_input_channels=m.aux_input_channels,
        base_ch=m.feature_map_channels, enc_ch=m.enc_channels,
        num_sa=m.self_attention.num_layers, block_size=m.self_attention.block_size,
        halo_size=m.self_attention.halo_size, num_heads=m.self_attention.num_heads,
        num_gcp=m.num_gradient_checkpoints,
        padding_mode="replicate" if cfg.trainer.deterministic else "reflect",
        curve_order=m.curve_order, use_film=m.use_film,
        fold_qkv=kernels and cfg.trainer.fold_qkv, use_kernels=kernels,
        use_block_kernel=kernels, dtype=_dtype(cfg),
    )


def mamba_kwargs_from_config(cfg) -> dict:
    """`MambaDenoiserNet` kwargs from a `Config` (the JAX `MambaTrainer.
    create_generator` mapping; `use_pallas` selects the fused interior
    through its kernels; the fused conv stays off, as the JAX trainer
    hard-wires it, `training/trainer.py:641-645`)."""
    m = cfg.model
    kernels = bool(cfg.trainer.use_pallas)
    return dict(
        input_channels=m.input_channels, aux_input_channels=m.aux_input_channels,
        base_ch=m.feature_map_channels, enc_ch=m.enc_channels, num_blocks=m.num_layers,
        d_state=m.d_state, d_conv=m.d_conv, expansion=m.expansion, headdim=m.headdim,
        num_gcp=m.num_gradient_checkpoints,
        padding_mode="replicate" if cfg.trainer.deterministic else "reflect",
        use_kernels=kernels, use_megakernel=kernels, use_pallas=False,
        dtype=_dtype(cfg),
    )


def _dtype(cfg) -> torch.dtype:
    if cfg.trainer.precision not in ("bf16", "fp32"):
        raise ValueError(f"trainer.precision must be 'bf16' or 'fp32', got {cfg.trainer.precision!r}")
    return torch.bfloat16 if cfg.trainer.precision == "bf16" else torch.float32


def load_generator(cfg, device: torch.device | str = "cuda", kernels: bool = True):
    """Build the generator from config and load its weights from
    `trainer.model_path`: the port trainer's checkpoint directory
    (`<run>/model_epochN/state`, `training/checkpoints.py`), a params file
    of `checkpoints.save_params`, or a flat flax params `.npz`
    (tools/export_params_npz.py). `kernels=False` builds the plain route:
    the config's routes through the kernels' plain versions
    (`use_kernels=False`, which also turns `fold_qkv` off)."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet
    from pixel_heal_thyself_tpu_torch.params import (
        afgsa_state_from_flax,
        load_params_npz,
        mamba_state_from_flax,
    )
    from pixel_heal_thyself_tpu_torch.training import checkpoints

    if cfg.model.name == "afgsa":
        kwargs, net, to_state = afgsa_kwargs_from_config(cfg), AFGSANet, afgsa_state_from_flax
    elif cfg.model.name == "mamba":
        kwargs, net, to_state = (mamba_kwargs_from_config(cfg), MambaDenoiserNet,
                                 mamba_state_from_flax)
    else:
        raise ValueError(f"Unsupported model: {cfg.model.name!r}")
    kwargs["use_kernels"] = kwargs["use_kernels"] and kernels
    if kwargs["dtype"] == torch.float32:
        # fp32 is true float32, as the JAX trainer's HIGHEST matmul
        # precision: on the GPU cuDNN convolutions default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = net(**kwargs, device=device)
    path = Path(cfg.trainer.model_path)
    if path.suffix == ".npz":
        state = to_state(load_params_npz(str(path)))
    elif path.is_dir() and not (path / checkpoints.FILE).exists():
        raise ValueError(f"{path} is not a checkpoint of the port's trainer (no "
                         f"{checkpoints.FILE}); export a JAX Orbax checkpoint with "
                         "tools/export_params_npz.py")
    else:
        state = checkpoints.restore_params(path)
    model.load_state_dict(state)
    return model.eval()


def run_inference(
    cfg,
    images_dir: str,
    out_dir: str,
    tile: int = 64,
    margin: int = 32,
    batch_tiles: int = 8,
    noisy_spp: int = 32,
    gt_spp: int = 1024,
    save_exr: bool = False,
    scale: float = 1.0,
    spatial: bool = False,
    from_export: str | None = None,
    fused: bool = True,
    device: torch.device | str = "cuda",
) -> list[dict]:
    """Denoise and score every frame pair under `images_dir` with the
    generator of `cfg` (`load_generator`), or with the serving artifact
    at `from_export` (`serving.load_exported`), whose window and batch
    then set the tile and batch. `spatial` shards each frame over the
    ranks of the process group (one rank without one): every rank must
    call this; rank 0 scores and writes, and returns the results, the
    others return []. Several ranks without `spatial` raise."""
    from pixel_heal_thyself_tpu_torch.data.exr import write_exr_groups
    from pixel_heal_thyself_tpu_torch.metrics import (
        calculate_psnr,
        calculate_rmse,
        calculate_ssim,
    )
    from pixel_heal_thyself_tpu_torch.parallel import is_main_process, process_count

    if from_export:
        # a serving artifact (tools/export_model.py): fixed tile window and
        # batch baked into the graph; no model code or checkpoint
        from pixel_heal_thyself_tpu_torch.serving import load_exported

        if spatial:
            raise ValueError(
                "inference.spatial shards the live model; exported "
                "artifacts serve the tiled path only",
            )
        model, manifest = load_exported(from_export, device)
        window = manifest["window"]
        if window != tile + 2 * margin:
            # honor the artifact's geometry: margin stays as configured
            # (receptive-field coverage), tile absorbs the difference
            new_tile = window - 2 * margin
            if new_tile <= 0:
                raise ValueError(
                    f"artifact window {window} can't cover margin {margin}; "
                    "lower inference.margin or re-export with a larger "
                    "export.window",
                )
            logger.info(
                f"[Infer] artifact window {window}: using tile {new_tile} "
                f"(+2×{margin} margin) instead of configured {tile}",
            )
            tile = new_tile
        if batch_tiles != manifest["batch_tiles"]:
            logger.info(
                f"[Infer] artifact batch_tiles {manifest['batch_tiles']} "
                f"overrides configured {batch_tiles}",
            )
            batch_tiles = manifest["batch_tiles"]
    elif not spatial and process_count() > 1:
        raise ValueError(f"{process_count()} ranks serving the tiled path would each denoise "
                         "every frame: set inference.spatial=true to shard the frames")
    elif spatial:
        from pixel_heal_thyself_tpu_torch.parallel import (
            make_seq_sharded_apply,
            make_sharded_apply_rows,
            row_axis,
        )

        # every rank is a strip of rows whatever parallel.model_axis says:
        # tensor parallelism is a training layout, and the JAX package's
        # sharded serving builds its mesh with model_axis=1 as well
        axis = row_axis()
        model = load_generator(cfg, device)
        if cfg.model.name == "mamba":
            # the global raster scan's receptive field is unbounded, so no
            # halo can cover it: shard the token sequence and chain the
            # state across ranks instead
            sharded = make_seq_sharded_apply(model, axis)
            logger.info(f"[Infer] sequence sharding over {axis.size} rank(s)")
        else:
            sharded = make_sharded_apply_rows(model, margin, axis)
            logger.info(f"[Infer] spatial sharding over {axis.size} rank(s), margin {margin}")
    else:
        model = load_generator(cfg, device)
    main_process = is_main_process()
    if main_process:
        os.makedirs(out_dir, exist_ok=True)

    results = []
    fused_cache: dict[tuple[int, int], object] = {}
    for stem, noisy_path, gt_path in find_frame_pairs(images_dir, noisy_spp, gt_spp):
        start = time.time()
        data = preprocess_data(noisy_path, gt_path, scale=scale)
        if spatial and cfg.model.name == "mamba":
            out_lin = denoise_frame_sequence(sharded, data, axis.size, device=device)
        elif spatial:
            out_lin = denoise_frame_spatial(sharded, data, axis.size, margin=margin,
                                            device=device)
        elif fused:
            hw = data["noisy"].shape[:2]
            if hw not in fused_cache:
                fused_cache[hw] = make_fused_frame_apply(
                    model, hw, tile=tile, margin=margin, batch_tiles=batch_tiles,
                    device=device,
                )
            out_lin = denoise_frame_fused(fused_cache[hw], data, device=device)
        else:
            out_lin = denoise_frame(
                model, data, tile=tile, margin=margin, batch_tiles=batch_tiles,
                device=device,
            )
        if not main_process:
            continue
        gt_lin = data["gt"].astype(np.float64)

        rmse = calculate_rmse(out_lin.astype(np.float64), gt_lin)
        out_255 = tensor2img(out_lin)
        gt_255 = tensor2img(gt_lin)
        psnr = calculate_psnr(out_255, gt_255)
        ssim = calculate_ssim(out_255, gt_255)

        eval_path = Path(out_dir) / f"{stem}_{noisy_spp}_evaluation.txt"
        with open(eval_path, "w") as f:
            f.write(f"RMSE: {rmse:.6f}\nPSNR: {psnr:.4f}\n1-SSIM: {1 - ssim:.6f}\n")
        if save_exr:
            write_exr_groups(
                Path(out_dir) / f"{stem}_{noisy_spp}_denoised.exr",
                {"default": out_lin.astype(np.float32)},
                pixel_type="half",
            )
        logger.info(
            f"[Infer] {stem}: rmse={rmse:.6f} psnr={psnr:.2f} "
            f"1-ssim={1 - ssim:.4f} time={time.time() - start:.1f}s",
        )
        results.append({"scene": stem, "rmse": rmse, "psnr": psnr, "ssim": ssim})
    return results


def main(argv=None) -> None:
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.config.run_dirs import register_run_dirs_resolver

    register_run_dirs_resolver()
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.inference")
    parser.add_argument("-cn", "--config-name", default="default")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    # inference.* overrides are consumed here, the rest go to the config
    infer_opts = {"tile": 64, "margin": 32, "batch_tiles": 8, "save_exr": False,
                  "images_dir": None, "out_dir": None, "noisy_spp": 32,
                  "gt_spp": 1024, "spatial": False, "from_export": None,
                  "fused": True, "device": "cuda"}
    cfg_overrides = []
    for ov in args.overrides:
        key, _, val = ov.partition("=")
        if key.startswith("inference."):
            name = key.split(".", 1)[1]
            cur = infer_opts.get(name)
            infer_opts[name] = (
                val.lower() in ("1", "true", "yes")
                if isinstance(cur, bool)
                else type(cur)(val) if cur is not None else val
            )
        else:
            cfg_overrides.append(ov)

    if torch.device(infer_opts["device"]).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("inference.device=cuda (the default) but no CUDA device is available; "
                         "pass inference.device=cpu to denoise on the CPU")
    cfg = ConfigRegistry.create_config(compose(args.config_name, cfg_overrides))
    logger.setup_logger(cfg.logging.level)
    if not cfg.trainer.model_path and not infer_opts["from_export"]:
        raise SystemExit("set trainer.model_path=<run>/model_epochN/state or a params .npz "
                         "(tools/export_params_npz.py), or inference.from_export=<artifact dir>")
    import torch.distributed as dist

    from pixel_heal_thyself_tpu_torch.parallel import maybe_initialize_distributed, shutdown

    # a process group this call starts, it also ends
    own_group = not dist.is_initialized() and maybe_initialize_distributed(
        cfg.parallel.multihost, infer_opts["device"])
    images_dir = infer_opts["images_dir"] or cfg.data.images.dir
    out_dir = infer_opts["out_dir"] or os.path.join(cfg.paths.output_dir, "inference")
    run_inference(
        cfg,
        images_dir,
        out_dir,
        tile=infer_opts["tile"],
        margin=infer_opts["margin"],
        batch_tiles=infer_opts["batch_tiles"],
        noisy_spp=infer_opts["noisy_spp"],
        gt_spp=infer_opts["gt_spp"],
        save_exr=infer_opts["save_exr"],
        scale=cfg.data.images.scale,
        spatial=infer_opts["spatial"],
        from_export=infer_opts["from_export"],
        fused=infer_opts["fused"],
        device=infer_opts["device"],
    )
    # not on an exception: leaving the group would wait for the other ranks,
    # and the launcher stops them when this one exits
    if own_group:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])

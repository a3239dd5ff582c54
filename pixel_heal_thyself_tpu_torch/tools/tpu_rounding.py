"""A replay of the TPU kernel #5's forward with one-pass bf16 products: how
far a checkpoint's served frames and validation move if every product of
the fused Mamba2 interior rounds its operands once to bf16.

Round 5 served and validated the Mamba denoiser through the Pallas kernel
`pixel_heal_thyself_tpu/ops/ssd_mega.py:256` (`_fwd_kernel_infer`). Every
product in it goes through `_dot` (:85), a `dot_general` of f32 operands
with no `precision`; if the MXU ran those as one bf16 pass, round 5's
numbers carry rounding that neither K7 (3×TF32 on the card) nor JAX on
the CPU has. `bf16_products_chain` is a plain-PyTorch copy of that
interior which follows the JAX kernel's product structure, not the
port's: `cum` is `tril·dA` (:138) rather than a cumsum, the per-head
scalars are expanded as the kernel's selector products do (:143,
:152-155), and the operands of each forward `_dot` site (`tril·dA`, the
`dt` / `exp(cum_last − cum)` / `exp(cum)` / `exp(cum_last)` / `D`
expanders, the scores `Cv·Bv` :146, the intra-chunk sum :180, `Cv·state`
:235, the state update :240) are rounded once to bf16 and summed in f32.
Everything else (the conv, SiLU, softplus, the decay mask, the gated
RMSNorm) stays f32, as in the kernel.

`run` serves a checkpoint through the model twice in one process under
the same arithmetic switches (cuDNN deterministic), once through K7 and
once with `bf16_products_chain` in its place, scoring the frames as
leg 4 of the quality campaign does (`inference.score_frame` over the
channel's training and held-out scenes), and runs the trainer's
validation pass (its 64² patch store) both ways. It reports the change
of the full-frame mean PSNR, of each scene and of the validation PSNR,
the frames' rms deviation from K7's, and whether the change meets the
H1 rule fixed before any run (the served mean lower by 0.2–0.45 dB and
validation by at most a third of that).

A measuring tool only: no config key, model argument or route of the
trainer or `inference.main` reaches it.

    python -m pixel_heal_thyself_tpu_torch.tools.tpu_rounding \\
        --checkpoint RUN/model_epoch12/state [--leg 2b] [--root .] \\
        [--out FILE.json] [--scenes N] [--device cuda|cpu] [override ...]

`--leg` names the quality campaign's leg that trained the checkpoint
(`tools.quality_campaign`: its config, its seed and so its patch store,
its channel's scenes under `--root`/data); overrides are appended to its
command line, as the campaign appends them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch.ops import ssd_mega
from pixel_heal_thyself_tpu_torch.ops.ssd_mega import chain_conv, chain_dims, chain_norm, softplus
from pixel_heal_thyself_tpu_torch.tools import card_line, resolve_device

# the H1 rule: the served mean lower by SERVED_DROP dB, validation by at
# most VAL_SHARE of the served drop
SERVED_DROP = (0.2, 0.45)
VAL_SHARE = 1 / 3


def bf16(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded once to bf16 (to nearest even), held in f32."""
    return t.to(torch.bfloat16).float()


def _expand(v: torch.Tensor, p: int) -> torch.Tensor:
    """A per-head [..., h] value in the [..., h·p] lane layout: the
    kernel's `v·E` with E[h, c] = (c // p == h) (`_expander`, :64)."""
    return v.repeat_interleave(p, dim=-1)


def bf16_products_chain(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> torch.Tensor:
    """`fused_mamba_chain` with the TPU kernel's forward products, each
    `_dot`'s operands rounded once to bf16 and summed in f32: zxbcdt [b,
    l, 2·d_inner + 2·d_state + h] → [b, l, d_inner] in zxbcdt's dtype.
    The chunks run as one batch; the state is carried chunk to chunk."""
    b, l, _, dc, h = chain_dims(zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim)
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    q, nc, p, n, di = chunk, l // chunk, headdim, d_state, d_inner
    zx = zxbcdt.float()
    xbc = F.silu(chain_conv(zx, conv_w, conv_b, di)).reshape(b, nc, q, dc)
    x, Bv, Cv = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = softplus(zx[..., di + dc:] + dt_bias.float()).reshape(b, nc, q, h)
    dA = dt * A.float()
    tril = torch.tril(torch.ones(q, q, device=zx.device))
    cum = tril @ bf16(dA)                                   # :138 [b,nc,q,h]
    cum_last = dA.sum(dim=2, keepdim=True)                  # :140, no product
    xdt = x * _expand(bf16(dt), p)                          # :143
    scores = bf16(Cv) @ bf16(Bv).transpose(-1, -2)          # :146 [b,nc,t,j]
    cumT = cum.transpose(-1, -2)                            # :139 [b,nc,h,q]
    causal = tril.bool()
    diff = cumT[..., :, None] - cumT[..., None, :]
    lmask = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    w3 = scores[:, :, None] * lmask                         # [b,nc,h,t,j]
    del diff, lmask
    d2_exp = _expand(bf16(torch.exp(cum_last - cum)), p)    # :152
    e_exp = _expand(bf16(torch.exp(cum)), p)                # :153
    a_exp = _expand(bf16(torch.exp(cum_last)), p)           # :154 [b,nc,1,di]
    D_exp = _expand(bf16(D.float()), p)                     # :155
    # the intra-chunk sum (:180 `_intra_y`), one head at a time there
    y = torch.einsum("bchtj,bcjhp->bcthp", bf16(w3),
                     bf16(xdt).reshape(b, nc, q, h, p)).reshape(b, nc, q, di)
    del w3
    upd = bf16(Bv).transpose(-1, -2) @ bf16(xdt * d2_exp)   # :240 [b,nc,n,di]
    state = torch.zeros(b, n, di, device=zx.device)
    inter = []
    for c in range(nc):
        inter.append(e_exp[:, c] * (bf16(Cv[:, c]) @ bf16(state)))  # :235
        state = a_exp[:, c] * state + upd[:, c]
    y = y + torch.stack(inter, dim=1) + x * D_exp
    return chain_norm(y.reshape(b, l, di), zx[..., :di], norm_w, zxbcdt.dtype)


@contextlib.contextmanager
def replayed():
    """The Mamba layer's no-grad interior (`ssd_mega.fused_mamba_chain`,
    K7 on the card, or its plain version on the CPU) replaced by
    `bf16_products_chain` while the block runs; yields a list that counts
    the replay's calls."""
    calls: list[int] = []

    def chain(*args, **kwargs):
        calls.append(1)
        return bf16_products_chain(*args, **kwargs)

    with mock.patch.object(ssd_mega, "fused_mamba_chain", chain), \
            mock.patch.object(ssd_mega, "fused_mamba_chain_torch", chain):
        yield calls


def serve(model, pairs: list, device) -> tuple[dict, list]:
    """Each (scene, data) of `pairs` through `model` as leg 4 tiles it
    (tile 64, margin 32, batches of 8): ({scene: (PSNR, 1-SSIM)}, the
    frames)."""
    from pixel_heal_thyself_tpu_torch.inference import (
        denoise_frame_fused,
        make_fused_frame_apply,
        score_frame,
    )

    metrics, frames, applies = {}, [], {}
    for scene, data in pairs:
        hw = data["noisy"].shape[:2]
        if hw not in applies:
            applies[hw] = make_fused_frame_apply(model, hw, device=device)
        out = denoise_frame_fused(applies[hw], data, device=device)
        _, psnr, ssim = score_frame(out, data["gt"])
        metrics[scene] = (psnr, 1 - ssim)
        frames.append(out)
    return metrics, frames


def _frames_rms_rel(got: list, ref: list) -> float:
    """rms(got − ref) / rms(ref) over all frames, in float64."""
    num = sum(float(np.sum((g.astype(np.float64) - r) ** 2)) for g, r in zip(got, ref))
    den = sum(float(np.sum(r.astype(np.float64) ** 2)) for r in ref)
    return math.sqrt(num / den)


def h1_holds(served_delta: float, val_delta: float) -> bool:
    """The H1 rule on one checkpoint: the served mean lower by 0.2–0.45
    dB, validation lower by at most a third of that (or not lower)."""
    drop = -served_delta
    return SERVED_DROP[0] <= drop <= SERVED_DROP[1] and -val_delta <= VAL_SHARE * drop


def run(checkpoint: str | Path, leg: str = "2b", root: str | Path = ".", overrides=(),
        device: str = "cuda", scenes: int | None = None, log=print) -> dict:
    """The checkpoint of the campaign's leg `leg` through K7 and through
    the replay, served over its channel's scenes (the first `scenes` of
    them) and validated on its patch store under `root`; returns the
    record (also logged as JSON)."""
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.config.run_dirs import register_run_dirs_resolver
    from pixel_heal_thyself_tpu_torch.data.preprocessing import preprocess_data
    from pixel_heal_thyself_tpu_torch.inference import find_frame_pairs, load_generator
    from pixel_heal_thyself_tpu_torch.tools import quality_campaign as qc
    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import arithmetic, switches_now
    from pixel_heal_thyself_tpu_torch.training.train_step import make_eval_step
    from pixel_heal_thyself_tpu_torch.training.trainer import MambaTrainer, kernel_launches

    device = resolve_device(device, "tpu_rounding")
    spec = {lg.name: lg for lg in qc.TRAINING + qc.DIAGNOSTIC + qc.SEED_LEGS}[leg]
    if spec.model != "mamba":
        raise ValueError(f"leg {leg} trains {spec.model}: the replay is of the Mamba interior")
    root = Path(root).resolve()
    argv = qc.train_argv(spec, root, overrides, device.type)[:-2]  # no --device
    register_run_dirs_resolver()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(root):
        cfg = ConfigRegistry.create_config(compose(
            argv[1], [*argv[2:], f"trainer.model_path={Path(checkpoint).resolve()}",
                      f"paths.output_dir={tmp}"]))
        model = load_generator(cfg, device)
        trainer = MambaTrainer(cfg, device=device)
        _, val_loader, _, n_val = trainer.setup_dataloaders()
    pairs = []
    for images in qc.channel_dirs(root, spec.channel):
        for stem, noisy, gt in find_frame_pairs(images, 32, 1024):
            pairs.append((stem, preprocess_data(noisy, gt, scale=cfg.data.images.scale)))
    pairs = pairs[:scenes]
    eval_fn = make_eval_step(model)
    result = {}
    # both passes under the same switches, cuDNN deterministic; without
    # the deterministic algorithms the trainer turned on, as before it did
    with arithmetic({**switches_now(), "cudnn_deterministic": True,
                     "deterministic_algorithms": False}):
        for name in ("k7", "replay"):
            before = kernel_launches()
            with replayed() if name == "replay" else contextlib.nullcontext() as calls:
                metrics, frames = serve(model, pairs, device)
                _, val_psnr, val_ssim = trainer.validate(eval_fn, val_loader, n_val)
            result[name] = {
                "scenes": {s: m[0] for s, m in metrics.items()},
                "full_frame_psnr": float(np.mean([m[0] for m in metrics.values()])),
                "full_frame_1_ssim": float(np.mean([m[1] for m in metrics.values()])),
                "val_psnr": val_psnr, "val_1_ssim": 1 - val_ssim,
                "launches": {k: v - before[k] for k, v in kernel_launches().items()
                             if v - before[k]},
                "replay_calls": len(calls) if calls is not None else 0,
                "frames": frames,
            }
    k7, rp = result["k7"], result["replay"]
    frames_rms_rel = _frames_rms_rel(rp.pop("frames"), k7.pop("frames"))
    served = rp["full_frame_psnr"] - k7["full_frame_psnr"]
    val = rp["val_psnr"] - k7["val_psnr"]
    record = {
        "leg": leg, "seed": cfg.seed,
        "checkpoint": os.path.relpath(Path(checkpoint).resolve(), root), "k7": k7, "replay": rp,
        "delta": {"full_frame_psnr": served, "val_psnr": val,
                  "scenes": {s: rp["scenes"][s] - k7["scenes"][s] for s in k7["scenes"]}},
        "frames_rms_rel": frames_rms_rel, "h1_holds": h1_holds(served, val),
        "finite": all(math.isfinite(v) for v in (served, val, frames_rms_rel)),
        "seconds": time.perf_counter() - t0, "card": card_line(device),
    }
    log(json.dumps(record))
    return record


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.tpu_rounding",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True, help="RUN/model_epochN/state")
    parser.add_argument("--leg", default="2b", help="the campaign leg that trained it")
    parser.add_argument("--root", default=".", help="the campaign's root (data/ under it)")
    parser.add_argument("--out", default=None, help="write the record to this JSON file")
    parser.add_argument("--scenes", type=int, default=None, help="serve the first N scenes")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("overrides", nargs="*", help="key=value appended to the leg's")
    args = parser.parse_intermixed_args(argv)
    record = run(args.checkpoint, args.leg, args.root, args.overrides, args.device,
                 args.scenes)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    return record


if __name__ == "__main__":
    main()

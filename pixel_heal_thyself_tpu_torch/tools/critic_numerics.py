"""The bf16 critic's numerics: how far the WGAN-GP discriminator step of a
bf16 critic lies from the same step through the same critic in float32,
under each setting of the card's arithmetic.

For a critic and one batch (`gt`, `fake`, `alpha`), `measure` runs the D
step's parts once through a float32 copy of the critic under true float32
arithmetic (no TF32, no bf16 split-K sums, cuDNN's deterministic
algorithms): the reference. Then it runs them through the bf16 critic under
each setting of `settings()` (`set_switches`) and returns each setting's
deviation from the reference:

- `gp_norm`: the GP's per-sample input-gradient norms (`losses.gp_norms`),
  mean and max relative error;
- `losses`: loss_real, loss_fake, gp, d_loss and the critic gap (mean real
  logit − mean fake logit), each value and its absolute and relative error;
- `d_grad`: D's parameter gradient of d_loss, the rms relative error per
  leaf and over all leaves (`overall`);
- `g_grad`: ∂ loss_g / ∂ output, the adversarial gradient the critic sends
  to G (the G step's, taken here through the same critic), rms relative
  error.

Three more rows: `f32_critic_tf32` (the float32 critic under the trainer's
bf16 arithmetic, where TF32 rounds its products), `trainer_critic` (the
critic as the caller built it, a trainer's `create_discriminator()` say,
in its own dtype, under the trainer's bf16 arithmetic; by default
`tools.prod_critic`, in `models.discriminators.GP_CRITIC_DTYPE`) and
`repeat` (the bf16 critic under the trainer's setting a second time: the
spread of the card's own algorithms between two identical calls).

The critic is `DiscriminatorVGG(128, 64)` at the trainer's seeded init
(seed + 1) or the critic of a trainer checkpoint; the batch is 8 patches of
a patch store's training split, or 8 tiles of 128² of the campaign's first
training scene (the synthetic generator at the campaign's seed, noise 0.5,
512²); `fake` is the prod AFGSANet (bf16, its hand kernels on the card) at
the trainer's seeded init or the checkpoint's, on the batch; `alpha` is
drawn from a CPU generator at `seed`. On the card unless `--device cpu`:

    python -m pixel_heal_thyself_tpu_torch.tools.critic_numerics \\
        [--checkpoint RUN/model_epochN/state] [--patches STORE_DIR] \\
        [--device cuda|cpu] [--save-inputs F.npz] [--out F.json]

The last line printed is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch.losses import gan_loss, gp_norms
from pixel_heal_thyself_tpu_torch.tools import card_line, prod_critic, resolve_device

SEED = 990819  # the configs' seed: G from it, D from seed + 1, as the trainer
GP_W = 10.0  # the schema's gp_loss_w
BATCH, PATCH = 8, 128
# PyTorch's defaults, on which the trainer sets its own switches
TORCH_DEFAULTS = {"tf32": False, "bf16_reduced_reduction": True, "cudnn_deterministic": False,
                  "deterministic_algorithms": False}
TRUE_F32 = {"tf32": False, "bf16_reduced_reduction": False, "cudnn_deterministic": True,
            "deterministic_algorithms": False}


def trainer_setting() -> dict:
    """The switches of a bf16 training run (TF32 on) on PyTorch's defaults,
    as the trainer set them before `trainer.deterministic` took cuDNN's
    deterministic algorithms (`training.trainer.deterministic_algorithms`):
    the setting every reading of this tool was taken under."""
    return {**TORCH_DEFAULTS, "tf32": True}


def set_switches(flags: dict) -> dict:
    """Set the card's arithmetic switches named in `flags` and return their
    values before: `tf32` (cuBLAS's and cuDNN's float32 products in TF32),
    `bf16_reduced_reduction` (cuBLAS may sum a bf16 product's split-K
    partials in bf16), `cudnn_deterministic` (cuDNN's deterministic
    algorithms, no autotuning) and `deterministic_algorithms`
    (`torch.use_deterministic_algorithms`: False, True, or "warn_only" for
    `warn_only=True`). Under deterministic algorithms every convolution
    takes cuDNN's deterministic algorithms whatever `cudnn_deterministic`
    says, so a setting that means PyTorch's defaults names both."""
    old = {}
    for name, on in flags.items():
        if name == "tf32":
            old[name] = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        elif name == "bf16_reduced_reduction":
            old[name] = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
        elif name == "cudnn_deterministic":
            old[name] = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = on
            torch.backends.cudnn.benchmark = False
        elif name == "deterministic_algorithms":
            old[name] = deterministic_algorithms_now()
            torch.use_deterministic_algorithms(bool(on), warn_only=on == "warn_only")
        else:
            raise KeyError(f"unknown arithmetic switch {name!r}")
    return old


def deterministic_algorithms_now() -> bool | str:
    """`torch.use_deterministic_algorithms`' state as `set_switches` names
    it: False, True or "warn_only"."""
    if not torch.are_deterministic_algorithms_enabled():
        return False
    return "warn_only" if torch.is_deterministic_algorithms_warn_only_enabled() else True


def switches_now() -> dict:
    """The switches of `set_switches` as they stand."""
    return {"tf32": torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32,
            "bf16_reduced_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "deterministic_algorithms": deterministic_algorithms_now()}


def settings() -> dict[str, dict]:
    """Each named setting of the card's arithmetic: the trainer's, and it
    with one switch (or all three) moved toward true float32."""
    base = trainer_setting()
    return {
        "trainer": base,
        "a_no_bf16_reduced_reduction": {**base, "bf16_reduced_reduction": False},
        "c_no_tf32": {**base, "tf32": False},
        "b_deterministic_cudnn": {**base, "cudnn_deterministic": True},
        "all_three": {**base, "bf16_reduced_reduction": False, "tf32": False,
                      "cudnn_deterministic": True},
    }


@contextlib.contextmanager
def arithmetic(flags: dict):
    """`set_switches(flags)` while the block runs."""
    benchmark = torch.backends.cudnn.benchmark
    old = set_switches(flags)
    try:
        yield
    finally:
        set_switches(old)
        torch.backends.cudnn.benchmark = benchmark


def with_dtype(critic: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """A copy of `critic` (same parameters) computing in `dtype`."""
    out = copy.deepcopy(critic)
    for m in out.modules():
        if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
            m.dtype = dtype
    return out


def prod_generator(device, state: dict | None = None, seed: int = SEED) -> torch.nn.Module:
    """The prod AFGSANet (bf16; its hand kernels on the card) at the
    trainer's seeded init or with `state`."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs

    kwargs = afgsa_prod_kwargs()
    if torch.device(device).type != "cuda":
        kwargs.update(use_kernels=False, use_block_kernel=False)
    g = AFGSANet(**kwargs, device=device, generator=torch.Generator().manual_seed(seed))
    if state is not None:
        g.load_state_dict(state)
    return g.train()


def scene_batch(n: int = BATCH, patch: int = PATCH) -> dict[str, np.ndarray]:
    """`n` tiles of patch² (row-major from the top left) of the campaign's
    first training scene: the synthetic generator at the campaign's seed
    and noise 0.5, 512², read back as the trainer reads a scene."""
    from pixel_heal_thyself_tpu_torch.data.preprocessing import preprocess_data
    from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset
    from pixel_heal_thyself_tpu_torch.inference import find_frame_pairs
    from pixel_heal_thyself_tpu_torch.tools.quality_campaign import (
        CHANNELS,
        TRAIN_SCENES,
        TRAIN_SEED,
    )

    with tempfile.TemporaryDirectory() as tmp:
        generate_dataset(tmp, scenes=list(TRAIN_SCENES[:1]), height=512, width=512,
                         noise_scale=CHANNELS["clean05"], seed=TRAIN_SEED)
        ((_, noisy, gt),) = find_frame_pairs(tmp, 32, 1024)
        frame = preprocess_data(noisy, gt)
    per_row = frame["gt"].shape[1] // patch
    tiles = [(i // per_row * patch, i % per_row * patch) for i in range(n)]
    return {k: np.stack([frame[k][y:y + patch, x:x + patch] for y, x in tiles]).astype(np.float32)
            for k in ("noisy", "gt", "aux")}


def store_batch(patches_dir: str | Path, n: int = BATCH) -> dict[str, np.ndarray]:
    """The first `n` patches of a patch store's training split."""
    from pixel_heal_thyself_tpu_torch.data.dataset import PatchDataset

    return PatchDataset(Path(patches_dir) / "train").batch(np.arange(n))


@torch.no_grad()
def make_inputs(gen: torch.nn.Module, batch: dict, device, seed: int = SEED) -> dict:
    """The D step's inputs as the train step makes them: `gt` and G's
    output `fake` after `prepare_batch`, and `alpha` [B, 1, 1, 1] float32
    drawn from a CPU generator at `seed`."""
    from pixel_heal_thyself_tpu_torch.ops.transforms import prepare_batch

    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}
    noisy, gt, aux = prepare_batch(t["noisy"], t["gt"], t["aux"])
    fake = gen(noisy, aux)
    alpha = torch.rand((gt.shape[0], 1, 1, 1), generator=torch.Generator().manual_seed(seed))
    return {"gt": gt.float(), "fake": fake.float(), "alpha": alpha.to(device)}


def d_step_parts(critic: torch.nn.Module, inputs: dict, gp_w: float = GP_W) -> dict:
    """The WGAN-GP D step's parts through `critic` (as
    `training.train_step`): the losses, the GP norms, D's parameter
    gradients of d_loss, and ∂ loss_g / ∂ output through the same critic."""
    gt, fake, alpha = inputs["gt"], inputs["fake"], inputs["alpha"]
    critic.zero_grad(set_to_none=True)
    real_logits, fake_logits = critic(gt), critic(fake)
    loss_real = gan_loss(real_logits, True, "wgan")
    loss_fake = gan_loss(fake_logits, False, "wgan")
    norms = gp_norms(critic, gt, fake, alpha=alpha)
    gp = torch.mean((norms - 1.0) ** 2)
    d_loss = (loss_fake + loss_real) / 2.0 + gp_w * gp
    d_loss.backward()
    d_grad = {n: p.grad.detach().float().clone() for n, p in critic.named_parameters()}
    critic.zero_grad(set_to_none=True)
    out = fake.detach().clone().requires_grad_(True)
    (g_grad,) = torch.autograd.grad(gan_loss(critic(out), True, "wgan"), out)
    losses = {"loss_real": loss_real, "loss_fake": loss_fake, "gp": gp, "d_loss": d_loss,
              "gap": real_logits.float().mean() - fake_logits.float().mean()}
    return {"losses": {k: v.item() for k, v in losses.items()},
            "norms": norms.detach().double().cpu(), "d_grad": d_grad,
            "g_grad": g_grad.detach().float()}


def _rms_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    return ((got - ref).pow(2).sum() / ref.pow(2).sum().clamp_min(1e-300)).sqrt().item()


def deviation(got: dict, ref: dict) -> dict:
    """`got`'s parts (`d_step_parts`) against `ref`'s."""
    rel = ((got["norms"] - ref["norms"]).abs() / ref["norms"].abs().clamp_min(1e-300))
    losses = {}
    for k, r in ref["losses"].items():
        g = got["losses"][k]
        losses[k] = {"value": g, "ref": r, "abs_err": abs(g - r),
                     "rel_err": abs(g - r) / max(abs(r), 1e-300)}
    num = sum((got["d_grad"][k].double() - v.double()).pow(2).sum().item()
              for k, v in ref["d_grad"].items())
    den = sum(v.double().pow(2).sum().item() for v in ref["d_grad"].values())
    return {
        "gp_norm": {"mean_rel_err": rel.mean().item(), "max_rel_err": rel.max().item()},
        "losses": losses,
        "d_grad": {"overall": (num / max(den, 1e-300)) ** 0.5,
                   "per_leaf": {k: _rms_rel(got["d_grad"][k], v)
                                for k, v in ref["d_grad"].items()}},
        "g_grad": _rms_rel(got["g_grad"], ref["g_grad"]),
    }


def measure(critic: torch.nn.Module, inputs: dict, names=None, gp_w: float = GP_W) -> dict:
    """Each setting's deviation of the D step through `critic`'s parameters
    in bf16 from the float32 reference (module docstring), by name; `names`
    of `settings()` (all by default), `trainer`, `f32_critic_tf32`,
    `trainer_critic` (`critic` itself, in its own dtype) and `repeat`
    always."""
    table = settings()
    names = list(table) if names is None else list(names)
    d16 = with_dtype(critic, torch.bfloat16)
    d32 = with_dtype(critic, torch.float32)
    with arithmetic(TRUE_F32):
        ref = d_step_parts(d32, inputs, gp_w)
    rows = {}
    with arithmetic(table["trainer"]):
        rows["f32_critic_tf32"] = deviation(d_step_parts(d32, inputs, gp_w), ref)
        d_step_parts(d16, inputs, gp_w)  # a process's first call may take other algorithms
        first = d_step_parts(d16, inputs, gp_w)
        rows["repeat"] = deviation(d_step_parts(d16, inputs, gp_w), first)
        rows["trainer"] = deviation(first, ref)
        rows["trainer_critic"] = deviation(d_step_parts(critic, inputs, gp_w), ref)
    for name in names:
        if name not in rows:
            with arithmetic(table[name]):
                rows[name] = deviation(d_step_parts(d16, inputs, gp_w), ref)
    return {"reference": {**ref["losses"], "gp_norm_mean": ref["norms"].mean().item()},
            "settings": {n: table[n] for n in names}, "rows": rows}


def _checksum(module: torch.nn.Module) -> float:
    return float(sum(p.detach().double().sum().item() for p in module.parameters()))


def run(critic: torch.nn.Module | None = None, gen: torch.nn.Module | None = None,
        batch: dict | None = None, device: str = "cuda", names=None,
        checkpoint: str | Path | None = None, patches: str | Path | None = None,
        save_inputs: str | Path | None = None, seed: int = SEED, log=print) -> dict:
    """`measure` for `critic` (the prod critic by default, `prod_critic`:
    seeded as the trainer seeds it, or D of the trainer `checkpoint`
    directory) on `batch` (numpy noisy/gt/aux: the
    first 8 patches of the store `patches`, or `scene_batch()`) through
    `gen` (the prod AFGSANet: seeded, or G of `checkpoint`). `names`: the
    settings (all on the card; the trainer's alone on the CPU, where the
    switches do nothing). `save_inputs` writes gt, fake and alpha to an
    npz."""
    dev = resolve_device(device, "critic_numerics")
    state = None
    if checkpoint is not None:
        state = torch.load(Path(checkpoint) / "checkpoint.pt", map_location="cpu",
                           weights_only=True)
    if critic is None:
        critic = prod_critic(dev, seed + 1).train()
        if state is not None:
            critic.load_state_dict(state["d"])
    if batch is None:
        batch = store_batch(patches) if patches is not None else scene_batch()
    if gen is None:
        gen = prod_generator(dev, state and state["g"], seed)
    inputs = make_inputs(gen, batch, dev, seed)
    del gen
    if save_inputs is not None:
        np.savez(save_inputs, **{k: v.cpu().numpy() for k, v in inputs.items()})
    if names is None and dev.type != "cuda":
        names = ("trainer",)
    result = measure(critic, inputs, names)
    result.update({
        "device": str(dev), "card": card_line(dev),
        "critic": {"checkpoint": None if checkpoint is None else str(checkpoint),
                   "dtype": str(critic.dtype).removeprefix("torch."),
                   "params": sum(p.numel() for p in critic.parameters()),
                   "checksum": _checksum(critic)},
        "inputs": {"batch": list(inputs["gt"].shape),
                   "source": "store" if patches is not None else "scene",
                   "alpha": inputs["alpha"].flatten().tolist()},
    })
    for name, row in result["rows"].items():
        log(f"[critic_numerics] {name}: gp norms mean {row['gp_norm']['mean_rel_err']:.3e} "
            f"max {row['gp_norm']['max_rel_err']:.3e}; d_loss rel "
            f"{row['losses']['d_loss']['rel_err']:.3e}, gap abs "
            f"{row['losses']['gap']['abs_err']:.3e}; D grad {row['d_grad']['overall']:.3e}; "
            f"G grad {row['g_grad']:.3e}")
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.critic_numerics",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", default=None,
                        help="a trainer checkpoint directory (model_epochN/state): its G and D")
    parser.add_argument("--patches", default=None,
                        help="a patch store directory: the batch from its training split")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--settings", default=None,
                        help="comma-separated names of settings() (default: all on the card)")
    parser.add_argument("--save-inputs", default=None, help="write gt, fake, alpha to this npz")
    parser.add_argument("--out", default=None, help="write the result to this JSON file")
    args = parser.parse_args(argv)
    names = args.settings.split(",") if args.settings else None
    result = run(device=args.device, names=names, checkpoint=args.checkpoint,
                 patches=args.patches, save_inputs=args.save_inputs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

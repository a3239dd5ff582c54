"""The alternating GAN train step (WGAN-GP / RaHinge multiscale), PyTorch.

Port of `pixel_heal_thyself_tpu/training/train_step.py` (behavioural spec:
reference `pht/models/base_trainer.py:369-457`). Per batch: device-side
preprocessing, one generator forward, a discriminator update on the
detached output — WGAN-GP, (fake + real)/2 + gp_w·GP with GP a double
backward through D; or, with the multiscale critic, the relativistic-
average hinge over its three logit maps, no GP, where only the fake
forward writes the spectral norms' `u` (both forwards see the old u, as
in the JAX step) — then a generator update against the *updated* D:
gan_w·GAN (multiscale: RaHinge of the fake predictions against the
updated D's real predictions, taken without gradient) + l1_w·L1
(+ ssim_w·SSIM, + lpips_w·LPIPS when `lpips_params` is given), its
gradient taken through the same generator graph.
Optimizers are Adam(β = (0.9, 0.999), eps 1e-8) with a MultiStepLR-
equivalent schedule counted in optimizer steps (the first update uses
count 0, as optax does).

The generator and discriminator are `nn.Module`s updated in place; the
step returns its losses as 0-dim tensors on the device (no host sync).
The step carries its Adams and schedules as attributes (`g_opt`,
`g_sched`, `d_opt`, `d_sched`), which the trainer gathers into a
`TrainState` to checkpoint and restore.

Over a D × M grid of ranks (`mesh`, `parallel.mesh.Mesh`), what GSPMD does
for the JAX step is explicit. Data parallelism (D > 1): each rank feeds
its rows of the global batch; the critic's BatchNorm statistics, the
RaHinge means and the LPIPS max run over the data group; each loss term is
the rank's share of the global loss (`parallel.data`), and the G and D
gradients are summed over the data group in one flattened all-reduce per
model and optimizer step, so that every rank holds one process's gradient
for the global batch; the returned losses are the global values, equal
on every rank. Tensor parallelism (M > 1): each rank's Adam updates its
shards (`parallel.mesh.ParamShards`; the replicated parameters from the
model group's first rank's gradient), then one all-gather per model
assembles the full parameters. No `DistributedDataParallel`: its reducer
does not follow the GP's `autograd.grad(create_graph=True)`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from pixel_heal_thyself_tpu_torch.losses import (
    gan_loss,
    gradient_penalty,
    l1_loss,
    ra_hinge_gan_loss,
    ssim_loss,
)
from pixel_heal_thyself_tpu_torch.models.discriminators import spectral_norm_update
from pixel_heal_thyself_tpu_torch.models.layers import BatchNorm2d
from pixel_heal_thyself_tpu_torch.models.lpips import lpips_distance, to_lpips_range
from pixel_heal_thyself_tpu_torch.ops.transforms import prepare_batch
from pixel_heal_thyself_tpu_torch.parallel.data import reduce_gradients, share
from pixel_heal_thyself_tpu_torch.parallel.distributed import all_reduce, broadcast
from pixel_heal_thyself_tpu_torch.parallel.mesh import place_state


def multistep_milestone_epochs(epochs: int, lr_milestone: int) -> list[int]:
    """Epoch indices at which the lr halves — torch MultiStepLR parity
    (reference `base_trainer.py:177-181`)."""
    return [i * lr_milestone - 1 for i in range(1, max(1, epochs // lr_milestone))]


def multistep_schedule(base_lr: float, milestone_epochs: list[int], gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """count → base_lr · gamma ** #(count ≥ m · steps_per_epoch)."""
    bounds = [m * steps_per_epoch for m in milestone_epochs]

    def schedule(count: int) -> float:
        return base_lr * gamma ** sum(count >= b for b in bounds)

    return schedule


@dataclass(frozen=True)
class LossesConfig:
    """The loss weights and switches the step reads; the defaults are the
    JAX package's `config.schema.LossesConfig` defaults (held against them
    in tests/test_torch_port_train_step.py)."""

    l1_loss_w: float = 1.0
    gan_loss_w: float = 0.005
    gp_loss_w: float = 10.0
    use_ssim_loss: bool = False
    ssim_loss_w: float = 0.1
    use_lpips_loss: bool = False
    lpips_loss_w: float = 0.1


@dataclass(frozen=True)
class OptimizerSpec:
    """Adam with the MultiStep schedule, not yet bound to parameters (the
    counterpart of the optax transformation `make_optimizer` returns in
    the JAX package)."""

    lr: float
    milestone_epochs: tuple[int, ...]
    gamma: float
    steps_per_epoch: int
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8

    def build(self, params) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
        """Adam over `params` and a per-step LambdaLR (step it after each
        optimizer step)."""
        opt = torch.optim.Adam(params, lr=self.lr, betas=self.betas, eps=self.eps)
        sched = multistep_schedule(1.0, list(self.milestone_epochs), self.gamma,
                                   self.steps_per_epoch)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


@dataclass
class TrainState:
    """Everything a resumed run needs: both networks, both Adams with
    their schedules, and the generator the GP interpolation weights are
    drawn from (None when the caller supplies them); under tensor
    parallelism, each network's `parallel.mesh.ParamShards`, whose leaves
    the Adams update."""

    g: torch.nn.Module
    d: torch.nn.Module
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    g_sched: torch.optim.lr_scheduler.LambdaLR
    d_sched: torch.optim.lr_scheduler.LambdaLR
    generator: torch.Generator | None = None
    g_shards: object | None = None
    d_shards: object | None = None


def make_optimizer(lr: float, milestone_epochs: list[int], gamma: float,
                   steps_per_epoch: int, betas=(0.9, 0.999), eps: float = 1e-8,
                   ) -> OptimizerSpec:
    return OptimizerSpec(lr, tuple(milestone_epochs), gamma, steps_per_epoch,
                         tuple(betas), eps)


def make_train_step(g_model: torch.nn.Module, d_model: torch.nn.Module, losses_cfg,
                    use_multiscale: bool, g_tx: OptimizerSpec, d_tx: OptimizerSpec,
                    lpips_params: dict | None = None, mesh=None) -> Callable:
    """Build the alternating G/D update: `step(batch, *, alpha=None,
    generator=None) → {g_loss, d_loss, g_gan, g_l1}`, with its optimizers
    and schedules as `step.g_opt`, `step.g_sched`, `step.d_opt` and
    `step.d_sched`. `losses_cfg` is a `LossesConfig` (or any object with
    its fields). `use_multiscale` takes the RaHinge step (for
    `MultiScaleDiscriminator`). LPIPS is used when `losses_cfg` asks for
    it and `lpips_params` (`models.lpips`, on the models' device) is not
    None, as in the JAX step.

    `batch` holds NHWC `noisy` [B,H,W,3], `gt` [B,H,W,3] and `aux`
    [B,H,W,7] on the models' device: this rank's rows of the global batch
    under a `mesh` (`parallel.mesh.make_mesh`; the critic then takes the
    mesh's data group, `data_group=`). `alpha` [global B,1,1,1] are the GP
    interpolation weights of the global batch, drawn from `generator` when
    None (WGAN-GP only). `step.g_shards`/`step.d_shards` are the tensor-
    parallel layouts (None at model_axis 1); `step.comm_seconds` adds up
    the host seconds spent in the gradient and parameter collectives."""
    gan_w = float(losses_cfg.gan_loss_w)
    l1_w = float(losses_cfg.l1_loss_w)
    gp_w = float(losses_cfg.gp_loss_w)
    use_ssim = bool(losses_cfg.use_ssim_loss)
    ssim_w = float(losses_cfg.ssim_loss_w)
    use_lpips = bool(losses_cfg.use_lpips_loss) and lpips_params is not None
    lpips_w = float(losses_cfg.lpips_loss_w)
    group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group
    if group is not None and any(m.data_group is not group for m in d_model.modules()
                                 if isinstance(m, BatchNorm2d)):
        raise ValueError("the critic's BatchNorm layers must take the mesh's data group "
                         "(data_group=mesh.data_group): per-rank statistics differ from the "
                         "global batch's")
    g_named = [(n, p) for n, p in g_model.named_parameters() if p.requires_grad]
    d_named = list(d_model.named_parameters())
    g_params, d_params = [p for _, p in g_named], [p for _, p in d_named]
    g_shards, d_shards = place_state(g_named, mesh), place_state(d_named, mesh)
    g_opt, g_sched = g_tx.build(g_params if g_shards is None else g_shards.leaves)
    d_opt, d_sched = d_tx.build(d_params if d_shards is None else d_shards.leaves)

    def update(params, shards, opt, sched) -> None:
        """Sum the gradients over the data group, step this rank's Adam
        (its shards under tensor parallelism), assemble the parameters."""
        if group is not None or shards is not None:
            if params[0].is_cuda:  # the staged collectives wait for the backward anyway
                torch.cuda.synchronize(params[0].device)
            t0 = time.perf_counter()
            reduce_gradients(params, group)
            if shards is not None:
                shards.shard_grads()
            train_step.comm_seconds += time.perf_counter() - t0
        opt.step()
        sched.step()
        if shards is not None:
            t0 = time.perf_counter()
            shards.gather()
            train_step.comm_seconds += time.perf_counter() - t0

    def zero_grads(params, opt) -> None:
        opt.zero_grad(set_to_none=True)
        for p in params:  # the full parameters' under tensor parallelism
            p.grad = None

    def train_step(batch: dict, *, alpha: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> dict:
        noisy, gt, aux = prepare_batch(batch["noisy"], batch["gt"], batch["aux"])
        # one generator forward serves the D step (detached) and the G step
        output = g_model(noisy, aux)
        fake = output.detach()

        # ---- discriminator update ---------------------------------------
        zero_grads(d_params, d_opt)
        if use_multiscale:
            # the real forward first: both read the old u, and the fake
            # forward alone writes the new one
            pred_real = d_model(gt)
            with spectral_norm_update(d_model):
                pred_fake = d_model(fake)
            d_loss = ra_hinge_gan_loss(pred_real, pred_fake, group)
        else:
            loss_real = share(gan_loss(d_model(gt), True, "wgan"), group)
            loss_fake = share(gan_loss(d_model(fake), False, "wgan"), group)
            gp = gradient_penalty(d_model, gt, fake, alpha=alpha, generator=generator,
                                  group=group)
            d_loss = (loss_fake + loss_real) / 2.0 + gp_w * gp
        d_loss.backward()
        update(d_params, d_shards, d_opt, d_sched)

        # ---- generator update against the updated D ---------------------
        zero_grads(g_params, g_opt)
        if use_multiscale:
            pred_g_fake = d_model(output)
            with torch.no_grad():
                pred_d_real = d_model(gt)
            # reference base_trainer.py:417-420: (fake preds, no-grad real preds)
            loss_g = ra_hinge_gan_loss(pred_g_fake, pred_d_real, group)
        else:
            loss_g = share(gan_loss(d_model(output), True, "wgan"), group)
        loss_l1 = share(l1_loss(output, gt), group)
        g_loss = gan_w * loss_g + l1_w * loss_l1
        if use_ssim:
            g_loss = g_loss + ssim_w * share(ssim_loss(output, gt), group)
        if use_lpips:
            g_loss = g_loss + lpips_w * share(torch.mean(lpips_distance(
                lpips_params, to_lpips_range(output, group), to_lpips_range(gt, group))), group)
        g_loss.backward(inputs=g_params)  # D's parameters take no gradient
        update(g_params, g_shards, g_opt, g_sched)
        losses = {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
                  "g_gan": loss_g.detach(), "g_l1": loss_l1.detach()}
        if group is None and model_group is None:
            return losses
        # the global values, equal on every rank: the ranks' shares summed,
        # as the model group's first rank has them
        out = torch.stack(list(losses.values())).float()
        if group is not None:
            out = all_reduce(out, dist.ReduceOp.SUM, group)
        if model_group is not None:
            out = broadcast(out, 0, model_group)
        return dict(zip(losses, out.unbind()))

    train_step.g_opt, train_step.g_sched = g_opt, g_sched
    train_step.d_opt, train_step.d_sched = d_opt, d_sched
    train_step.g_shards, train_step.d_shards = g_shards, d_shards
    train_step.comm_seconds = 0.0
    return train_step


def make_eval_step(g_model: torch.nn.Module) -> Callable:
    """Validation forward: gt stays linear (reference :536-547).
    `eval_step(batch) → (output, noisy, gt)`."""

    @torch.no_grad()
    def eval_step(batch: dict):
        noisy, gt, aux = prepare_batch(batch["noisy"], batch["gt"], batch["aux"],
                                       log_gt=False)
        return g_model(noisy, aux), noisy, gt

    return eval_step

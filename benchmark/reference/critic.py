"""Plain reference of the WGAN-GP critic (DiscriminatorVGG) and the GAN step.

DiscriminatorVGG(in 3, base_nf, input_size): a 3×3 conv with LeakyReLU,
then log2(input_size / 4) stages of (3×3 stride-1 conv to min(base_nf·2^(i+1),
base_nf·8) channels, 4×4 stride-2 conv), each with batch norm and
LeakyReLU(0.2), zero padding 1; the NHWC-flattened map → Dense(100) →
LeakyReLU → Dense(1).

`GanStep` is one step of the generator's WGAN-GP + L1 training, as the
program composes it: the batch log-mapped (log(x + 1) of noisy and gt) with
the normals remapped ((n + 1)/2, clipped to [0, 1]); one generator forward;
the critic's update on the detached output, (D(fake) − D(real))/2 +
gp_w·GP with GP the mean of (‖∇ₓD(x̂)‖ − 1)² at x̂ = α·fake + (1 − α)·real;
then the generator's update against the updated critic, gan_w·(−D(out)) +
l1_w·|out − gt|. Both optimizers are `torch.optim.Adam` with the MultiStep
schedule counted in steps (the lr halves at each milestone epoch's first
step).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference.nn import Arith, ConvBlock, act, fan_in_bound, param


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        param(self, "weight", (cout, cin), fan_in_bound(cin))
        param(self, "bias", (cout,), fan_in_bound(cin))

    def forward(self, x: torch.Tensor, arith: Arith) -> torch.Tensor:
        return arith.linear(x, self.weight) + self.bias


class DiscriminatorVGG(nn.Module):
    def __init__(self, in_nc: int = 3, base_nf: int = 64, input_size: int = 128) -> None:
        super().__init__()
        blocks = [ConvBlock(in_nc, base_nf, 3, padding=1, act_type="leakyrelu")]
        nf = base_nf
        stages = int(math.log2(input_size / 4))
        for i in range(stages):
            nxt = min(base_nf * 2 ** (i + 1), base_nf * 8)
            blocks.append(ConvBlock(nf, nxt, 3, padding=1, norm=True, act_type="leakyrelu"))
            blocks.append(ConvBlock(nxt, nxt, 4, stride=2, padding=1, norm=True,
                                    act_type="leakyrelu"))
            nf = nxt
        self.blocks = nn.ModuleList(blocks)
        side = input_size // 2 ** stages
        self.dense0 = Dense(nf * side * side, 100)
        self.dense1 = Dense(100, 1)

    def forward(self, x: torch.Tensor, arith: Arith) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, arith)
        x = act(self.dense0(x.reshape(x.shape[0], -1), arith), "leakyrelu")
        return self.dense1(x, arith)


def prepare(batch: dict) -> tuple:
    """(noisy, gt, aux) of a raw batch as the step takes them."""
    aux = batch["aux"].float()
    aux = torch.cat([((aux[..., :3] + 1.0) * 0.5).clamp(0.0, 1.0), aux[..., 3:]], dim=-1)
    return torch.log1p(batch["noisy"].float()), torch.log1p(batch["gt"].float()), aux


class GanStep:
    """The reference's train step over generator `g` and critic `d`,
    computing G's products in `g_arith` and D's in `d_arith`. `opt` holds
    lr_g, lr_d, betas, eps, milestone_epochs, gamma and steps_per_epoch;
    `losses` gan_w, l1_w and gp_w."""

    def __init__(self, g: nn.Module, d: nn.Module, opt: dict, losses: dict,
                 g_arith: Arith, d_arith: Arith) -> None:
        self.g, self.d, self.losses = g, d, losses
        self.g_arith, self.d_arith = g_arith, d_arith
        bounds = [m * opt["steps_per_epoch"] for m in opt["milestone_epochs"]]

        def schedule(count: int) -> float:
            return opt["gamma"] ** sum(count >= b for b in bounds)

        def adam(params, lr):
            o = torch.optim.Adam(params, lr=lr, betas=tuple(opt["betas"]), eps=opt["eps"])
            return o, torch.optim.lr_scheduler.LambdaLR(o, schedule)

        self.g_params = list(g.parameters())
        self.d_params = list(d.parameters())
        self.g_opt, self.g_sched = adam(self.g_params, opt["lr_g"])
        self.d_opt, self.d_sched = adam(self.d_params, opt["lr_d"])

    def __call__(self, batch: dict, alpha: torch.Tensor) -> dict:
        """One step; returns the losses, the generator's output, and the norm
        of each parameter's gradient as its optimizer took it (nan where it
        took none), in `parameters()` order."""
        noisy, gt, aux = prepare(batch)
        w = self.losses
        out = self.g(noisy, aux, self.g_arith)
        fake = out.detach()
        self.d_opt.zero_grad(set_to_none=True)
        loss_real = -self.d(gt, self.d_arith).mean()
        loss_fake = self.d(fake, self.d_arith).mean()
        interp = (alpha * fake + (1 - alpha) * gt).requires_grad_(True)
        (grad,) = torch.autograd.grad(self.d(interp, self.d_arith).sum(), interp,
                                      create_graph=True)
        gp = ((grad.reshape(grad.shape[0], -1).norm(dim=1) - 1.0) ** 2).mean()
        d_loss = (loss_fake + loss_real) / 2.0 + w["gp_w"] * gp
        d_loss.backward(inputs=self.d_params)
        d_norms = grad_norms(self.d_params)
        self.d_opt.step()
        self.d_sched.step()
        self.g_opt.zero_grad(set_to_none=True)
        g_loss = (w["gan_w"] * -self.d(out, self.d_arith).mean()
                  + w["l1_w"] * (out - gt).abs().mean())
        g_loss.backward(inputs=self.g_params)
        g_norms = grad_norms(self.g_params)
        self.g_opt.step()
        self.g_sched.step()
        return {"g_loss": float(g_loss.detach()), "d_loss": float(d_loss.detach()), "g_out": fake,
                "g_grad_norms": g_norms, "d_grad_norms": d_norms}


def grad_norms(params) -> list:
    """The norm of each parameter's gradient (nan where it has none)."""
    nan = torch.tensor(float("nan"))
    return torch.stack([nan.to(p.device) if p.grad is None else p.grad.norm()
                        for p in params]).tolist()

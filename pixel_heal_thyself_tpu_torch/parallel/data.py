"""Differentiable reductions over the data group of data-parallel training.

No JAX module corresponds: under GSPMD the global batch is one array and
XLA inserts the cross-device sums where the program reduces over it. Here
each rank of a data group holds its rows of every global batch, and every
quantity of the whole batch is reduced explicitly: the critics' BatchNorm
statistics (`global_sum`), the RaHinge mean logits (`batch_mean`), the
LPIPS normalisation (`global_max`) and the gradients (`reduce_gradients`).

`group` None is one rank with no process group: each function then
returns the local value, computed as the one-process code computes it.

The rule for losses: each rank computes its share of the global loss (its
rows' sum over the global count) and back-propagates that share alone; the
shares sum to the global loss. A reduction inside the loss passes the
other ranks' gradients back to this rank in its backward: the backward of
a SUM all-reduce is the SUM all-reduce of the ranks' upstream gradients,
itself differentiable, so the WGAN-GP double backward runs through it.
Summing the ranks' parameter gradients (`reduce_gradients`) then gives
one process's gradient for the global batch. Every rank issues every
collective, forward and backward, in the same order with the same shapes:
the ranks run one graph.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pixel_heal_thyself_tpu_torch.parallel.distributed import all_reduce, flattened


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return _Sum.apply(grad, ctx.group), None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed elementwise over the ranks of `group`, with the sum's
    gradient (any order of differentiation)."""
    return x if group is None else _Sum.apply(x, group)


def batch_mean(x: torch.Tensor, group, dims=(0, 1, 2)) -> torch.Tensor:
    """The mean of `x` over `dims` (keepdim) across the ranks' rows: the
    local `mean` without a group."""
    if group is None:
        return x.mean(dim=dims, keepdim=True)
    count = 1
    for d in dims:
        count *= x.shape[d]
    return global_sum(x.sum(dim=dims, keepdim=True), group) / (count * group_size(group))


def share(loss: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from the mean
    over its own rows (every rank holds as many)."""
    return loss if group is None else loss / group_size(group)


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = all_reduce(x.detach().amax().float(), dist.ReduceOp.MAX, group).to(x.dtype)
        mask = x.detach() == m
        ties = all_reduce(mask.sum().float(), dist.ReduceOp.SUM, group)
        ctx.group = group
        ctx.save_for_backward(mask, ties)
        return m

    @staticmethod
    def backward(ctx, grad):
        mask, ties = ctx.saved_tensors
        # every rank's loss reads the one max: their gradients sum
        total = all_reduce(grad.float(), dist.ReduceOp.SUM, ctx.group)
        return (mask * (total / ties)).to(grad.dtype), None


def global_max(x: torch.Tensor, group) -> torch.Tensor:
    """The largest element of `x` over every rank. Its gradient goes to the
    elements equal to it, split evenly over all of them on every rank, as
    `torch.amax` splits it over ties; without a group, `x.max()`."""
    return x.max() if group is None else _Max.apply(x, group)


def reduce_gradients(params, group) -> None:
    """Sum the `.grad` of `params` over `group` in one flattened all-reduce,
    in the order given. Parameters without a gradient are left out; the
    same ones on every rank, since every rank runs the same graph."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        flattened(grads, lambda flat: all_reduce(flat, dist.ReduceOp.SUM, group))

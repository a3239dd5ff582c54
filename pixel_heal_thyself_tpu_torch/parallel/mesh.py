"""The rank grid of multi-GPU training and the row axis of sharded serving.

Port of `pixel_heal_thyself_tpu/parallel/mesh.py` over `torch.distributed`.
One rank is one process on one device, so the JAX package's ('data',
'model') device mesh becomes a D × M grid of ranks (`make_mesh`, `Mesh`):
rank r sits at data index r // M and model index r % M, the rank-major
order in which JAX lays `jax.devices()` out. Each rank has two process
groups, made with `dist.new_group` in one order on every rank: its data
group (the D ranks of its model index: the batch statistics and the
gradient sums) and its model group (the M ranks of its data index: the
parameter shards).

Tensor parallelism (`model_axis` = M > 1). JAX shards a parameter leaf
whose `ndim` ≥ 2 and whose last axis divides by M over 'model', and the
Adam moments with it (`make_param_shardings`, `opt_state_shardings`);
GSPMD gathers what the computation needs. The port makes that explicit
(`place_state` → `ParamShards`): each rank of a model group keeps its 1/M
of the output channels of each such parameter as the leaf its Adam
updates, so it holds only that share of the parameter and its moments.
The modules keep the full tensors for the forward, assembled by one
flattened all-gather over the model group after every optimizer step.
Adam is elementwise, so a shard's update equals the same elements of the
full update. The ranks of a model group compute the same rows, but cuDNN
and the atomics of some kernels need not give them the same bits: each
shard is therefore updated from its owner's gradient alone, and the
replicated parameters from the gradient of the group's first rank, sent
to the others (one flattened broadcast), so that every rank's parameters
and moments stay equal. Which torch dim is flax's last axis (`shard_dim`):
- dim 0 of every 4-d parameter: conv kernels in OIHW, flax HWIO (the
  model convs, AFGSA's q/k/v kernels, the critics' convs and SNConvs);
- dim 0 of a 2-d `weight`: `nn.Linear` and the critics' `Dense`, [out,
  in], flax [in, out];
- dim 1 of every other 2-d parameter, which the port keeps in the JAX
  layout: AFGSA's `rel_h`/`rel_w` [window, head_ch // 2] and Mamba's
  `conv1d_weight` [d_conv, conv_dim];
- 1-d parameters (biases, norms, `A_log`, `dt_bias`, `D`) replicate.

Serving shards a frame's rows over every rank (`RowAxis`, `row_axis`),
whatever `parallel.model_axis` says, as the JAX package's sharded serving
builds its mesh with model_axis=1. `auto_data_axis` is the JAX function
as is.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from pixel_heal_thyself_tpu_torch.parallel.distributed import (
    all_gather,
    broadcast,
    flattened,
    neighbour_exchange,
    process_count,
    process_index,
)


@dataclass(frozen=True)
class RowAxis:
    """`size` ranks, this rank's `index` among them, and their process
    `group`; `group` None is one rank with no process group (the JAX
    package's one-device mesh), where the collectives are local."""

    size: int = 1
    index: int = 0
    group: object | None = None

    def exchange(self, to_next: torch.Tensor | None, to_prev: torch.Tensor | None):
        """(from_prev, from_next) of `distributed.neighbour_exchange`."""
        if self.group is None:
            return None, None
        return neighbour_exchange(to_next, to_prev, self.group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape], every rank's `t` in rank order."""
        if self.group is None:
            return t[None]
        return all_gather(t, self.group)


def row_axis(group=None) -> RowAxis:
    """The row axis over `group` (default: every rank of the process
    group), or one rank when no process group is initialised."""
    if not dist.is_initialized():
        return RowAxis()
    group = dist.group.WORLD if group is None else group
    return RowAxis(dist.get_world_size(group), dist.get_rank(group), group)


def auto_data_axis(n_devices: int, model_axis: int, batch_size: int) -> int:
    """Largest DP degree that divides the global batch and fits the mesh.

    `ParallelConfig.data_axis=-1` resolves through this: an 8-chip host with
    batch 8 trains 8-way DP out of the box; a batch-2 CI run on the same
    host degrades to 2-way instead of failing the divisibility check.
    """
    cap = max(1, n_devices // max(1, model_axis))
    best = 1
    for cand in range(1, cap + 1):
        if batch_size % cand == 0:
            best = cand
    return best


@dataclass(frozen=True)
class Mesh:
    """A D × M grid of ranks (module docstring): this rank's `data_index`
    and `model_index`, and its `data_group` and `model_group`, each None
    where its axis has one rank (no collective runs over it)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: object | None = None
    model_group: object | None = None

    @property
    def size(self) -> int:
        return self.data * self.model


def make_mesh(data_axis: int = -1, model_axis: int = 1, batch_size: int | None = None) -> Mesh:
    """The D × M grid over every rank of the process group (one rank with
    none). `data_axis` -1 resolves through `auto_data_axis` over the world
    size and `batch_size` (all ranks over `model_axis` without one). Raises
    when the grid does not cover the world: a rank outside it would have
    no rows to train."""
    world, rank = process_count(), process_index()
    if data_axis == -1:
        data_axis = (auto_data_axis(world, model_axis, batch_size) if batch_size
                     else max(1, world // model_axis))
    if data_axis < 1 or model_axis < 1 or data_axis * model_axis != world:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} covers {data_axis * model_axis} of {world} "
            "rank(s); set parallel.data_axis and parallel.model_axis so that data * model "
            "equals the number of ranks (or raise trainer.batch_size)",
        )
    data_groups = model_groups = None
    if world > 1:  # every rank makes every group, in one order
        if data_axis > 1:
            data_groups = [dist.new_group([d * model_axis + m for d in range(data_axis)])
                           for m in range(model_axis)]
        if model_axis > 1:
            model_groups = [dist.new_group([d * model_axis + m for m in range(model_axis)])
                            for d in range(data_axis)]
    d, m = divmod(rank, model_axis)
    return Mesh(data_axis, model_axis, d, m,
                None if data_groups is None else data_groups[m],
                None if model_groups is None else model_groups[d])


def shard_dim(name: str, p: torch.Tensor) -> int | None:
    """The torch dim of parameter `name` that holds flax's last axis
    (module docstring), or None for a parameter JAX never shards."""
    if p.dim() == 4:
        return 0
    if p.dim() == 2:
        return 0 if name.rsplit(".", 1)[-1] == "weight" else 1
    return None


def make_param_shardings(named_params, model_axis: int) -> dict:
    """{parameter name: the dim sharded over the model group, or None to
    replicate} for `named_params` ((name, parameter) pairs, such as
    `module.named_parameters()`): JAX's rule, ndim ≥ 2 and flax's last axis
    divisible by `model_axis`; everything replicates at `model_axis` 1."""
    out = {}
    for name, p in named_params:
        dim = shard_dim(name, p) if model_axis > 1 else None
        out[name] = dim if dim is not None and p.shape[dim] % model_axis == 0 else None
    return out


class ParamShards:
    """One module's trained parameters over a model group (module
    docstring). `leaves[i]` is what the optimizer updates for `params[i]`:
    a leaf holding this rank's slice of it when `dims[i]` is a dim, else
    the parameter itself (replicated: every rank of the group updates it
    from the group's first rank's gradient)."""

    def __init__(self, named_params: list, shardings: dict, mesh: Mesh) -> None:
        self.group, self.size, self.index = mesh.model_group, mesh.model, mesh.model_index
        self.params = [p for _, p in named_params]
        self.dims = [shardings[name] for name, _ in named_params]
        self.leaves = [p if dim is None else
                       torch.nn.Parameter(self._slice(p.detach(), dim).clone())
                       for p, dim in zip(self.params, self.dims)]

    def _slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def _sharded(self):
        return [(i, p, leaf, dim) for i, (p, leaf, dim) in
                enumerate(zip(self.params, self.leaves, self.dims)) if dim is not None]

    def shard_grads(self) -> None:
        """Each leaf's gradient: its slice of its parameter's (reduced)
        gradient; the replicated parameters' gradients are the group's
        first rank's (module docstring)."""
        for _, p, leaf, dim in self._sharded():
            leaf.grad = None if p.grad is None else self._slice(p.grad, dim).clone()
        grads = [p.grad for p, dim in zip(self.params, self.dims)
                 if dim is None and p.grad is not None]
        if grads:
            flattened(grads, lambda flat: broadcast(flat, 0, self.group))

    def _gather(self, tensors: list, dims: list) -> list:
        """Each rank's `tensors[i]` concatenated along `dims[i]` in rank
        order, by one flattened all-gather."""
        if not tensors:
            return []
        full = all_gather(torch.cat([t.reshape(-1) for t in tensors]), self.group)
        out, offset = [], 0
        for t, dim in zip(tensors, dims):
            n = t.numel()
            out.append(torch.cat([full[r, offset:offset + n].view(t.shape)
                                  for r in range(self.size)], dim))
            offset += n
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """Assemble every sharded parameter from the ranks' leaves."""
        sharded = self._sharded()
        full = self._gather([leaf.detach() for *_, leaf, _ in sharded], [d for *_, d in sharded])
        for (_, p, _, _), value in zip(sharded, full):
            p.copy_(value)

    @torch.no_grad()
    def reshard(self) -> None:
        """The leaves from the full parameters (after a restore)."""
        for _, p, leaf, dim in self._sharded():
            leaf.copy_(self._slice(p, dim))

    def full_optimizer_state(self, opt: torch.optim.Optimizer) -> dict:
        """`opt.state_dict()` as one process's optimizer over the full
        parameters holds it: each sharded moment gathered from the ranks
        (a collective: every rank of the group calls it)."""
        sd = opt.state_dict()
        state = {i: dict(s) for i, s in sd["state"].items()}
        jobs = [(i, key, dim) for i, _, _, dim in self._sharded() if i in state
                for key, v in sorted(state[i].items()) if v.dim() > 0]
        full = self._gather([state[i][key] for i, key, _ in jobs], [dim for *_, dim in jobs])
        for (i, key, _), value in zip(jobs, full):
            state[i][key] = value
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_full_optimizer_state(self, opt: torch.optim.Optimizer, sd: dict) -> None:
        """Load a full optimizer state (`full_optimizer_state`'s form) into
        `opt`, each sharded moment cut to this rank's slice."""
        dims = dict((i, dim) for i, _, _, dim in self._sharded())
        state = {}
        for i, s in sd["state"].items():
            i = int(i)
            state[i] = {key: (self._slice(v, dims[i]).clone() if i in dims and v.dim() > 0 else v)
                        for key, v in s.items()}
        opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def place_state(named_params: list, mesh: Mesh | None):
    """The model-group layout of `named_params` ([(name, parameter)], the
    order the optimizer takes them in): a `ParamShards`, or None without
    tensor parallelism (M = 1), where every rank keeps every parameter."""
    if mesh is None or mesh.model == 1:
        return None
    return ParamShards(named_params, make_param_shardings(named_params, mesh.model), mesh)

"""The row axis of sharded serving over a `torch.distributed` process group.

Port of the part of `pixel_heal_thyself_tpu/parallel/mesh.py` that
serving uses. The JAX package shards a frame's rows over the 'data' axis
of a device mesh; here the axis is a process group, one rank per strip
of rows, and `RowAxis` carries what `jax.lax.axis_size`/`axis_index` and
the collectives give inside a `shard_map`. `auto_data_axis` is the JAX
function as is. Parameter and optimizer-state shardings wait for
multi-GPU training and tensor parallelism (ROADMAP.md Queue 1, items 9b
and 9c).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from pixel_heal_thyself_tpu_torch.parallel.distributed import all_gather, neighbour_exchange


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


def row_axis(group=None, model_axis: int = 1) -> RowAxis:
    """The row axis over `group` (default: every rank of the process
    group), or one rank when no process group is initialised.
    `model_axis` > 1 (tensor parallelism) is not ported."""
    if model_axis > 1:
        raise NotImplementedError(
            f"parallel.model_axis={model_axis}: tensor parallelism is not ported to "
            "pixel_heal_thyself_tpu_torch yet (ROADMAP.md Queue 1, item 9c)",
        )
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

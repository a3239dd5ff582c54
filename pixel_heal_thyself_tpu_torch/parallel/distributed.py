"""Process groups of `torch.distributed` and the collectives of sharded serving.

Port of `pixel_heal_thyself_tpu/parallel/distributed.py` (the serving
part; `host_batch_bounds` and `put_global` come with multi-GPU training).
One process per rank; each rank computes on its own device.

Bootstrap (any one of):
- explicit: ``PHT_COORDINATOR=host:port``, ``PHT_NUM_PROCESSES=N``,
  ``PHT_PROCESS_ID=i`` per process, as the JAX package reads them
  (``init_method="tcp://host:port"``);
- a launcher: ``parallel.multihost=true`` under ``python -m
  torch.distributed.run``, which sets ``RANK``/``WORLD_SIZE``/
  ``MASTER_ADDR``/``MASTER_PORT`` (``init_method="env://"``): PyTorch's
  counterpart of the TPU pod's auto-discovery.

The backend is chosen, not defaulted, and logged: ``nccl`` when each rank
of a host has a card of its own, ``gloo`` on the CPU and when ranks share
a card (``LOCAL_RANK % device_count`` picks each rank's card; NCCL refuses
two ranks on one GPU). PyTorch documents gloo's CUDA support for
broadcast and all_reduce only, so under gloo the payload of a collective
(edge rows, tail tokens, state summaries, the gathered frame) is copied
through host memory and back; every computation stays on the rank's
device.

`neighbour_exchange` (JAX's forward and backward `lax.ppermute`) and
`all_gather` are the two collectives the sharded paths need; callers
reach them through `parallel.mesh.RowAxis`.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from pixel_heal_thyself_tpu_torch.logger import logger

# a rank that dies leaves the others waiting in a collective: fail them
# after this long rather than the library's 30 minutes
TIMEOUT = timedelta(minutes=10)


def choose_backend(device_type: str, local_world_size: int) -> str:
    """`nccl` when every rank of this host has a card of its own, `gloo`
    on the CPU and when ranks share a card."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: the CPU if asked for, else card `local_rank %
    device_count`. Raises when a card is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {local_rank}: device {device} asked for, but no CUDA "
                           "device is available; pass device=cpu to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(init_method: str, world_size: int, rank: int, device="cuda",
               local_rank: int | None = None,
               local_world_size: int | None = None) -> torch.device:
    """Join the process group of `world_size` ranks as `rank`, on the
    backend `choose_backend` picks for `device`; for a card, make this
    rank's card the current one. Returns the rank's device."""
    local_rank = rank if local_rank is None else local_rank
    local_world_size = world_size if local_world_size is None else local_world_size
    dev = rank_device(device, local_rank)
    backend = choose_backend(dev.type, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=TIMEOUT)
    why = ("the CPU" if dev.type == "cpu" else
           f"{local_world_size} ranks on {torch.cuda.device_count()} card(s) of this host"
           + ("; collectives staged through host memory" if backend == "gloo" else ""))
    logger.info(f"[dist] rank {rank} of {world_size}: backend {backend} ({why}), device {dev}")
    return dev


def maybe_initialize_distributed(multihost: bool = False, device="cuda") -> bool:
    """Join the process group the environment describes (module docstring);
    idempotent. Returns True when this process is part of a process group.
    A launcher's `WORLD_SIZE` > 1 without `multihost` raises: each rank
    would otherwise serve every frame on its own."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = env.get("PHT_COORDINATOR")
    if coordinator:
        world, rank = int(env["PHT_NUM_PROCESSES"]), int(env["PHT_PROCESS_ID"])
        init_method = f"tcp://{coordinator}"
    elif multihost:
        if "WORLD_SIZE" not in env or "RANK" not in env:
            raise ValueError("parallel.multihost=true needs the launcher's RANK and WORLD_SIZE "
                             "(python -m torch.distributed.run), or set PHT_COORDINATOR, "
                             "PHT_NUM_PROCESSES and PHT_PROCESS_ID")
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = "env://"
    elif int(env.get("WORLD_SIZE", "1")) > 1:
        raise ValueError(f"launched as one of WORLD_SIZE={env['WORLD_SIZE']} ranks, but "
                         "parallel.multihost is false: set parallel.multihost=true so that "
                         "the ranks join one process group")
    else:
        return False
    initialize(init_method, world, rank, device, local_rank=int(env.get("LOCAL_RANK", rank)),
               local_world_size=int(env.get("LOCAL_WORLD_SIZE", world)))
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a payload goes through host memory (gloo and a CUDA tensor)."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def neighbour_exchange(to_next: torch.Tensor | None, to_prev: torch.Tensor | None, group):
    """Send `to_next` to the next rank of `group` and `to_prev` to the
    previous one, not cyclically (JAX's `ppermute` over the pairs (i, i+1)
    and (i, i-1)); every rank passes tensors of the same shapes, or None
    for a direction on every rank. Returns (from_prev, from_next) on the
    device of the tensors passed, None at the ends of the row and for an
    unused direction."""
    index, size = dist.get_rank(group), dist.get_world_size(group)
    like = to_next if to_next is not None else to_prev
    stage = like is not None and _staged(like, group)
    ops, got = [], {}
    for step, send in ((1, to_next), (-1, to_prev)):
        if send is None:
            continue
        peer, src = index + step, index - step
        if 0 <= peer < size:
            buf = send.contiguous()
            ops.append(dist.P2POp(dist.isend, buf.cpu() if stage else buf,
                                  dist.get_global_rank(group, peer), group))
        if 0 <= src < size:
            got[step] = torch.empty(send.shape, dtype=send.dtype,
                                    device="cpu" if stage else send.device)
            ops.append(dist.P2POp(dist.irecv, got[step], dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def back(t):
        return None if t is None else (t.to(like.device) if stage else t)

    return back(got.get(1)), back(got.get(-1))


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[ranks of `group`, *t.shape]: every rank's `t`, in rank order, on
    `t`'s device."""
    stage = _staged(t, group)
    src = t.detach().contiguous()
    src = src.cpu() if stage else src
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    res = torch.stack(out)
    return res.to(t.device) if stage else res


def _spawned(rank: int, fn, world_size: int, init_method: str, device, threads: int,
             args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    initialize(init_method, world_size, rank, device)
    fn(*args)
    # not on an exception: leaving the group would wait for the other ranks
    shutdown()


def spawn_world(fn, world_size: int, init_method: str, device="cuda", args: tuple = (),
                threads: int = 0) -> None:
    """Run `fn(*args)` in `world_size` fresh processes (`spawn`) joined in
    one process group on `device` (`initialize`), with `threads` torch
    threads each (0: the default). The first child exception is raised
    here, after the other children are stopped. `fn` is pickled by its
    import path."""
    import torch.multiprocessing as mp

    mp.spawn(_spawned, args=(fn, world_size, init_method, device, threads, args),
             nprocs=world_size, join=True)

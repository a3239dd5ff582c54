"""Rank programs of the port's multi-GPU training CPU tests.

Each function runs in every rank of a gloo process group started by
`pixel_heal_thyself_tpu_torch.parallel.distributed.spawn_world` (one torch
thread a rank) and saves what the tests compare into `out_dir` with
`torch.save`: the test files hold it against the JAX package, and one
rank against another, in the parent process. This module imports torch,
numpy and the port only: the ranks never load JAX, and they record that.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch.models.layers import BatchNorm2d
from pixel_heal_thyself_tpu_torch.parallel.data import batch_mean, share
from pixel_heal_thyself_tpu_torch.parallel.mesh import make_mesh
from pixel_heal_thyself_tpu_torch.training import train_step as ts


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _jax_loaded() -> bool:
    return any(m.split(".")[0] in ("jax", "flax", "pixel_heal_thyself_tpu") for m in sys.modules)


def _ra_hinge_rank_mean(real_preds, fake_preds, group=None):
    """A control: `ra_hinge_gan_loss` with the second list's mean taken
    over this rank's rows only."""
    loss = 0.0
    for pr, pf in zip(real_preds, fake_preds):
        pr, pf = pr.float(), pf.float()
        real_mean = batch_mean(pr, group)
        fake_mean = pf.mean(dim=(0, 1, 2), keepdim=True)
        loss = loss + F.relu(1.0 - (pr - fake_mean)).mean()
        loss = loss + F.relu(1.0 + (pf - real_mean)).mean()
    return share(loss * 0.5, group)


def run_steps(case: dict, mesh) -> dict:
    """`case`'s steps over `mesh` (None: one process): this rank's rows
    of each global batch through the port's step. Returns the losses of
    every step, the final parameters (and `u` buffers), and what this rank
    keeps of the parameters and Adam moments."""
    from pixel_heal_thyself_tpu_torch.models import lpips
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.discriminators import (
        DiscriminatorVGG,
        MultiScaleDiscriminator,
    )
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet
    from pixel_heal_thyself_tpu_torch.parallel.distributed import host_batch_bounds

    g = {"afgsa": AFGSANet, "mamba": MambaDenoiserNet}[case["g"]](**case["g_kwargs"])
    g.load_state_dict({k: _t(v) for k, v in case["g_state"].items()})
    group = None if mesh is None else mesh.data_group
    if case["multiscale"]:
        d = MultiScaleDiscriminator(**case["d_kwargs"])
    else:
        d = DiscriminatorVGG(**case["d_kwargs"], data_group=group)
    d.load_state_dict({k: _t(v) for k, v in case["d_state"].items()})
    spec = ts.make_optimizer(*case["opt"])
    lpips_params = None if case["lpips"] is None else lpips.random_lpips_params(case["lpips"])
    cfg = ts.LossesConfig(**case["losses"])
    control = case.get("control")
    saved = ts.ra_hinge_gan_loss, ts.to_lpips_range
    if control == "fake_mean":
        ts.ra_hinge_gan_loss = _ra_hinge_rank_mean
    elif control == "lpips_max":
        ts.to_lpips_range = lambda x, group=None: saved[1](x)
    try:
        step = ts.make_train_step(g, d, cfg, case["multiscale"], spec, spec,
                                  lpips_params=lpips_params, mesh=mesh)
        if control == "bn":
            for m in d.modules():
                if isinstance(m, BatchNorm2d):
                    m.data_group = None
        losses = []
        for i, batch in enumerate(case["batches"]):
            global_b = batch["noisy"].shape[0]
            lo, hi = (0, global_b) if mesh is None else host_batch_bounds(
                global_b, mesh.data_index, mesh.data)
            local = {k: _t(v[lo:hi]) for k, v in batch.items()}
            alpha = None if case["alphas"] is None else _t(case["alphas"][i])
            m = step(local, alpha=alpha)
            losses.append([float(m[k]) for k in ("g_loss", "d_loss", "g_gan", "g_l1")])
    finally:
        ts.ra_hinge_gan_loss, ts.to_lpips_range = saved
    kept = {}
    for name, shards, opt, model in (("g", step.g_shards, step.g_opt, g),
                                     ("d", step.d_shards, step.d_opt, d)):
        moments = sum(v.numel() for s in opt.state.values() for k, v in s.items()
                      if k in ("exp_avg", "exp_avg_sq"))
        kept[name] = {"params": sum(p.numel() for grp in opt.param_groups for p in grp["params"]),
                      "moments": moments,
                      "full": sum(p.numel() for p in model.parameters() if p.requires_grad)}
    opt_states, reloaded = {}, True
    for name, shards, opt in (("g", step.g_shards, step.g_opt), ("d", step.d_shards, step.d_opt)):
        full = opt.state_dict() if shards is None else shards.full_optimizer_state(opt)
        opt_states[name] = {i: {k: v.numpy().copy() for k, v in s.items()}
                            for i, s in full["state"].items()}
        if shards is not None:  # the restore path: cut the full state back into shards
            before = {i: {k: v.clone() for k, v in s.items()}
                      for i, s in opt.state_dict()["state"].items()}
            shards.load_full_optimizer_state(opt, full)
            after = opt.state_dict()["state"]
            reloaded &= all(torch.equal(after[i][k], v) for i, s in before.items()
                            for k, v in s.items())
    return {"losses": losses, "kept": kept, "opt": opt_states, "reloaded": reloaded,
            "g": {k: v.detach().numpy().copy() for k, v in g.state_dict().items()},
            "d": {k: v.detach().numpy().copy() for k, v in d.state_dict().items()}}


def step_rank(out_dir: str, cases: dict) -> None:
    """Every case of `cases` whose grid covers this world, then (on rank 0
    alone) every case with no grid: one process. Each rank saves its
    results to `out_dir/rank<r>.pt`."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"jax_loaded": _jax_loaded()}
    for name, case in cases.items():
        grid = case["mesh"]
        if grid is None:
            if rank == 0:
                out[name] = run_steps(case, None)
            continue
        if grid[0] * grid[1] != world:
            continue
        mesh = make_mesh(*grid)
        out[name] = run_steps(case, mesh)
    torch.save(out, Path(out_dir, f"rank{rank}.pt"))


def trainer_rank(out_dir: str, workdir: str, runs: list) -> None:
    """`AFGSATrainer.train()` with `device="cpu"`
    for each override list of `runs` in turn (a run, then its resume),
    from the shared working directory `workdir`. Records when rank 0
    finished the patch store and when each rank left the barrier after
    it, and each run's final parameters; saves to
    `out_dir/trainer_rank<r>.pt`."""
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.config.run_dirs import (
        register_run_dirs_resolver,
        reset_run_dirs_cache,
    )
    from pixel_heal_thyself_tpu_torch.data import store
    from pixel_heal_thyself_tpu_torch.training import trainer as trainer_mod

    os.chdir(workdir)
    register_run_dirs_resolver()
    events = {}
    build = store.PatchStoreConstructor.construct_store

    def construct(self):
        build(self)
        events["store_built"] = time.time()

    def barrier(*args, **kwargs):
        trainer_mod.parallel_barrier(*args, **kwargs)
        events.setdefault("left_barrier", time.time())

    store.PatchStoreConstructor.construct_store = construct
    trainer_mod.parallel_barrier, trainer_mod.barrier = trainer_mod.barrier, barrier
    results = []
    for overrides in runs:
        reset_run_dirs_cache()
        cfg = ConfigRegistry.create_config(compose("ci", overrides))
        trainer = trainer_mod.AFGSATrainer(cfg, device="cpu")
        trainer.train()
        results.append({
            "output_dir": cfg.paths.output_dir, "mesh": (trainer.mesh.data, trainer.mesh.model),
            "loader": trainer.loader_kind, "start_epoch": trainer.start_epoch,
            "g": {k: v.detach().numpy().copy() for k, v in trainer.state.g.state_dict().items()},
            "d": {k: v.detach().numpy().copy() for k, v in trainer.state.d.state_dict().items()},
        })
    torch.save({"rank": dist.get_rank(), "events": events, "runs": results,
                "jax_loaded": _jax_loaded()}, Path(out_dir, f"trainer_rank{dist.get_rank()}.pt"))


MESH_CASES = ((-1, 1, 8), (-1, 2, 8), (-1, 1, 2), (-1, 1, 3), (2, 1, 8), (3, 1, 8))


def _resolved_meshes() -> dict:
    """`make_mesh(data_axis, model_axis, batch)` of each of MESH_CASES over
    this world: (D, M), or the error's text."""
    out = {}
    for args in MESH_CASES:
        try:
            mesh = make_mesh(*args)
            out[args] = (mesh.data, mesh.model)
        except ValueError as e:
            out[args] = str(e)
    return out


def loader_rank(out_dir: str, store_dir: str, batch: int, seed: int,
                trainer_runs: list | None = None, workdir: str | None = None) -> None:
    """The counterpart of `tests/multihost_worker.py`: this rank's
    `host_batch_bounds` rows of every global batch from a `PrefetchLoader`
    over one patch store, through the DP step of a small AFGSANet against
    DiscriminatorVGG over every rank (`make_mesh(-1, 1, batch)`); saves
    the rows it read (each row's first aux value) and the losses, and how
    MESH_CASES resolve over this world. Then `trainer_rank` over
    `trainer_runs`, when given."""
    from pixel_heal_thyself_tpu_torch.data.dataset import PatchDataset, PrefetchLoader
    from pixel_heal_thyself_tpu_torch.parallel.distributed import host_batch_bounds

    meshes = _resolved_meshes()
    mesh = make_mesh(-1, 1, batch)
    g, d, step = small_gan(mesh)
    bounds = host_batch_bounds(batch, mesh.data_index, mesh.data)
    loader = PrefetchLoader(PatchDataset(store_dir), batch_size=batch, shuffle=True, seed=seed,
                            drop_last=True, device="cpu", host_bounds=bounds)
    gen = torch.Generator().manual_seed(7)
    losses, rows = [], []
    for b in loader:
        rows.append(b["aux"][:, 0, 0, 0].numpy().copy())
        m = step(b, generator=gen)
        losses.append([float(m["g_loss"]), float(m["d_loss"])])
    torch.save({"losses": losses, "rows": rows, "meshes": meshes, "jax_loaded": _jax_loaded()},
               Path(out_dir, f"loader_rank{dist.get_rank()}.pt"))
    if trainer_runs:
        trainer_rank(out_dir, workdir, trainer_runs)


def small_gan(mesh=None):
    """The step of `tests/multihost_worker.py`'s models (AFGSANet base 16,
    1 SA, 2 heads; DiscriminatorVGG base_nf 8 at 16²), seeded, over `mesh`."""
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG

    g = AFGSANet(base_ch=16, enc_ch=16, num_sa=1, num_gcp=0, num_heads=2,
                 generator=torch.Generator().manual_seed(0))
    d = DiscriminatorVGG(input_size=16, base_nf=8, generator=torch.Generator().manual_seed(1),
                         data_group=None if mesh is None else mesh.data_group)
    spec = ts.make_optimizer(1e-4, [2], 0.5, 3)
    return g, d, ts.make_train_step(g, d, ts.LossesConfig(), False, spec, spec, mesh=mesh)

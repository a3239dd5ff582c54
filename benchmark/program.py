"""The system under test, built as its users build it.

The only module of the benchmark that imports the program
(`pixel_heal_thyself_tpu_torch`, the PyTorch/CUDA port). A configuration
file's `program` tree is the port's config tree of the user's command
(`-cn prod model=...`); it is turned into the port's `Config` without the
YAML layer, so nothing is written for run directories.
"""

from __future__ import annotations

import math

import torch


def config(cfg_file: dict, seed: int, **trainer):
    """The port's `Config` of a configuration file, with `seed` and the
    `trainer` keys given (a traffic mix's batch size)."""
    from pixel_heal_thyself_tpu_torch.config.schema import Config

    tree = {**cfg_file["program"], "seed": seed}
    tree["trainer"] = {**tree["trainer"], **trainer}
    return Config.from_tree(tree)


def serving_model(cfg, state: dict, device):
    """The generator as `inference.load_generator` builds it, with `state`
    (a seeded state dict) in place of a checkpoint."""
    from pixel_heal_thyself_tpu_torch.inference import (
        _dtype,
        afgsa_kwargs_from_config,
        mamba_kwargs_from_config,
    )
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet

    if cfg.model.name == "afgsa":
        net, kwargs = AFGSANet, afgsa_kwargs_from_config(cfg)
    else:
        net, kwargs = MambaDenoiserNet, mamba_kwargs_from_config(cfg)
    if _dtype(cfg) == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = net(**kwargs, device=device)
    model.load_state_dict(state)
    return model.eval()


def frame_server(model, frame_hw: tuple, tile: int, margin: int, batch: int, device):
    """`serve(data) -> linear frame`: `inference.denoise_frame_fused` over
    `inference.make_fused_frame_apply`, as `run_inference` serves a frame."""
    from pixel_heal_thyself_tpu_torch.inference import denoise_frame_fused, make_fused_frame_apply

    fused = make_fused_frame_apply(model, frame_hw, tile=tile, margin=margin,
                                   batch_tiles=batch, device=device)
    return lambda data: denoise_frame_fused(fused, data, device=device)


class MemoryPatches:
    """A patch store held in memory, with the interface of the port's
    `data.dataset.PatchDataset` that `DeviceLoader` reads."""

    KEYS = ("noisy", "gt", "aux")

    def __init__(self, arrays: dict) -> None:
        self._arrays = arrays

    def __len__(self) -> int:
        return len(self._arrays["aux"])

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self._arrays.values())

    def arrays(self) -> dict:
        return self._arrays

    def batch(self, indices):
        return {k: self._arrays[k][indices] for k in self.KEYS}


def prepare_training(cfg) -> None:
    """What `train.main` sets before anything touches the card: the
    trainer's determinism settings when `trainer.deterministic`."""
    from pixel_heal_thyself_tpu_torch.training.trainer import deterministic_algorithms

    if cfg.trainer.deterministic:
        deterministic_algorithms()


class Training:
    """The prod GAN step as `BaseTrainer.train` composes it: the trainer's
    determinism and TF32 settings, `create_generator`,
    `create_discriminator`, `make_optimizer`, `make_train_step`,
    `TrainState`, and a `DeviceLoader` over the store."""

    def __init__(self, cfg, g_state: dict, d_state: dict, store: dict, loader_seed: int,
                 gp_generator: torch.Generator, device) -> None:
        from pixel_heal_thyself_tpu_torch.data.dataset import DeviceLoader
        from pixel_heal_thyself_tpu_torch.training.trainer import AFGSATrainer, MambaTrainer
        from pixel_heal_thyself_tpu_torch.training.train_step import (
            TrainState,
            make_optimizer,
            make_train_step,
            multistep_milestone_epochs,
        )

        trainer_cls = AFGSATrainer if cfg.model.name == "afgsa" else MambaTrainer
        trainer = trainer_cls(cfg, device)
        g, d = trainer.create_generator(), trainer.create_discriminator()
        g.load_state_dict(g_state)
        d.load_state_dict(d_state)
        batch = cfg.trainer.batch_size
        steps_per_epoch = math.ceil(len(store["aux"]) / batch)
        milestones = multistep_milestone_epochs(cfg.trainer.epochs, cfg.trainer.lr_milestone)
        optim = dict(betas=tuple(cfg.trainer.optim.betas), eps=cfg.trainer.optim.eps)
        g_tx = make_optimizer(cfg.trainer.lr_g, milestones, cfg.trainer.lr_gamma,
                              steps_per_epoch, **optim)
        d_tx = make_optimizer(cfg.trainer.lr_d, milestones, cfg.trainer.lr_gamma,
                              steps_per_epoch, **optim)
        self.step = make_train_step(g, d, cfg.model.losses, False, g_tx, d_tx, mesh=trainer.mesh)
        self.state = TrainState(g=g, d=d, g_opt=self.step.g_opt, d_opt=self.step.d_opt,
                                g_sched=self.step.g_sched, d_sched=self.step.d_sched,
                                generator=gp_generator)
        self.loader = DeviceLoader(MemoryPatches(store), batch_size=batch, shuffle=True,
                                   seed=loader_seed, device=device)
        self.g, self.d = g, d
        self.steps_per_epoch = steps_per_epoch

    def batches(self):
        """The loader's batches, epoch after epoch."""
        while True:
            yield from self.loader

    def __call__(self, batch: dict) -> dict:
        return self.step(batch, generator=self.state.generator)

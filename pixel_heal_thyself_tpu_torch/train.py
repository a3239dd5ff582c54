"""Training CLI of the port:

    python -m pixel_heal_thyself_tpu_torch.train -cn {ci,dev,stag,prod} \
        [model=mamba] [k=v ...] [--device {cuda,cpu}]

Port of `pixel_heal_thyself_tpu/train.py` (the reference's entry surface,
`pht/train.py:16-38` via Hydra): `-cn/--config-name` selects the env
config, positional `key=value` arguments override any config path,
`model=mamba` switches the model group, and `-m/--multirun` sweeps
comma-separated override values, each job in
`outputs/trials/runNNN/<overrides>`. Each run writes its composed config
and overrides to `<run>/.hydra/{config,overrides}.yaml`.

It trains on the card (`--device cuda`, the default) and raises when
there is none; `--device cpu` trains on the CPU. With
`trainer.deterministic` (the default) the determinism settings of
`training.trainer.deterministic_algorithms` are applied first, before
anything touches the card, and stay set for the rest of the process.

Several ranks: `python -m torch.distributed.run --nproc-per-node N -m
pixel_heal_thyself_tpu_torch.train ... parallel.multihost=true
[parallel.data_axis=D parallel.model_axis=M]`, or `PHT_COORDINATOR`/
`PHT_NUM_PROCESSES`/`PHT_PROCESS_ID` in each process. The ranks join one
process group before any run directory is made (a launcher's WORLD_SIZE
> 1 without `parallel.multihost` raises); rank 0 resolves the run
directory and the others take it from rank 0, so only rank 0 makes
directories and writes files. The group is left when the run ends.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

import torch.distributed as dist
import yaml

from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
from pixel_heal_thyself_tpu_torch.config.run_dirs import (
    pht_run_dirs_resolver,
    register_run_dirs_resolver,
    reset_run_dirs_cache,
)
from pixel_heal_thyself_tpu_torch.logger import logger
from pixel_heal_thyself_tpu_torch.parallel.distributed import (
    is_main_process,
    maybe_initialize_distributed,
    process_count,
    shutdown,
)


def _build_trainer(cfg, device: str, **trainer_args):
    from pixel_heal_thyself_tpu_torch.training.trainer import AFGSATrainer, MambaTrainer

    if cfg.model.name == "afgsa":
        return AFGSATrainer(cfg, device=device, **trainer_args)
    if cfg.model.name == "mamba":
        return MambaTrainer(cfg, device=device, **trainer_args)
    raise ValueError(f"Unsupported model: {cfg.model.name}")


def _save_run_metadata(cfg_tree: dict, overrides: list[str]) -> None:
    """Persist the composed config and overrides like Hydra's .hydra dir
    (read by tools/runs_analysis.py)."""
    out_dir = Path(cfg_tree["paths"]["output_dir"]) / ".hydra"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "overrides.yaml", "w") as f:
        yaml.safe_dump(overrides, f)
    with open(out_dir / "config.yaml", "w") as f:
        yaml.safe_dump(cfg_tree, f, sort_keys=False)


def _from_rank0(make):
    """`make()` on rank 0, its value on every rank (`make()` alone without
    a process group)."""
    if process_count() == 1:
        return make()
    box = [make() if is_main_process() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _run(config_name: str, overrides: list[str], saved_overrides: list[str], device: str,
         trainer_args: dict):
    # the run directory is resolved (and made) on rank 0 alone
    out_dir = _from_rank0(lambda: compose(config_name, overrides)["paths"]["output_dir"])
    cfg_tree = compose(config_name, overrides + [f"paths.output_dir={out_dir}"])
    cfg = ConfigRegistry.create_config(cfg_tree)
    logger.setup_logger(cfg.logging.level)
    if is_main_process():
        _save_run_metadata(cfg_tree, saved_overrides)
    trainer = _build_trainer(cfg, device, **trainer_args)
    trainer.train()
    return trainer


def _expand_multirun(overrides: list[str]) -> list[list[str]]:
    """Expand comma-separated override values into a sweep grid."""
    choices = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        vals = val.split(",") if "," in val else [val]
        choices.append([f"{key}={v}" for v in vals])
    return [list(combo) for combo in itertools.product(*choices)]


def main(argv: list[str] | None = None, **trainer_args):
    """Run the CLI; returns the trainer of the last (or only) job.
    `trainer_args`: keyword arguments of every job's trainer (a diagnostic
    run's `critic_dtype`, `tf32`: `training.trainer.BaseTrainer`)."""
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.train")
    parser.add_argument("-cn", "--config-name", default="default")
    parser.add_argument("-m", "--multirun", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)  # --device may follow the overrides
    from pixel_heal_thyself_tpu_torch.training.trainer import (
        deterministic_algorithms,
        training_device,
    )

    training_device(args.device)  # no card: raise before any run dir is made
    register_run_dirs_resolver()
    probe = _expand_multirun(args.overrides)[0] if args.multirun else args.overrides
    head = compose(args.config_name, probe, resolve_interpolations=False)
    if head["trainer"]["deterministic"]:
        deterministic_algorithms()  # before the first cuBLAS handle; each trainer again
    multihost = head["parallel"]["multihost"]
    own_group = not dist.is_initialized() and maybe_initialize_distributed(bool(multihost),
                                                                           args.device)

    if not args.multirun:
        trainer = _run(args.config_name, args.overrides, args.overrides, args.device,
                       trainer_args)
    else:
        trainer = None
        reset_run_dirs_cache()  # all sweep jobs share one trial run
        for job_overrides in _expand_multirun(args.overrides):
            subdir = ",".join(job_overrides) or "job"
            logger.info(f"[multirun] job: {subdir}")
            # jobs land in outputs/trials/<runNNN>/<subdir>; the dir is
            # passed as a literal so override values may contain commas
            out_dir = _from_rank0(lambda: pht_run_dirs_resolver("outputs", "none", subdir,
                                                                "-1", "true"))
            trainer = None  # free the last job's models before the next builds its own
            trainer = _run(args.config_name, job_overrides + [f"paths.output_dir={out_dir}"],
                           job_overrides, args.device, trainer_args)
    # after success only: a failing rank leaves without waiting for the others
    if own_group:
        shutdown()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])

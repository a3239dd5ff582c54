"""PyTorch port: the training CLI end to end on the CPU.

`python -m pixel_heal_thyself_tpu_torch.train -cn ci --device cpu` (its
`main`, in process) at tests/test_trainer_e2e.py:93's tiny sizes (AFGSA)
and tests/test_mamba_e2e.py:16's (Mamba), 8 patches an image: the run's
`train_loss.txt`, `evaluation.txt`, PNG panels, checkpoint and `.hydra`
files; then a resume leg from `model_epoch1/state` that restores the
saved state to the bit, takes its first step at the schedule's learning
rate and writes epoch 2 alone; then `inference.load_generator` on the
checkpoint gives the saved generator. The Mamba run also writes a
`trainer.profile_dir` trace.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import torch  # noqa: E402

from pixel_heal_thyself_tpu_torch import train as ptrain  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.training import checkpoints  # noqa: E402
from pixel_heal_thyself_tpu_torch.training.train_step import (  # noqa: E402
    multistep_milestone_epochs,
    multistep_schedule,
)
from tests.test_torch_port_trainer import TINY, _assert_state_equal  # noqa: E402

TRAIN_LOSS = re.compile(r"Epoch: (\d+) \tG loss: ([-\d.]+) \tD Loss: ([-\d.]+)\n")
EVALUATION = re.compile(
    r"Validation: (\d+) \tAvg MRSE: ([-\d.]+) \tAvg PSNR: ([-\d.]+) \tAvg 1-SSIM: ([-\d.]+)\n")


@pytest.fixture(autouse=True, scope="module")
def _determinism_restored():
    """A trainer sets torch's determinism switches and
    CUBLAS_WORKSPACE_CONFIG for its process (`trainer.deterministic`):
    restored when this file's tests end, so that the worker's next files
    run under torch's defaults."""
    import os
    from unittest import mock

    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import arithmetic, switches_now

    with arithmetic(switches_now()), mock.patch.dict(os.environ):
        yield


@pytest.fixture(autouse=True)
def _port_run_dirs():
    reset_run_dirs_cache()
    yield
    reset_run_dirs_cache()


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads for these runs: under the tier-1 command's six
    workers, torch's default of a thread per core in every worker
    oversubscribes the cores, and an AFGSA CLI run took 240–440 s there
    against about 7 s alone (about 60 s with two threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _check_run(run: Path, epochs: list[int]) -> None:
    """The artifacts of a run that trained and validated `epochs`."""
    losses = TRAIN_LOSS.findall((run / "train_loss.txt").read_text())
    assert [int(m[0]) for m in losses] == epochs
    assert all(np.isfinite(float(v)) for m in losses for v in m[1:])
    evals = EVALUATION.findall((run / "evaluation.txt").read_text())
    assert [int(m[0]) for m in evals] == epochs
    assert all(np.isfinite(float(v)) for m in evals for v in m[1:])
    for epoch in epochs:
        folder = run / f"model_epoch{epoch}"
        assert (folder / "state" / checkpoints.FILE).is_file()
        panel = cv2.imread(str(folder / "0.png"), cv2.IMREAD_UNCHANGED)
        assert panel is not None and panel.ndim == 3 and panel.shape[1] == 3 * panel.shape[0]
    assert (run / ".hydra" / "config.yaml").is_file()


def _resume(tmp_cwd, monkeypatch, model: str, run0: Path, extra: tuple = ()):
    """The resume leg: epoch 2 from run0's model_epoch1/state (`extra`: the
    first leg's other overrides). Returns the trainer; what
    `restore_checkpoint` left in its state equals the saved state."""
    restored = {}
    real = checkpoints.restore_checkpoint

    def spy(path, state):
        epoch = real(path, state)
        restored.update({name: _clone(getattr(state, name).state_dict())
                         for name in ("g", "d", "g_opt", "d_opt", "g_sched")})
        restored["lr"] = state.g_opt.param_groups[0]["lr"]
        return epoch

    monkeypatch.setattr(checkpoints, "restore_checkpoint", spy)
    ckpt = run0 / "model_epoch1" / "state"
    trainer = ptrain.main(["-cn", "ci", "--device", "cpu", *TINY[model], *extra, "run_num=1",
                           "trainer.epochs=2", "trainer.load_model=true",
                           f"trainer.model_path={ckpt}"])
    saved = torch.load(ckpt / checkpoints.FILE, weights_only=True)
    for name in ("g", "d", "g_opt", "d_opt", "g_sched"):
        _assert_state_equal(restored[name], saved[name])
    cfg = trainer.cfg
    steps = saved["g_sched"]["last_epoch"]
    n_train = len(np.load(Path(cfg.data.patches.dir) / "train" / "aux.npy", mmap_mode="r"))
    assert steps == -(-n_train // cfg.trainer.batch_size)  # one epoch of steps
    milestones = multistep_milestone_epochs(cfg.trainer.epochs, cfg.trainer.lr_milestone)
    schedule = multistep_schedule(cfg.trainer.lr_g, milestones, cfg.trainer.lr_gamma, steps)
    assert restored["lr"] == schedule(steps)
    _check_run(tmp_cwd / "outputs" / "runs" / run0.parent.name / "run001", [2])
    return trainer


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _serves(trainer, ckpt: Path) -> None:
    """`inference.load_generator` on the checkpoint gives the saved G."""
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.inference import load_generator

    cfg = ConfigRegistry.create_config(compose(
        "ci", [*TINY[trainer.cfg.model.name], f"trainer.model_path={ckpt}"]))
    model = load_generator(cfg, device="cpu")
    _assert_state_equal(model.state_dict(),
                        torch.load(ckpt / checkpoints.FILE, weights_only=True)["g"])


def test_cli_afgsa_trains_validates_and_resumes(tmp_cwd, monkeypatch):
    trainer = ptrain.main(["-cn", "ci", "--device", "cpu", "trainer.epochs=1", *TINY["afgsa"],
                           "run_num=0"])
    assert type(trainer).__name__ == "AFGSATrainer" and trainer.loader_kind == "device"
    run0 = tmp_cwd / "outputs" / "runs" / "afgsa_p32_n8_r1.0" / "run000"
    _check_run(run0, [1])
    reset_run_dirs_cache()
    trainer = _resume(tmp_cwd, monkeypatch, "afgsa", run0)
    _serves(trainer, run0 / "model_epoch1" / "state")


def test_cli_mamba_trains_validates_and_resumes(tmp_cwd, monkeypatch):
    trainer = ptrain.main(["-cn", "ci", "--device", "cpu", "trainer.epochs=1", *TINY["mamba"],
                           "run_num=0", f"trainer.profile_dir={tmp_cwd / 'trace'}"])
    assert type(trainer).__name__ == "MambaTrainer" and trainer.loader_kind == "device"
    assert (tmp_cwd / "trace" / "trace.json").stat().st_size > 0  # the profiler's window closed
    assert not trainer.use_kernels  # no hand kernels off the card
    run0 = tmp_cwd / "outputs" / "runs" / "mamba_p32_n8_r1.0" / "run000"
    _check_run(run0, [1])
    reset_run_dirs_cache()
    trainer = _resume(tmp_cwd, monkeypatch, "mamba", run0)
    _serves(trainer, run0 / "model_epoch1" / "state")

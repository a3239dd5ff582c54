"""PyTorch port: the training CLI with the GAN options of the JAX trainer.

`python -m pixel_heal_thyself_tpu_torch.train -cn ci --device cpu` (its
`main`, in process) at tests/test_torch_port_trainer_cli.py's tiny sizes:
- AFGSA with all four options — `model.use_film`, the multiscale
  spectral-norm critic, the MS-SSIM and LPIPS(random) terms — for one
  epoch: the run's artifacts and log lines, the critic's `u` buffers in
  the checkpoint; then a resume leg from `model_epoch1/state` that
  restores G, D (every `u` with it) and both Adams to the bit;
- Mamba with the multiscale critic, MS-SSIM and LPIPS(random) for one
  epoch (FiLM is AFGSA's alone);
- `use_lpips_loss=true` without a weights path raises the JAX trainer's
  `ValueError`, and a path loads that npz.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("cv2")
import torch  # noqa: E402

from pixel_heal_thyself_tpu_torch import train as ptrain  # noqa: E402
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import (  # noqa: E402
    MultiScaleDiscriminator,
)
from pixel_heal_thyself_tpu_torch.training import checkpoints  # noqa: E402
from pixel_heal_thyself_tpu_torch.training.trainer import AFGSATrainer  # noqa: E402
from tests.test_torch_port_trainer import TINY  # noqa: E402
from tests.test_torch_port_trainer_cli import _check_run, _resume, _two_threads  # noqa: E402, F401

GAN = ("model.discriminator.use_multiscale_discriminator=true",
       "model.losses.use_ssim_loss=true", "model.losses.use_lpips_loss=true",
       "model.losses.lpips_weights_path=random")


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


class _Keep(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_afgsa_all_gan_options_train_and_resume(tmp_cwd, monkeypatch):
    extra = ("model.use_film=true", *GAN)
    keep = _Keep()
    logging.getLogger("pht_tpu").addHandler(keep)
    try:
        trainer = ptrain.main(["-cn", "ci", "--device", "cpu", "trainer.epochs=1",
                               *TINY["afgsa"], *extra, "run_num=0"])
    finally:
        logging.getLogger("pht_tpu").removeHandler(keep)
    for line in ("AFGSA SSIM lossW: 0.1", "AFGSA multiscale discriminator", "AFGSA use FiLM",
                 "LPIPS using RANDOM weights (test mode)"):
        assert line in keep.lines, line
    g, d = trainer.state.g, trainer.state.d
    assert isinstance(d, MultiScaleDiscriminator)
    assert all(blk.attention.use_film for blk in g.blocks)
    run0 = tmp_cwd / "outputs" / "runs" / "afgsa_p32_n8_r1.0" / "run000"
    _check_run(run0, [1])
    saved = torch.load(run0 / "model_epoch1" / "state" / checkpoints.FILE, weights_only=True)
    assert sorted(k for k in saved["d"] if k.endswith(".u")) == sorted(
        k for k in d.state_dict() if k.endswith(".u"))
    reset_run_dirs_cache()
    resumed = _resume(tmp_cwd, monkeypatch, "afgsa", run0, extra)
    assert isinstance(resumed.state.d, MultiScaleDiscriminator)


def test_cli_mamba_multiscale_ssim_lpips_trains(tmp_cwd):
    trainer = ptrain.main(["-cn", "ci", "--device", "cpu", "trainer.epochs=1",
                           *TINY["mamba"], *GAN, "run_num=0"])
    assert isinstance(trainer.state.d, MultiScaleDiscriminator)
    _check_run(tmp_cwd / "outputs" / "runs" / "mamba_p32_n8_r1.0" / "run000", [1])


def _trainer(overrides) -> AFGSATrainer:
    cfg = ConfigRegistry.create_config(compose("ci", [*TINY["afgsa"], *overrides]))
    return AFGSATrainer(cfg, device="cpu")


def test_lpips_weights_path_is_required(tmp_cwd):
    trainer = _trainer(["model.losses.use_lpips_loss=true"])
    with pytest.raises(ValueError, match="model.losses.lpips_weights_path"):
        trainer.lpips_params()
    assert _trainer([]).lpips_params() is None


def test_lpips_weights_path_loads_the_npz(tmp_cwd):
    from pixel_heal_thyself_tpu_torch.models import lpips

    params = lpips.random_lpips_params(4)
    raw = {}
    for (idx, _), (w, b) in zip(lpips._VGG16_CONVS, params["convs"]):
        raw[f"features.{idx}.weight"], raw[f"features.{idx}.bias"] = w.numpy(), b.numpy()
    for k, lin in enumerate(params["lins"]):
        raw[f"lin{k}.weight"] = lin.numpy().reshape(1, -1, 1, 1)
    path = Path(tmp_cwd) / "lpips_vgg.npz"
    np.savez(path, **raw)
    got = _trainer(["model.losses.use_lpips_loss=true",
                    f"model.losses.lpips_weights_path={path}"]).lpips_params()
    for (w, b), (w0, b0) in zip(got["convs"], params["convs"]):
        assert torch.equal(w, w0) and torch.equal(b, b0)
    assert all(torch.equal(a, b) for a, b in zip(got["lins"], params["lins"]))

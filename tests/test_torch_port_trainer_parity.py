"""PyTorch port: the whole trainer against the JAX `AFGSATrainer` (CPU).

Both trainers run `-cn ci` at tests/test_trainer_e2e.py:93's tiny fp32
config for one epoch on the same synthetic tree (the JAX trainer writes
it; each package builds its own patch store from it, equal to the bit by
tests/test_torch_port_data.py), from the same weights (seeded values at
the torch-default scale, loaded into the port through
`params.afgsa_state_from_flax` / `discriminator_state_from_flax`), with
the JAX trainer's GP interpolation weights for every step
(`uniform(fold_in(step_rng, step))`, JAX `training/train_step.py:129`)
and on one device each (`parallel.data_axis=1`). The JAX trainer runs
its plain XLA route on the CPU and the port its plain PyTorch route.

Both critics are narrowed to `base_nf=8` (the trainers build 64), the
width of the step trajectory test's critic. At 64 the two frameworks'
float32 rounding of the GP's double backward gives a few hundred of the
critic's weights gradients of opposite sign (their magnitudes 100–1000×
under the median), Adam's first step turns each into ±lr, and d_loss
parts by 0.6% at step 1 and 10% over the epoch's mean, a near-cancelling
sum (0.0338 against 0.0307), while G's losses and the validation metrics
agree to 1e-4. At 8 every step's d_loss agrees to ~1e-5.

Tolerance: every number of `train_loss.txt` and `evaluation.txt` within
1e-2 relative (the tolerance the step trajectory test of
tests/test_torch_port_train_step.py reaches by step 3), plus 1e-4, one
unit of the files' last printed digit.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.config import Config as JConfig  # noqa: E402
from pixel_heal_thyself_tpu.config import compose as jcompose  # noqa: E402
from pixel_heal_thyself_tpu.config.run_dirs import register_run_dirs_resolver  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import DiscriminatorVGG as JDiscriminatorVGG  # noqa: E402,E501
from pixel_heal_thyself_tpu.training import trainer as jtrainer_mod  # noqa: E402
from pixel_heal_thyself_tpu_torch import train as ptrain  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    discriminator_state_from_flax,
)
from pixel_heal_thyself_tpu_torch.training import trainer as trainer_mod  # noqa: E402
from tests.test_torch_port_train_step import _init_state  # noqa: E402

TINY = ["trainer.epochs=1", "data.patches.num_patches=16", "data.images.synthetic_size=96",
        "model.feature_map_channels=32", "model.afgsa.self_attention.num_layers=1",
        "parallel.data_axis=1"]
REL_TOL, PRINT_UNIT = 1e-2, 1e-4
D_NF = 8
NUMBER = re.compile(r"-?\d+\.\d+")


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


def _numbers(path) -> list[float]:
    return [float(x) for x in NUMBER.findall(path.read_text())]


def test_afgsa_trainer_matches_jax_trainer(tmp_cwd, monkeypatch):
    # ---- the JAX trainer, from seeded weights -----------------------------
    weights = []

    def init_state(model, tx, rng, *inputs):
        state = _init_state(model, tx, len(weights), *inputs)  # not flax's ~20 s init
        weights.append(jax.tree.map(np.asarray, state.params))
        return state

    monkeypatch.setattr(jtrainer_mod, "init_train_state", init_state)
    monkeypatch.setattr(jtrainer_mod, "DiscriminatorVGG",
                        lambda **kw: JDiscriminatorVGG(**dict(kw, base_nf=D_NF)))
    register_run_dirs_resolver()
    cfg = JConfig.from_tree(jcompose("ci", TINY + ["run_num=0"]))
    try:
        jtrainer_mod.AFGSATrainer(cfg).train()
    finally:
        jax.config.update("jax_default_matmul_precision", None)
    assert len(weights) == 2  # G, then D
    step_rng = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[2]

    # ---- the port's trainer, from the same weights and GP draws -----------
    class Loaded(trainer_mod.AFGSATrainer):
        def create_generator(self):
            g = super().create_generator()
            g.load_state_dict(afgsa_state_from_flax(weights[0]))
            return g

        def create_discriminator(self):
            d = DiscriminatorVGG(in_nc=3, base_nf=D_NF, input_size=self.cfg.data.patches.patch_size,
                                 dtype=self.compute_dtype, device=self.device)
            d.load_state_dict(discriminator_state_from_flax(weights[1]))
            return d

    real_make = trainer_mod.make_train_step
    steps = []

    def make_train_step(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def jax_alpha_step(batch, *, generator=None):
            b = batch["noisy"].shape[0]
            alpha = jax.random.uniform(jax.random.fold_in(step_rng, len(steps)),
                                       (b, 1, 1, 1), jnp.float32)
            steps.append(b)
            return step(batch, alpha=torch.from_numpy(np.array(alpha)))

        jax_alpha_step.__dict__.update(step.__dict__)  # the optimizers
        return jax_alpha_step

    monkeypatch.setattr(trainer_mod, "make_train_step", make_train_step)
    monkeypatch.setattr(ptrain, "_build_trainer", lambda cfg, device: Loaded(cfg, device=device))
    ptrain.main(["-cn", "ci", "--device", "cpu", *TINY, "run_num=1"])

    runs = tmp_cwd / "outputs" / "runs" / "afgsa_p32_n16_r1.0"
    n_train = len(np.load(tmp_cwd / "data" / "images_ci" /
                          "patches_p32_n16_r1.0" / "train" / "aux.npy", mmap_mode="r"))
    assert sum(steps) == n_train and len(steps) == -(-n_train // cfg.trainer.batch_size)
    for name in ("train_loss.txt", "evaluation.txt"):
        want = _numbers(runs / "run000" / name)
        got = _numbers(runs / "run001" / name)
        assert len(got) == len(want) >= 2, name
        for g, w in zip(got, want):
            assert abs(g - w) <= REL_TOL * abs(w) + PRINT_UNIT, f"{name}: port {g} vs JAX {w}"

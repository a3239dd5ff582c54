"""PyTorch port: `AFGSATrainer.train()` over two gloo CPU ranks.

A gloo world of 2 CPU ranks (`spawn_world`, one torch thread a rank,
`init_method=file://`) runs `tests/torch_port_training_workers.
trainer_rank` from one shared working directory at the ci size of the JAX
package's `test_trainer_dp_matches_single_device`
(`tests/test_parallel_trainer.py:103-140`: 2 epochs, batch 2, 16 patches
of 96² synthetic images, width 32, 1 attention layer; `device="cpu"`),
then resumes that run from its `model_epoch2` checkpoint for a third
epoch. This process trains the same config on one process (no process
group) in a directory of its own.

- `train_loss.txt` and `evaluation.txt` hold the values of the one-process
  run to JAX's slow test's bounds: rtol 2e-3 for G (and the evaluation),
  5e-2 for D, taken of the largest |D| of the run rather than of each
  epoch's value. They cannot be equal byte for byte: the two ranks sum
  each global loss and gradient from two halves, in another order than
  one process does, and 26 WGAN-GP steps carry that rounding forward (the
  JAX test allows the same for the same reason). An epoch's D loss is a
  mean of step losses of both signs that nearly cancel (epoch 1: about
  0.04 from steps between −0.5 and 1.7), so its relative deviation says
  little (the test prints it: about 10% at epoch 1).
- Only rank 0 writes: the shared directory holds the same files as the
  one-process run's, no second run directory and no `_1` duplicates.
- Rank 1 leaves the patch-store barrier only after rank 0 has built the
  store.
- The resume restores both ranks to the same state: their parameters after
  the third epoch are equal to the bit.
- A launcher world (`WORLD_SIZE` 2) with `parallel.multihost=false`
  raises before anything is written.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pixel_heal_thyself_tpu_torch import train as ptrain
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
from pixel_heal_thyself_tpu_torch.config.run_dirs import (
    register_run_dirs_resolver,
    reset_run_dirs_cache,
)
from pixel_heal_thyself_tpu_torch.parallel import distributed
from pixel_heal_thyself_tpu_torch.training.trainer import AFGSATrainer

import torch_port_training_workers as workers

# tests/test_parallel_trainer.py:124-131
CI = ["trainer.epochs=2", "trainer.batch_size=2", "data.patches.num_patches=16",
      "data.images.synthetic_size=96", "model.feature_map_channels=32",
      "model.afgsa.self_attention.num_layers=1", "run_num=0"]
RUN = Path("outputs/runs/afgsa_p32_n16_r1.0")
RESUME = ["trainer.epochs=3", "trainer.load_model=true",
          f"trainer.model_path={RUN / 'run000' / 'model_epoch2' / 'state'}", "run_num=1"]
G_RTOL, D_RTOL = 2e-3, 5e-2
DEADLINE = 400


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The two-rank run and its resume, and the one-process run."""
    tmp = tmp_path_factory.mktemp("dp_trainer")
    shared, single = tmp / "shared", tmp / "single"
    shared.mkdir()
    single.mkdir()
    dp = [*CI, "parallel.data_axis=2"]
    distributed.spawn_world(workers.trainer_rank, 2, f"file://{tmp}/init", "cpu",
                            args=(str(tmp), str(shared), [dp, [*dp, *RESUME]]), threads=1,
                            deadline=DEADLINE)
    ranks = [torch.load(tmp / f"trainer_rank{r}.pt", weights_only=False) for r in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(single)
        register_run_dirs_resolver()
        reset_run_dirs_cache()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as each rank
        try:
            AFGSATrainer(ConfigRegistry.create_config(compose("ci", [*CI, "parallel.data_axis=1"])),
                         device="cpu").train()
        finally:
            torch.set_num_threads(threads)
    return {"ranks": ranks, "shared": shared, "single": single}


def _numbers(path: Path) -> np.ndarray:
    rows = []
    for line in path.read_text().strip().splitlines():
        rows.append([float(v) for v in re.findall(r"-?\d+\.\d+", line)])
    return np.asarray(rows)


def _tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if ".hydra" not in p.parts and "data" not in p.parts)


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_loaded"] for r in runs["ranks"])


def test_two_ranks_train_as_one_process(runs):
    got_dir, want_dir = runs["shared"] / RUN / "run000", runs["single"] / RUN / "run000"
    assert [r["runs"][0]["mesh"] for r in runs["ranks"]] == [(2, 1), (2, 1)]
    assert runs["ranks"][0]["runs"][0]["loader"] == "native"
    got, want = _numbers(got_dir / "train_loss.txt"), _numbers(want_dir / "train_loss.txt")
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=G_RTOL)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0,
                               atol=D_RTOL * np.abs(want[:, 1]).max())
    got_e, want_e = (_numbers(d / "evaluation.txt") for d in (got_dir, want_dir))
    assert got_e.shape == want_e.shape == (2, 3)
    np.testing.assert_allclose(got_e, want_e, rtol=G_RTOL)
    print("train_loss max rel dev G", np.abs(got[:, 0] / want[:, 0] - 1).max(),
          "D", np.abs(got[:, 1] / want[:, 1] - 1).max(),
          "evaluation", np.abs(got_e / want_e - 1).max())


def test_only_rank0_writes(runs):
    first = runs["shared"] / RUN / "run000"
    assert _tree(first) == _tree(runs["single"] / RUN / "run000")
    assert sorted(p.name for p in (runs["shared"] / RUN).iterdir()) == ["run000", "run001"]
    epochs = sorted(p.name for p in (runs["shared"] / RUN / "run001").iterdir()
                    if p.name.startswith("model_epoch"))
    assert epochs == ["model_epoch3"]


def test_rank1_waits_for_the_store(runs):
    rank0, rank1 = (r["events"] for r in runs["ranks"])
    assert "store_built" in rank0 and "store_built" not in rank1
    assert rank1["left_barrier"] >= rank0["store_built"]


def test_resume_restores_equal_ranks(runs):
    a, b = (r["runs"][1] for r in runs["ranks"])
    assert a["start_epoch"] == b["start_epoch"] == 2
    for part in ("g", "d"):
        assert a[part].keys() == b[part].keys()
        for name in a[part]:
            assert np.array_equal(a[part][name], b[part][name]), f"{part}/{name}"
    first = runs["ranks"][0]["runs"][0]
    assert any(not np.array_equal(a["g"][k], first["g"][k]) for k in a["g"])


def test_launcher_world_without_multihost_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for key in ("PHT_COORDINATOR", "RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="multihost=true"):
        ptrain.main(["-cn", "ci", "--device", "cpu", *CI])
    assert not (tmp_path / "outputs").exists()

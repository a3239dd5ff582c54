"""PyTorch port: what `trainer.deterministic` sets, on the CPU.

The reference's `set_determinism` (`pht/models/base_trainer.py:50-80`)
sets `CUBLAS_WORKSPACE_CONFIG=:4096:8`, cuDNN's deterministic algorithms
with `benchmark` off and `torch.use_deterministic_algorithms(True,
warn_only=True)`; the port's trainer sets the same when
`trainer.deterministic` is true (the default) and touches none of them
when it is false:

- a trainer built with the flag sets each of them, keeps a caller's own
  `CUBLAS_WORKSPACE_CONFIG`, and logs one warning naming the variable when
  CUDA was initialised before it was set; without the flag nothing moves;
- `train.main` applies them before it builds its trainer;
- `critic_numerics.arithmetic(TORCH_DEFAULTS)` turns deterministic
  algorithms off for its block in a process where a trainer has run, and
  restores them after; the quality campaign's `run_training` leaves the
  process as it found it, records what the leg trained under and the
  checkpoint's digest, and two legs trained alike have equal digests and
  text files.

Each test restores torch's switches and the environment it changed.
"""

from __future__ import annotations

import os
from unittest import mock

import pytest
import torch

from pixel_heal_thyself_tpu_torch import train as ptrain
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
from pixel_heal_thyself_tpu_torch.config.run_dirs import (
    register_run_dirs_resolver,
    reset_run_dirs_cache,
)
from pixel_heal_thyself_tpu_torch.tools import critic_numerics as cn
from pixel_heal_thyself_tpu_torch.training import checkpoints
from pixel_heal_thyself_tpu_torch.training import trainer as trainer_mod

TINY = ["data.patches.num_patches=8", "data.images.synthetic_size=96",
        "model.feature_map_channels=32", "model.afgsa.self_attention.num_layers=1"]
# what the reference sets, as `critic_numerics.switches_now` reads it
REFERENCE = {"cudnn_deterministic": True, "deterministic_algorithms": "warn_only"}


@pytest.fixture(autouse=True)
def _defaults():
    """Each test from torch's defaults with no CUBLAS_WORKSPACE_CONFIG and
    a new seed (so `set_determinism` seeds again); all restored after."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    benchmark = torch.backends.cudnn.benchmark
    reset_run_dirs_cache()
    with cn.arithmetic(cn.TORCH_DEFAULTS), mock.patch.dict(os.environ, env, clear=True), \
            mock.patch.object(trainer_mod, "_last_determinism_seed", [None]):
        torch.backends.cudnn.benchmark = True  # autotuning on: the trainer turns it off
        yield
    torch.backends.cudnn.benchmark = benchmark
    reset_run_dirs_cache()


def _trainer(tmp_path, deterministic: bool):
    register_run_dirs_resolver()
    cfg = ConfigRegistry.create_config(compose(
        "ci", [*TINY, f"trainer.deterministic={str(deterministic).lower()}",
               f"paths.output_dir={tmp_path}"]))
    return trainer_mod.AFGSATrainer(cfg, device="cpu")


def _state() -> dict:
    return {**cn.switches_now(), "benchmark": torch.backends.cudnn.benchmark,
            "workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}


def test_deterministic_trainer_sets_what_the_reference_sets(tmp_path):
    before = _state()
    assert before["deterministic_algorithms"] is False and before["workspace"] is None
    _trainer(tmp_path, True)
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.is_deterministic_algorithms_warn_only_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert _state() == {**before, **REFERENCE, "benchmark": False, "workspace": ":4096:8"}


def test_callers_workspace_value_is_kept(tmp_path):
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":16:8"
    _trainer(tmp_path, True)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    assert torch.are_deterministic_algorithms_enabled()


def test_non_deterministic_trainer_touches_nothing(tmp_path):
    before = _state()
    trainer = _trainer(tmp_path, False)
    assert _state() == before
    assert trainer.padding_mode == "reflect"


@pytest.mark.parametrize("workspace, warned", [(None, True), (":16:8", False)])
def test_one_warning_when_cuda_was_initialised(workspace, warned):
    if workspace:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
    with mock.patch.object(torch.cuda, "is_initialized", return_value=True), \
            mock.patch.object(trainer_mod.logger, "warning") as warning:
        trainer_mod.deterministic_algorithms()
        trainer_mod.deterministic_algorithms()  # now set: no second warning
    assert warning.call_count == int(warned)
    if warned:
        assert "CUBLAS_WORKSPACE_CONFIG" in warning.call_args[0][0]
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == (workspace or ":4096:8")


@pytest.mark.parametrize("deterministic", [True, False])
def test_train_main_applies_them_before_the_trainer(tmp_path, monkeypatch, deterministic):
    monkeypatch.chdir(tmp_path)
    seen = {}

    def build(cfg, device, **kwargs):
        seen.update(_state())

        class Done:
            def train(self):
                pass
        return Done()

    monkeypatch.setattr(ptrain, "_build_trainer", build)
    before = _state()
    ptrain.main(["-cn", "ci", "--device", "cpu", *TINY,
                 f"trainer.deterministic={str(deterministic).lower()}"])
    if deterministic:
        assert seen == {**before, **REFERENCE, "benchmark": False, "workspace": ":4096:8"}
    else:
        assert seen == before


def test_arithmetic_of_torch_defaults_after_a_trainer(tmp_path):
    _trainer(tmp_path, True)
    after_trainer = cn.switches_now()
    assert after_trainer["deterministic_algorithms"] == "warn_only"
    with cn.arithmetic(cn.TORCH_DEFAULTS):
        assert not torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.deterministic
        assert cn.switches_now() == cn.TORCH_DEFAULTS
    assert cn.switches_now() == after_trainer
    assert torch.is_deterministic_algorithms_warn_only_enabled()
    with cn.arithmetic({"deterministic_algorithms": True}):  # warn_only off
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert cn.switches_now() == after_trainer


@pytest.fixture
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_campaign_training_restores_and_repeats(tmp_path, monkeypatch, _two_threads):
    """Two 2a legs trained alike in one process, each leaving the switches
    as it found them: the record says what the leg trained under, its
    digest is the checkpoint's, and the two legs' digests and text files
    are equal."""
    from pixel_heal_thyself_tpu_torch.tools import quality_campaign as qc

    narrow = [*TINY, "data.patches.patch_size=16", "trainer.batch_size=2",
              "trainer.precision=fp32", "trainer.epochs=1"]
    monkeypatch.chdir(tmp_path)  # run directories, as `quality_campaign.run` does
    before = cn.switches_now()
    qc.make_datasets(tmp_path, ("clean05",), size=64, n_scenes=2, log=lambda _: None)
    (leg,) = [leg for leg in qc.TRAINING if leg.name == "2a"]
    recs = []
    for out in ("a", "b"):
        (tmp_path / out).mkdir()
        with mock.patch.dict(os.environ):  # the trainer's CUBLAS_WORKSPACE_CONFIG
            rec, ckpt = qc.run_training(leg, tmp_path, tmp_path / out, narrow, "cpu",
                                        log=lambda _: None)
        assert cn.switches_now() == before
        assert rec["arithmetic"] == {**before, **REFERENCE}
        assert rec["checkpoint_digest"] == checkpoints.digest(ckpt)
        recs.append(rec)
    assert recs[0]["run"] != recs[1]["run"]
    assert recs[0]["checkpoint_digest"] == recs[1]["checkpoint_digest"]
    for name in ("train_loss.txt", "evaluation.txt"):
        assert (tmp_path / "a" / f"{recs[0]['run']}_{name}").read_bytes() == \
            (tmp_path / "b" / f"{recs[1]['run']}_{name}").read_bytes()


def test_digest_sees_one_bit(tmp_path):
    state = {"g": {"w": torch.ones(3, dtype=torch.bfloat16)}, "d": {},
             "g_opt": {"state": {0: {"step": torch.tensor(2.0)}}}, "d_opt": {}}
    torch.save(state, tmp_path / checkpoints.FILE)
    first = checkpoints.digest(tmp_path)
    state["g"]["w"].view(torch.int16)[1] += 1  # one ulp
    torch.save(state, tmp_path / checkpoints.FILE)
    second = checkpoints.digest(tmp_path)
    assert first["g"] != second["g"]
    assert {k: v for k, v in first.items() if k != "g"} == \
        {k: v for k, v in second.items() if k != "g"}

"""PyTorch port: the training runtime on the CPU, against the JAX package.

- `utils.images.tensor2img` gives the JAX function's uint8 bytes; the
  untitled Noisy | Output | Reference panel PNG decodes (OpenCV) back to
  the panel's pixels.
- Checkpoints round-trip to the bit: both networks, both Adams' moments
  and counts, both schedules, the GP generator's state and the epoch; the
  next step from the restored state equals the next step from the saved
  one to the bit.
- `_validate_and_save` writes the same `evaluation.txt` bytes and panel
  set at val batch 1 and 3, and the same bytes as the JAX trainer's.
- `-m` sweeps expand as the JAX `_expand_multirun` does and land in the
  same `outputs/trials/runNNN/<overrides>` directories.
- Without a card and without `--device cpu`, `python -m
  pixel_heal_thyself_tpu_torch.train` raises. The CLI's training runs are
  in tests/test_torch_port_trainer_cli.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import torch  # noqa: E402

from pixel_heal_thyself_tpu import train as jtrain  # noqa: E402
from pixel_heal_thyself_tpu.training import trainer as jtrainer_mod  # noqa: E402
from pixel_heal_thyself_tpu.utils import images as jimages  # noqa: E402
from pixel_heal_thyself_tpu_torch import train as ptrain  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.training import checkpoints  # noqa: E402
from pixel_heal_thyself_tpu_torch.training import trainer as trainer_mod  # noqa: E402
from pixel_heal_thyself_tpu_torch.training.train_step import (  # noqa: E402
    LossesConfig,
    TrainState,
    make_optimizer,
    make_train_step,
    multistep_schedule,
)
from pixel_heal_thyself_tpu_torch.utils import images  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# tests/test_trainer_e2e.py:93 (AFGSA) and tests/test_mamba_e2e.py:16 (Mamba),
# at 8 patches an image for both (the AFGSA test's 16 doubles the CPU time)
TINY = {
    "afgsa": ["data.patches.num_patches=8", "data.images.synthetic_size=96",
              "model.feature_map_channels=32", "model.afgsa.self_attention.num_layers=1"],
    "mamba": ["model=mamba", "data.patches.num_patches=8", "data.images.synthetic_size=96",
              "model.feature_map_channels=16", "model.mamba.num_layers=1",
              "model.mamba.expansion=2", "model.mamba.headdim=8", "model.mamba.d_state=8"],
}


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


@pytest.mark.parametrize("post_spec", [False, True])
def test_tensor2img_matches_jax(post_spec):
    x = np.random.default_rng(4).standard_normal((2, 9, 7, 3)).astype(np.float32) * 3
    got = images.tensor2img(x, post_spec=post_spec)
    want = jimages.tensor2img(x, post_spec=post_spec)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert images.tensor2img(x[0]).tobytes() == jimages.tensor2img(x[0]).tobytes()


def test_panel_png_decodes_to_the_panel(tmp_path):
    rng = np.random.default_rng(5)
    noisy, out, ref = (rng.integers(0, 256, (2, 13, 11, 3), dtype=np.uint8) for _ in range(3))
    images.save_img_group(str(tmp_path), 7, noisy, out, ref)  # 4-d: the first sample
    back = cv2.imread(str(tmp_path / "7.png"), cv2.IMREAD_UNCHANGED)
    assert back is not None and back.dtype == np.uint8
    np.testing.assert_array_equal(back[..., ::-1], np.concatenate([noisy[0], out[0], ref[0]], 1))
    with pytest.raises(ValueError, match="uint8"):
        images.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))


def _tiny_state(seed: int):
    g = AFGSANet(base_ch=16, enc_ch=8, num_sa=1, num_heads=2, num_gcp=0,
                 padding_mode="replicate", generator=torch.Generator().manual_seed(seed))
    d = DiscriminatorVGG(input_size=16, base_nf=8, generator=torch.Generator().manual_seed(seed + 1))
    spec = make_optimizer(1e-3, [1], 0.5, 2)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    state = TrainState(g, d, step.g_opt, step.d_opt, step.g_sched, step.d_sched,
                       torch.Generator().manual_seed(seed + 2))
    return step, state


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"noisy": torch.from_numpy(np.abs(rng.standard_normal((2, 16, 16, 3)), dtype=np.float32)),
            "gt": torch.from_numpy(np.abs(rng.standard_normal((2, 16, 16, 3)), dtype=np.float32)),
            "aux": torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 7)).astype(np.float32))}


def _assert_state_equal(a, b) -> None:
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_state_equal(x, y)
    else:
        assert a == b


def test_checkpoint_round_trip_to_the_bit(tmp_path):
    step_a, state_a = _tiny_state(0)
    for i in range(3):  # past the schedule's milestone (count 2)
        step_a(_batch(i), generator=state_a.generator)
    checkpoints.save_checkpoint(tmp_path / "state", state_a, 4)
    assert sorted(os.listdir(tmp_path / "state")) == [checkpoints.FILE]

    step_b, state_b = _tiny_state(10)
    assert checkpoints.restore_checkpoint(tmp_path / "state", state_b) == 4
    for name in ("g", "d", "g_opt", "d_opt", "g_sched", "d_sched"):
        _assert_state_equal(getattr(state_b, name).state_dict(),
                            getattr(state_a, name).state_dict())
    assert torch.equal(state_b.generator.get_state(), state_a.generator.get_state())
    assert state_b.g_sched.last_epoch == 3
    assert state_b.g_opt.param_groups[0]["lr"] == multistep_schedule(1e-3, [1], 0.5, 2)(3)

    # the next step from either state is the same step
    m_a = step_a(_batch(7), generator=state_a.generator)
    m_b = step_b(_batch(7), generator=state_b.generator)
    for key in m_a:
        assert torch.equal(m_a[key], m_b[key]), key
    _assert_state_equal(state_b.g.state_dict(), state_a.g.state_dict())

    checkpoints.save_params(tmp_path / "g.pt", state_a.g)
    _assert_state_equal(checkpoints.restore_params(tmp_path / "g.pt"), state_a.g.state_dict())
    _assert_state_equal(checkpoints.restore_params(tmp_path / "state"),
                        torch.load(tmp_path / "state" / checkpoints.FILE)["g"])


def _val_data():
    rng = np.random.default_rng(3)
    n, h = 7, 16
    noisy = rng.random((n, h, h, 3)).astype(np.float32) * 2.0
    gt = rng.random((n, h, h, 3)).astype(np.float32) * 2.0
    return n, noisy, gt


def test_validate_and_save_batch_size_invariant_and_as_jax(tmp_path, monkeypatch):
    """Batched validation writes the reference's batch-1 evaluation.txt and
    panel set (tests/test_trainer_e2e.py:46), byte for byte the JAX
    trainer's."""
    monkeypatch.setattr(checkpoints, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jtrainer_mod.checkpoints, "save_checkpoint", lambda *a, **k: None)
    n, noisy, gt = _val_data()

    def loader(bs):
        for i in range(0, n, bs):
            yield {"noisy": torch.from_numpy(noisy[i : i + bs]),
                   "gt": torch.from_numpy(gt[i : i + bs])}

    def eval_fn(batch):
        return batch["noisy"] * 0.9, batch["noisy"], batch["gt"]

    t = trainer_mod.BaseTrainer.__new__(trainer_mod.BaseTrainer)
    results = {}
    for bs in (1, 3):
        root = tmp_path / f"bs{bs}"
        root.mkdir()
        t._validate_and_save(0, None, eval_fn, loader(bs), n, str(root), 3)
        results[bs] = ((root / "evaluation.txt").read_bytes(),
                       sorted(os.listdir(root / "model_epoch1")))
    assert results[1] == results[3]
    assert results[1][1] == ["0.png", "3.png", "6.png"]

    jt = jtrainer_mod.BaseTrainer.__new__(jtrainer_mod.BaseTrainer)
    jt.is_main = True
    root = tmp_path / "jax"
    root.mkdir()
    jbatches = ({"noisy": noisy[i : i + 3], "gt": gt[i : i + 3]} for i in range(0, n, 3))
    jt._validate_and_save(0, type("S", (), {"params": None})(), None,
                          lambda params, b: (b["noisy"] * np.float32(0.9), b["noisy"], b["gt"]),
                          jbatches, n, str(root), 3)
    assert (root / "evaluation.txt").read_bytes() == results[1][0]
    assert sorted(os.listdir(root / "model_epoch1")) == results[1][1]


@pytest.mark.parametrize("overrides", [["a=1,2", "b=x"], ["seed=1,2,3"], ["x=1", "y=a,b", "z=3,4"],
                                       []])
def test_expand_multirun_matches_jax(overrides):
    assert ptrain._expand_multirun(overrides) == jtrain._expand_multirun(overrides)


def _tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_multirun_directories_match_jax(tmp_path, monkeypatch):
    """Both CLIs, their trainers replaced by no-ops, lay a `-m` sweep out
    in the same directories with the same overrides files."""
    from pixel_heal_thyself_tpu.config.run_dirs import reset_run_dirs_cache as jreset

    class Idle:
        def train(self):
            pass

    monkeypatch.setenv("PHT_NO_COMPILATION_CACHE", "1")
    monkeypatch.setattr(jtrain, "_build_trainer", lambda cfg: Idle())
    monkeypatch.setattr(ptrain, "_build_trainer", lambda cfg, device: Idle())
    argv = ["-cn", "ci", "-m", "seed=1,2", "trainer.epochs=1,3"]
    for name, main in (("jax", jtrain.main), ("port", lambda a: ptrain.main(a + ["--device", "cpu"]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main(list(argv))
        jreset()
        reset_run_dirs_cache()
    port_tree = _tree(tmp_path / "port" / "outputs")
    assert port_tree == _tree(tmp_path / "jax" / "outputs")
    assert "trials/run000/seed=2,trainer.epochs=3/.hydra/overrides.yaml" in port_tree
    for rel in port_tree:
        if rel.endswith("overrides.yaml"):
            assert ((tmp_path / "port" / "outputs" / rel).read_bytes()
                    == (tmp_path / "jax" / "outputs" / rel).read_bytes())


def test_cli_without_a_card_raises(tmp_cwd):
    """`python -m pixel_heal_thyself_tpu_torch.train` without `--device cpu`
    on a machine with no card raises before it makes a run directory."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "pixel_heal_thyself_tpu_torch.train", "-cn", "ci", *TINY["afgsa"]],
        cwd=tmp_cwd, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_cwd / "outputs").exists()

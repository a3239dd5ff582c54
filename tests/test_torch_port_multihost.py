"""PyTorch port: multi-process training, the counterparts of tests/test_multihost.py.

- `tests/multihost_worker.py`'s DP step loop: gloo worlds of 2 and 4 CPU
  ranks (`spawn_world`, one torch thread a rank) run
  `tests/torch_port_training_workers.loader_rank`: each rank reads its
  `host_batch_bounds` rows of every global batch (4) of one 12-patch
  store through `PrefetchLoader(host_bounds=...)` and steps a small AFGSA
  GAN over its data group. The ranks' rows are disjoint and, in rank
  order, are the one-process batch; every rank sees the same losses
  (rtol 1e-6), and they follow the one-process trajectory within rtol
  1e-4 / atol 1e-6, as the JAX test holds its two processes to one.
- `make_mesh`'s resolution over the world size (the cases of
  `test_auto_data_axis` through `parallel.data_axis=-1`): 8 rows over 4
  ranks train 4-way, over 2 ranks 2-way, with 2 model ranks 2 × 2; a grid
  that does not cover the world raises, as the JAX multi-host check does.
- `tests/multihost_trainer_worker.py`'s `AFGSATrainer.train()` over one
  shared working directory, in the 4-rank world: 4-way DP (batch 4, 1
  epoch, 16 patches of 96² images, width 32) against the same run 2-way
  DP × 2-way TP, which is the 2-way DP trajectory to the bit
  (tests/test_torch_port_tp.py): `train_loss.txt` within rtol 2e-3 for G
  and 5e-2 of the largest |D| for D, `evaluation.txt` within rtol 2e-3
  (tests/test_torch_port_dp_trainer.py says why); one `model_epoch1` a
  run, written by rank 0 alone.
- `parallel.dryrun` (the counterpart of `dryrun_multichip`) at 2 and 4
  ranks: one GAN step over 2 × 1 and 2 × 2 grids, a row-sharded AFGSA
  frame and a sequence-sharded Mamba frame, all finite.
- The CLI, `python -m torch.distributed.run --nproc-per-node 2 -m
  pixel_heal_thyself_tpu_torch.train -cn ci --device cpu
  parallel.multihost=true`: both ranks join one gloo group, train 2-way DP
  and rank 0 alone makes the run directory and writes its files.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pixel_heal_thyself_tpu_torch.data.dataset import PatchDataset, PrefetchLoader
from pixel_heal_thyself_tpu_torch.parallel import distributed

import torch_port_training_workers as workers

REPO = Path(__file__).resolve().parent.parent
BATCH, SEED, N_PATCHES = 4, 11, 12
TRAINER = ["trainer.epochs=1", "trainer.batch_size=4", "data.patches.num_patches=16",
           "data.images.synthetic_size=96", "model.feature_map_channels=32",
           "+model.enc_channels=32", "model.afgsa.self_attention.num_layers=1",
           "model.num_gradient_checkpoints=0"]
RUN = Path("outputs/runs/afgsa_p32_n16_r1.0")
DEADLINE = 400


def _make_store(path: Path, n: int = N_PATCHES, patch: int = 16) -> None:
    """tests/test_multihost.py's store, as the port's `.npy` split."""
    rng = np.random.default_rng(0)
    path.mkdir(parents=True)
    np.save(path / "noisy.npy", rng.uniform(0, 2, (n, patch, patch, 3)).astype(np.float32))
    np.save(path / "gt.npy", rng.uniform(0, 2, (n, patch, patch, 3)).astype(np.float32))
    aux = rng.uniform(-1, 1, (n, patch, patch, 7)).astype(np.float32)
    aux[:, 0, 0, 0] = np.arange(n)  # a row's name
    np.save(path / "aux.npy", aux)


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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory) -> dict:
    tmp = tmp_path_factory.mktemp("multihost")
    store = tmp / "store"
    _make_store(store)
    out = {}
    for ranks in (2, 4):
        d = tmp / f"world{ranks}"
        d.mkdir()
        runs = None
        if ranks == 4:
            (d / "work").mkdir()
            runs = [[*TRAINER, "parallel.data_axis=4", "run_num=0"],
                    [*TRAINER, "parallel.data_axis=2", "parallel.model_axis=2", "run_num=1"]]
        distributed.spawn_world(workers.loader_rank, ranks, f"file://{d}/init", "cpu",
                                args=(str(d), str(store), BATCH, SEED, runs, str(d / "work")),
                                threads=1, deadline=DEADLINE)
        out[ranks] = [torch.load(d / f"loader_rank{r}.pt", weights_only=False)
                      for r in range(ranks)]
        if runs:
            out["trainer"] = [torch.load(d / f"trainer_rank{r}.pt", weights_only=False)
                              for r in range(ranks)]
            out["work"] = d / "work"
    # one process: the same loop, no process group
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, step = workers.small_gan()
        gen = torch.Generator().manual_seed(7)
        losses, rows = [], []
        for b in PrefetchLoader(PatchDataset(store), batch_size=BATCH, shuffle=True, seed=SEED,
                                drop_last=True, device="cpu"):
            rows.append(b["aux"][:, 0, 0, 0].numpy().copy())
            m = step(b, generator=gen)
            losses.append([float(m["g_loss"]), float(m["d_loss"])])
    finally:
        torch.set_num_threads(threads)
    out[1] = [{"losses": losses, "rows": rows}]
    return out


def test_ranks_import_no_jax(worlds):
    assert not any(r["jax_loaded"] for n in (2, 4) for r in worlds[n])
    assert not any(r["jax_loaded"] for r in worlds["trainer"])


@pytest.mark.parametrize("ranks", [2, 4])
def test_ranks_read_disjoint_slices_of_every_global_batch(worlds, ranks):
    one = worlds[1][0]["rows"]
    assert len(one) == N_PATCHES // BATCH
    for b, want in enumerate(one):
        got = [worlds[ranks][r]["rows"][b] for r in range(ranks)]
        assert all(len(g) == BATCH // ranks for g in got)
        assert np.array_equal(np.concatenate(got), want)


@pytest.mark.parametrize("ranks", [2, 4])
def test_ranks_train_the_one_process_trajectory(worlds, ranks):
    recs = worlds[ranks]
    for rec in recs[1:]:
        np.testing.assert_allclose(rec["losses"], recs[0]["losses"], rtol=1e-6)
    np.testing.assert_allclose(recs[0]["losses"], worlds[1][0]["losses"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ranks", [2, 4])
def test_data_axis_resolves_over_the_world(worlds, ranks):
    got = worlds[ranks][0]["meshes"]
    want = {2: {(-1, 1, 8): (2, 1), (-1, 2, 8): (1, 2), (2, 1, 8): (2, 1)},
            4: {(-1, 1, 8): (4, 1), (-1, 2, 8): (2, 2)}}[ranks]
    for args, mesh in want.items():
        assert got[args] == mesh, args
    # a grid short of the world raises: auto_data_axis(4, 1, 2) = 2 of 4
    # ranks, auto_data_axis(n, 1, 3) = 1 or 3, an explicit 2 or 3 of 4
    refused = [args for args, mesh in got.items() if isinstance(mesh, str)]
    assert refused == {2: [(-1, 1, 3), (3, 1, 8)],
                       4: [(-1, 1, 2), (-1, 1, 3), (2, 1, 8), (3, 1, 8)]}[ranks]
    assert all("covers" in got[args] for args in refused)
    for r in worlds[ranks][1:]:
        assert r["meshes"] == got


def _numbers(path: Path) -> np.ndarray:
    return np.asarray([[float(v) for v in re.findall(r"-?\d+\.\d+", line)]
                       for line in path.read_text().strip().splitlines()])


def test_four_rank_trainer_dp_against_dp_tp(worlds):
    ranks = worlds["trainer"]
    assert [r["runs"][0]["mesh"] for r in ranks] == [(4, 1)] * 4
    assert [r["runs"][1]["mesh"] for r in ranks] == [(2, 2)] * 4
    work = worlds["work"]
    assert sorted(p.name for p in (work / RUN).iterdir()) == ["run000", "run001"]
    dp4, dp2tp2 = work / RUN / "run000", work / RUN / "run001"
    for run in (dp4, dp2tp2):
        assert sorted(p.name for p in run.iterdir() if p.name.startswith("model_epoch")) == [
            "model_epoch1"]
        assert (run / "model_epoch1" / "state" / "checkpoint.pt").is_file()
    got, want = _numbers(dp4 / "train_loss.txt"), _numbers(dp2tp2 / "train_loss.txt")
    assert got.shape == want.shape == (1, 2)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-3)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=5e-2 * np.abs(want[:, 1]).max())
    np.testing.assert_allclose(_numbers(dp4 / "evaluation.txt"),
                               _numbers(dp2tp2 / "evaluation.txt"), rtol=2e-3)
    for run in (0, 1):  # every rank ends equal
        for part in ("g", "d"):
            for name, value in ranks[0]["runs"][run][part].items():
                assert all(np.array_equal(r["runs"][run][part][name], value) for r in ranks[1:])


def test_cli_under_torch_distributed_run(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "PHT_COORDINATOR")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "pixel_heal_thyself_tpu_torch.train", "-cn", "ci", "--device", "cpu",
         "parallel.multihost=true", "trainer.epochs=1", "data.patches.num_patches=8",
         "data.images.synthetic_size=96", "model.feature_map_channels=16",
         "model.afgsa.self_attention.num_layers=1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=DEADLINE,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    log = proc.stdout + proc.stderr
    assert len(re.findall(r"\[dist\] rank \d of 2: backend gloo", log)) == 2
    assert "Mesh: 2 data x 1 model over 2 ranks" in log
    runs = list((tmp_path / "outputs" / "runs").glob("*/*"))
    assert [p.name for p in runs] == ["run000"]
    files = sorted(p.name for p in runs[0].iterdir())
    assert files == [".hydra", "evaluation.txt", "model_epoch1", "train_loss.txt"]
    assert len((runs[0] / "train_loss.txt").read_text().splitlines()) == 1


@pytest.mark.parametrize("ranks,grid", [(2, "2 data x 1 model"), (4, "2 data x 2 model")])
def test_dryrun(ranks, grid):
    from pixel_heal_thyself_tpu_torch.parallel.dryrun import dryrun

    msg = dryrun(ranks, "cpu")
    assert msg.startswith(f"dryrun OK: mesh=({grid}), batch=4") and msg.endswith("ranks OK")

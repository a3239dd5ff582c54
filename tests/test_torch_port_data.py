"""PyTorch port: training data against the JAX package (CPU, small sizes).

- `importance_sampling`: the same patch positions, and the same
  `random.Random` state after it, as the JAX function, for several seeds,
  on the native and the pure-Python paths; `get_cropped_patches` equal
  to the bit.
- The patch store: `data/store.py`'s `.npy` splits equal to the bit to
  the JAX `Hdf5Constructor`'s `train.h5` / `val.h5` (h5py on the JAX side
  only): byte for byte, in order, at one worker; as a multiset of samples
  at three workers, where the JAX store's order depends on which thread
  finishes first.
- `PrefetchLoader` and `DeviceLoader` (`device="cpu"`): epoch order and
  batch bytes equal to the JAX `PrefetchLoader`'s over 3 epochs,
  shuffled and not, with `drop_last` both ways.
- `data.loader=auto` resolution, and `grain` refused.
- The port's native binding builds into `build/native/` and leaves
  `native/` unchanged; its RNG hooks advance `random.Random` as Python.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from random import Random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

from pixel_heal_thyself_tpu.data import dataset as jdataset  # noqa: E402
from pixel_heal_thyself_tpu.data import preprocessing as jprep  # noqa: E402
from pixel_heal_thyself_tpu.data.hdf5 import Hdf5Constructor  # noqa: E402
from pixel_heal_thyself_tpu_torch import native  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.data import preprocessing  # noqa: E402
from pixel_heal_thyself_tpu_torch.data.dataset import (  # noqa: E402
    DeviceLoader,
    PatchDataset,
    PrefetchLoader,
)
from pixel_heal_thyself_tpu_torch.data.store import PatchStoreConstructor  # noqa: E402
from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset  # noqa: E402

KEYS = ("noisy", "gt", "aux")
REPO = Path(__file__).resolve().parent.parent
# store geometry: 8 scenes → 2 seed pairs + 6 split 3/3 at ratio 0.5
PATCH, NUM_PATCHES, SIZE, RATIO, SEED = 16, 8, 64, 0.5, 5
SCENES = [f"scene{i}_0" for i in range(8)]


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
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    generate_dataset(root, scenes=SCENES, height=SIZE, width=SIZE, seed=2)
    return root


@pytest.fixture(scope="module")
def frame(images):
    return preprocessing.preprocess_data(str(images / "32spp" / "scene0_0_32"),
                                         str(images / "1024spp" / "scene0_0_1024"))


def _stores(images, tmp_path_factory, workers: int):
    """(port store dir, JAX store dir) built from the same tree."""
    port = tmp_path_factory.mktemp(f"port{workers}")
    jx = tmp_path_factory.mktemp(f"jax{workers}")
    args = (str(images), None, PATCH, NUM_PATCHES, SEED, RATIO)
    PatchStoreConstructor(args[0], str(port), *args[2:], num_workers=workers).construct_store()
    Hdf5Constructor(args[0], str(jx), *args[2:], num_workers=workers).construct_hdf5()
    return port, jx


@pytest.fixture(scope="module")
def stores1(images, tmp_path_factory):
    return _stores(images, tmp_path_factory, 1)


@pytest.fixture(scope="module")
def stores3(images, tmp_path_factory):
    return _stores(images, tmp_path_factory, 3)


def _h5(path) -> dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in KEYS}


def _npy(split_dir) -> dict[str, np.ndarray]:
    return {k: np.load(Path(split_dir) / f"{k}.npy") for k in KEYS}


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("seed", [0, 1, 990819])
def test_importance_sampling_matches_jax(frame, seed, use_native):
    if use_native:
        assert native.get_lib() is not None, "g++ should build the port's sampler here"
    got_rng, want_rng = Random(seed), Random(seed)
    got = preprocessing.importance_sampling(frame, PATCH, 24, got_rng, use_native=use_native)
    want = jprep.importance_sampling(frame, PATCH, 24, want_rng, use_native=use_native)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    assert got_rng.getstate() == want_rng.getstate()


def test_native_and_python_paths_agree(frame):
    rng_n, rng_p = Random(3), Random(3)
    np.testing.assert_array_equal(
        preprocessing.importance_sampling(frame, PATCH, 24, rng_n, use_native=True),
        preprocessing.importance_sampling(frame, PATCH, 24, rng_p, use_native=False))
    assert rng_n.getstate() == rng_p.getstate()


def test_too_small_image_raises_as_jax(frame):
    small = {k: v[:PATCH, :PATCH] for k, v in frame.items()}
    with pytest.raises(ValueError, match="too small"):
        preprocessing.importance_sampling(small, PATCH, 4, Random(0))
    with pytest.raises(ValueError, match="too small"):
        jprep.importance_sampling(small, PATCH, 4, Random(0))


def test_get_cropped_patches_matches_jax(images):
    pair = (str(images / "32spp" / "scene3_0_32"), str(images / "1024spp" / "scene3_0_1024"))
    got, got_pos = preprocessing.get_cropped_patches(*pair, PATCH, 12, Random(9))
    want, want_pos = jprep.get_cropped_patches(*pair, PATCH, 12, Random(9))
    np.testing.assert_array_equal(got_pos, want_pos)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"noisy", "gt", "aux"}
        for key in g:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("split", ["train", "val"])
def test_store_matches_jax_byte_for_byte_at_one_worker(stores1, split):
    port, jx = stores1
    got, want = _npy(port / split), _h5(jx / f"{split}.h5")
    for key in KEYS:
        assert got[key].dtype == np.float32
        assert got[key].shape == want[key].shape
        assert got[key].tobytes() == want[key].tobytes(), key


def _samples(arrays: dict) -> list[bytes]:
    """Each sample's bytes over all keys, sorted: the store as a multiset."""
    return sorted(b"".join(arrays[k][i].tobytes() for k in KEYS)
                  for i in range(len(arrays["aux"])))


@pytest.mark.parametrize("split", ["train", "val"])
def test_store_matches_jax_as_multiset_at_three_workers(images, stores3, split, tmp_path):
    port, jx = stores3
    got, want = _npy(port / split), _h5(jx / f"{split}.h5")
    assert _samples(got) == _samples(want)
    # the port writes in work-item order: the same bytes every build
    PatchStoreConstructor(str(images), str(tmp_path), PATCH, NUM_PATCHES, SEED, RATIO,
                          num_workers=3).construct_store()
    for key in KEYS:
        assert np.load(tmp_path / split / f"{key}.npy").tobytes() == got[key].tobytes()


def test_store_is_complete_only_once_written(images, tmp_path):
    from pixel_heal_thyself_tpu_torch.data.store import store_complete

    assert not store_complete(tmp_path)
    PatchStoreConstructor(str(images), str(tmp_path), PATCH, NUM_PATCHES, SEED, RATIO,
                          num_workers=2).construct_store()
    assert store_complete(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["train", "val"]


@pytest.mark.parametrize("kind", ["prefetch", "device"])
@pytest.mark.parametrize("drop_last", [False, True], ids=["keep_last", "drop_last"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "ordered"])
def test_loaders_match_jax_prefetch_loader(stores1, kind, shuffle, drop_last):
    port, jx = stores1
    ds = PatchDataset(port / "train")
    jds = jdataset.PatchDataset(str(jx / "train.h5"))
    assert len(ds) == len(jds) and len(ds) % 3  # a ragged last batch
    kw = dict(batch_size=3, shuffle=shuffle, seed=11, drop_last=drop_last)
    if kind == "prefetch":
        loader = PrefetchLoader(ds, device="cpu", workers=2, **kw)
    else:
        loader = DeviceLoader(ds, device="cpu", **kw)
    want_loader = jdataset.PrefetchLoader(jds, **kw)
    assert len(loader) == len(want_loader)
    for _ in range(3):  # the epoch counter advances alike
        got = list(loader)
        want = list(want_loader)
        assert len(got) == len(want) == len(loader)
        for gb, wb in zip(got, want):
            for key in KEYS:
                assert isinstance(gb[key], torch.Tensor) and gb[key].dtype == torch.float32
                assert gb[key].numpy().tobytes() == np.asarray(wb[key]).tobytes()


def test_patch_dataset_ram_and_mmap_agree(stores1):
    port, _ = stores1
    cached = PatchDataset(port / "val", cache_in_ram=True)
    mapped = PatchDataset(port / "val", cache_in_ram=False)
    assert cached.cached and not mapped.cached
    idx = np.array([3, 0, 2, 1])
    for key in KEYS:
        np.testing.assert_array_equal(cached.batch(idx)[key], mapped.batch(idx)[key])
    assert cached.nbytes == sum(a.nbytes for a in mapped.arrays().values())


def _trainer(tmp_path, overrides):
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.config.run_dirs import register_run_dirs_resolver
    from pixel_heal_thyself_tpu_torch.training.trainer import AFGSATrainer

    register_run_dirs_resolver()
    cfg = ConfigRegistry.create_config(compose("ci", overrides))
    return AFGSATrainer(cfg, device="cpu")


@pytest.mark.parametrize("limit_gb,kind", [(6.0, "device"), (1e-9, "native")])
def test_loader_auto_resolution(stores1, tmp_cwd, limit_gb, kind):
    port, _ = stores1
    trainer = _trainer(tmp_cwd, [f"data.patches.dir={port}", f"data.device_cache_limit_gb={limit_gb}"])
    train_loader, val_loader, n_train, n_val = trainer.setup_dataloaders()
    assert trainer.loader_kind == kind
    cls = DeviceLoader if kind == "device" else PrefetchLoader
    assert type(train_loader) is cls and type(val_loader) is cls
    assert (n_train, n_val) == (len(PatchDataset(port / "train")), len(PatchDataset(port / "val")))


def test_grain_loader_is_refused(stores1, tmp_cwd):
    trainer = _trainer(tmp_cwd, [f"data.patches.dir={stores1[0]}", "data.loader=grain"])
    with pytest.raises(NotImplementedError, match="Not to port"):
        trainer.setup_dataloaders()


def _tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_native_binding_builds_into_build_dir(tmp_path, monkeypatch):
    before = _tree_digest(REPO / "native")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    lib = native.get_lib()
    assert lib is not None
    built = list((tmp_path / "build" / "native").iterdir())
    assert [p.name for p in built] == [native.library_path().name]
    assert _tree_digest(REPO / "native") == before
    # the default location is the repository's git-ignored build/ tree
    assert native.library_path().parent == tmp_path / "build" / "native"
    monkeypatch.undo()
    assert native.BUILD_DIR == REPO / "build" / "native"


def test_native_rng_hooks_advance_like_python():
    py, cc = Random(12345), Random(12345)
    want = [py.random() for _ in range(700)]
    np.testing.assert_array_equal(native.mt_random_doubles(cc, 700), want)
    assert py.getstate() == cc.getstate()
    want = [py.randint(3, 517) for _ in range(300)]
    np.testing.assert_array_equal(native.mt_randints(cc, 3, 517, 300), want)
    assert py.getstate() == cc.getstate()


def test_prefetch_loader_order_under_thread_pressure(stores1):
    """More reader threads than cores, with a short switch interval: the
    epoch's batches still arrive in order (batch b from thread b % workers)."""
    import sys

    ds = PatchDataset(stores1[0] / "train")
    want = [b["noisy"].numpy().tobytes() for b in PrefetchLoader(ds, 2, seed=3, device="cpu")]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = PrefetchLoader(ds, 2, seed=3, device="cpu", workers=12, prefetch=1)
        got = [b["noisy"].numpy().tobytes() for b in loader]
    finally:
        sys.setswitchinterval(interval)
    assert got == want

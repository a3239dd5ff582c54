"""Patch-store construction: `.npy` stores that numpy alone reads.

Port of `pixel_heal_thyself_tpu/data/hdf5.py` (`Hdf5Constructor`;
behavioural spec: reference `pht/models/afgsa/gen_hdf5.py:15-195`): walk
`<images>/{<n>spp,<gt>spp}` pairing EXRs by `<scene>_<idx>`, shuffle with
the seed, seed the train and val stores from the first two pairs (drawing
from one `Random(seed)`), split the rest `data_ratio` : 1 − `data_ratio`,
and extract the rest's patches on worker threads, worker k owning work
items k::n_workers with its own `Random(seed + worker_id)`.

A store is one directory per split, `<save_path>/{train,val}/`, holding
`noisy.npy` [N, P, P, 3], `gt.npy` [N, P, P, 3] and `aux.npy` [N, P, P, 7],
float32 NHWC. It is built streamed: every pair's patches go to a shard
file of their own, and the shards are then copied in work-item order into
one `np.lib.format.open_memmap` per array, so the host never holds a whole
store. The split is built under a temporary name and renamed when it is
complete, so a directory named `train` or `val` is always a whole store.

The JAX constructor appends each pair under a lock in the order its
threads finish, so with more than one worker and more than one pair per
split its sample order changes from run to run; this one writes in
work-item order and equals the JAX store byte for byte at one worker, and
as a multiset of samples at any number.
"""

from __future__ import annotations

import os
import random
import shutil
import threading
from pathlib import Path

import numpy as np

from pixel_heal_thyself_tpu_torch.data.preprocessing import get_cropped_patches
from pixel_heal_thyself_tpu_torch.logger import logger

SPLITS = ("train", "val")
KEYS = ("noisy", "gt", "aux")
CHANNELS = {"noisy": 3, "gt": 3, "aux": 7}


def store_complete(save_path: str | Path) -> bool:
    """Whether both splits of the store under `save_path` are built."""
    return all((Path(save_path) / split).is_dir() for split in SPLITS)


class PatchStoreConstructor:
    """Build the {train,val} patch stores from an EXR image tree."""

    def __init__(
        self,
        data_path: str,
        save_path: str,
        patch_size: int,
        num_patches: int,
        seed: int,
        train_val_ratio: float,
        scale: float = 1.0,
        noisy_spp: int = 32,
        gt_spp: int = 1024,
        deterministic: bool = True,
        num_workers: int | None = None,
    ) -> None:
        self.data_path = data_path
        self.save_path = Path(save_path)
        self.patch_size = patch_size
        self.num_patches = num_patches
        self.seed = seed
        self.train_val_ratio = (train_val_ratio, 1 - train_val_ratio)
        self.noisy_spp = noisy_spp
        self.gt_spp = gt_spp
        self.deterministic = deterministic
        self.scale = scale
        self.num_workers = num_workers or max(1, (os.cpu_count() or 2) - 1)
        self.paths: list[tuple[str, str]] = []

    def construct_store(self) -> None:
        logger.info("Constructing data set (npy)")
        self.get_exr_paths()
        self._build_patch_stores()
        logger.info("Constructing data set (npy): done")

    def get_exr_paths(self) -> None:
        """Pair noisy/GT EXRs by `<scene>_<idx>` and shuffle (seeded)."""
        noisy_root = Path(self.data_path) / f"{self.noisy_spp}spp"
        gt_root = Path(self.data_path) / f"{self.gt_spp}spp"
        pairs = []
        for file in sorted(os.listdir(gt_root)):
            if not file.endswith(".exr"):
                continue
            # strip only the trailing `_<spp>.exr` so scene names that
            # themselves contain underscores keep their full stem+index
            stem = file[: -len(".exr")].rsplit("_", 1)[0]
            gt = str(gt_root / f"{stem}_{self.gt_spp}")
            noisy = str(noisy_root / f"{stem}_{self.noisy_spp}")
            if not os.path.exists(f"{noisy}.exr"):
                raise RuntimeError(
                    f"GT frame {file} has no noisy counterpart {noisy}.exr",
                )
            pairs.append((noisy, gt))
        self.paths = pairs
        random.Random(self.seed).shuffle(self.paths)

    def _write_shard(self, shard_dir: Path, pair: tuple[str, str], rng: random.Random) -> int:
        """Extract one pair's patches into `shard_dir/{noisy,gt,aux}.npy`;
        returns the patch count."""
        cropped, _ = get_cropped_patches(
            pair[0], pair[1], self.patch_size, self.num_patches, rng, scale=self.scale,
        )
        shard_dir.mkdir(parents=True)
        p = self.patch_size
        for key in KEYS:
            batch = np.empty((len(cropped), p, p, CHANNELS[key]), np.float32)
            for i, c in enumerate(cropped):
                batch[i] = c[key]
            np.save(shard_dir / f"{key}.npy", batch)
        return len(cropped)

    def _build_patch_stores(self) -> None:
        if len(self.paths) < 2:
            raise RuntimeError(
                f"need at least 2 EXR pairs under {self.data_path}, "
                f"found {len(self.paths)}",
            )
        work_dir = self.save_path / ".build"
        shutil.rmtree(work_dir, ignore_errors=True)
        work_dir.mkdir(parents=True)
        # shards[split] lists the split's shard directories in write order
        shards: dict[str, list[Path]] = {split: [] for split in SPLITS}

        # the first two pairs seed the two stores, from one Random(seed)
        rng = random.Random(self.seed)
        for i, split in enumerate(SPLITS):
            shard = work_dir / f"seed_{split}"
            self._write_shard(shard, self.paths[i], rng)
            shards[split].append(shard)

        # the remaining pairs split train/val; worker k statically owns
        # items k::n_workers so the pair→RNG-stream assignment is
        # deterministic
        n_rest = len(self.paths) - 2
        n_train = int(self.train_val_ratio[0] * n_rest)
        work_items = [
            ("train" if j < n_train else "val", pair)
            for j, pair in enumerate(self.paths[2:])
        ]
        for j, (split, _) in enumerate(work_items):
            shards[split].append(work_dir / f"item_{j:06d}")
        n_workers = min(self.num_workers, max(1, n_rest))

        lock = threading.Lock()
        done = {"count": 0}
        errors: list[Exception] = []

        def worker(worker_id: int) -> None:
            wrng = (
                random.Random(self.seed + worker_id)
                if self.deterministic
                else random.Random()
            )
            try:
                for j in range(worker_id, n_rest, n_workers):
                    self._write_shard(work_dir / f"item_{j:06d}", work_items[j][1], wrng)
                    with lock:
                        done["count"] += 1
                        logger.info(f"Generating patches: {done['count']} / {n_rest}")
            except Exception as e:  # surfaced to the caller after join
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(
                f"{len(errors)} patch worker(s) failed; dataset is incomplete",
            ) from errors[0]

        for split in SPLITS:
            self._merge(shards[split], self.save_path / split)
        shutil.rmtree(work_dir)
        logger.info("Generating patches: done")

    def _merge(self, shard_dirs: list[Path], dest: Path) -> None:
        """Copy the shards, in order, into one memmapped array per key,
        then rename the finished split into place."""
        tmp = dest.with_name(dest.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        p = self.patch_size
        for key in KEYS:
            parts = [np.load(d / f"{key}.npy", mmap_mode="r") for d in shard_dirs]
            n = sum(len(a) for a in parts)
            out = np.lib.format.open_memmap(
                tmp / f"{key}.npy", mode="w+", dtype=np.float32,
                shape=(n, p, p, CHANNELS[key]),
            )
            row = 0
            for a in parts:
                out[row : row + len(a)] = a
                row += len(a)
            out.flush()
            del out, parts
        shutil.rmtree(dest, ignore_errors=True)
        os.replace(tmp, dest)

"""Patch dataset and the two loaders that feed the train step.

Port of `pixel_heal_thyself_tpu/data/dataset.py` (behavioural spec:
reference `pht/models/afgsa/dataset.py:12-46`, `prefetch_dataloader.py:7-12`
and `base_trainer.py:264-321`: shuffled, seeded, background-prefetched
loading of {noisy, gt, aux} HWC float patches):

- `PatchDataset` reads one split of the `.npy` store (`data/store.py`),
  from RAM when it fits `PHT_DATASET_CACHE_LIMIT_BYTES` (default 16 GiB,
  `0` disables), else through memory maps.
- `PrefetchLoader` gathers batches on reader threads (batch b on thread
  b % workers, consumed round-robin, so any number of threads keeps the
  epoch order), as pinned host tensors when the device is a card, and
  copies each to the device with `non_blocking=True`.
- `DeviceLoader` keeps the whole store on the device as float32 tensors
  and gathers each batch there with one `index_select` per key. It is for
  one process: under data parallelism each rank reads its `host_bounds`
  rows of every global batch through `PrefetchLoader`, from the one epoch
  order that every rank draws alike.

Both loaders draw the epoch order from `default_rng(seed + epoch)`, the
epoch counting from 0 in each process, as the JAX loaders do: for one seed
the port's epochs and batch bytes equal the JAX package's.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch.logger import logger
from pixel_heal_thyself_tpu_torch.parallel.distributed import process_count, put_global


class PatchDataset:
    """Random-access view over one split of a {noisy, gt, aux} store."""

    KEYS = ("noisy", "gt", "aux")

    def __init__(self, split_dir: str | Path, cache_in_ram: bool | None = None) -> None:
        self.split_dir = Path(split_dir)
        paths = {k: self.split_dir / f"{k}.npy" for k in self.KEYS}
        self._arrays = {k: np.load(p, mmap_mode="r") for k, p in paths.items()}
        self._len = len(self._arrays["aux"])
        self._nbytes = sum(int(m.nbytes) for m in self._arrays.values())
        logger.info(f"Data set {self.split_dir} has {self._len} samples in total")
        if cache_in_ram is None:
            limit = int(os.environ.get("PHT_DATASET_CACHE_LIMIT_BYTES", str(16 * 1024**3)))
            cache_in_ram = 0 < self._nbytes <= limit
        self.cached = bool(cache_in_ram)
        if self.cached:
            t0 = time.monotonic()
            self._arrays = {k: np.load(p) for k, p in paths.items()}
            logger.info(f"Cached {self._nbytes / 1e9:.2f} GB patch store in RAM "
                        f"({time.monotonic() - t0:.1f}s)")

    def __len__(self) -> int:
        return self._len

    @property
    def nbytes(self) -> int:
        """Total store size in bytes (float32)."""
        return self._nbytes

    def arrays(self) -> dict[str, np.ndarray]:
        """The whole split as float32 arrays in RAM (the cache itself when
        the split is cached, else one sequential read)."""
        if self.cached:
            return self._arrays
        return {k: np.array(a) for k, a in self._arrays.items()}

    def batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        """The samples at `indices`, in that order."""
        return {k: np.ascontiguousarray(self._arrays[k][indices]) for k in self.KEYS}


class PrefetchLoader:
    """Shuffled (seeded) epoch iterator with background host prefetch."""

    def __init__(
        self,
        dataset: PatchDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int | None = None,
        drop_last: bool = False,
        prefetch: int = 2,
        device: torch.device | str = "cuda",
        workers: int = 1,
        host_bounds: tuple[int, int] | None = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.device = torch.device(device)
        self.workers = max(1, workers)
        # data parallelism: the [lo, hi) rows of each global batch this
        # rank reads and feeds (`parallel.distributed.host_batch_bounds`)
        self.host_bounds = host_bounds
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        if self.seed is None:
            return np.random.default_rng().permutation(n)
        return np.random.default_rng(self.seed + self._epoch).permutation(n)

    def _batch_indices(self, indices: np.ndarray, b: int) -> np.ndarray:
        idx = indices[b * self.batch_size : (b + 1) * self.batch_size]
        if self.host_bounds is not None:
            idx = idx[self.host_bounds[0] : self.host_bounds[1]]
        return idx

    def _host(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """A host batch as tensors, pinned when they go to a card."""
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        self._epoch += 1
        nb = len(self)
        stop = threading.Event()
        # one bounded queue per worker; batch b is produced by worker
        # b % workers and consumed round-robin, preserving epoch order
        depth = max(1, -(-self.prefetch // self.workers))
        queues = [queue.Queue(maxsize=depth) for _ in range(self.workers)]

        def producer(w: int) -> None:
            try:
                for b in range(w, nb, self.workers):
                    if stop.is_set():
                        return
                    queues[w].put(self._host(self.dataset.batch(self._batch_indices(indices, b))))
                queues[w].put(None)
            except Exception as e:  # surfaced to the consumer
                queues[w].put(e)

        threads = [threading.Thread(target=producer, args=(w,), daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        try:
            for b in range(nb):
                item = queues[b % self.workers].get()
                if isinstance(item, Exception):
                    raise item
                yield put_global(item, self.device)
        finally:
            stop.set()
            for qd in queues:  # unblock any producer waiting on a full queue
                while not qd.empty():
                    qd.get_nowait()


class DeviceLoader(PrefetchLoader):
    """Epoch iterator over a patch store resident on the device.

    The store is copied to `device` once as float32 tensors; each step
    sends only the batch's int64 indices and gathers the batch with one
    `index_select` per key. Epoch order and batch bytes equal
    `PrefetchLoader`'s for the same seed."""

    def __init__(
        self,
        dataset: PatchDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int | None = None,
        drop_last: bool = False,
        device: torch.device | str = "cuda",
    ) -> None:
        super().__init__(dataset, batch_size, shuffle=shuffle, seed=seed,
                         drop_last=drop_last, device=device)
        if process_count() > 1:
            raise ValueError("DeviceLoader is for one process; ranks of a process group read "
                             "disjoint host_bounds rows and need PrefetchLoader")
        t0 = time.monotonic()
        self._store = {k: torch.from_numpy(v).to(self.device)
                       for k, v in dataset.arrays().items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info(f"Cached {dataset.nbytes / 1e9:.2f} GB patch store on device "
                    f"({time.monotonic() - t0:.1f}s)")

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        self._epoch += 1
        for b in range(len(self)):
            idx = torch.from_numpy(self._batch_indices(indices, b).astype(np.int64))
            idx = idx.to(self.device, non_blocking=True)
            yield {k: v.index_select(0, idx) for k, v in self._store.items()}

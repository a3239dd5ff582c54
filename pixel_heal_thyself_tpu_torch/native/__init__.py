"""ctypes binding of the native host sampler (`native/pht_native.cpp`).

The port's own binding of the repository's C++ importance sampler (the
JAX package binds the same source in `pixel_heal_thyself_tpu/native`).
On first use the source is compiled with g++ into
`build/native/libpht_native_<hash>.so` beside the package, named by a
hash of the source and flags, written under a temporary name and renamed,
so processes that build it at once never load a half-written one. Nothing is
written into `native/`.

The sampler works on the exact CPython `random.Random` Mersenne state
(getstate/setstate round trip), so the native and pure-Python paths give
byte-identical patch sets and leave the RNG at the same position. Without
g++ every function returns None and the callers take the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from random import Random

import numpy as np

from pixel_heal_thyself_tpu_torch.logger import logger

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "pht_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_load_failed = False


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpht_native_{digest}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, or None when it cannot be built."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning(f"native sampler unavailable ({e}); using the Python path")
            _load_failed = True
            return None
        lib.importance_sample.restype = ctypes.c_int64
        lib.importance_sample.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_random_doubles.restype = None
        lib.mt_random_doubles.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.mt_randints.restype = None
        lib.mt_randints.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def _rng_state(rng: Random) -> tuple[np.ndarray, ctypes.c_int32]:
    state = rng.getstate()[1]
    mt = np.array(state[:624], dtype=np.uint32)
    return mt, ctypes.c_int32(state[624])


def _restore_rng(rng: Random, mt: np.ndarray, pos: ctypes.c_int32) -> None:
    rng.setstate((3, tuple(int(x) for x in mt) + (int(pos.value),), None))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def native_importance_sample(
    img_shape: tuple[int, int],
    patch_size: int,
    num_patches: int,
    rng: Random,
    importance_map: np.ndarray,
    max_iter: int = 5000,
) -> np.ndarray | None:
    """C++ dart throwing + pruning: the padded (x, y) pairs that
    `preprocessing.importance_sampling` returns, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    mt, pos = _rng_state(rng)
    imp = np.ascontiguousarray(importance_map, np.float32)
    out = np.empty(2 * num_patches, np.int64)
    count = lib.importance_sample(
        img_shape[0], img_shape[1], patch_size, num_patches, max_iter,
        _u32(mt), ctypes.byref(pos),
        imp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    _restore_rng(rng, mt, pos)
    return out[: 2 * count].reshape(-1, 2)


def mt_random_doubles(rng: Random, n: int) -> np.ndarray | None:
    """`n` draws of `rng.random()`, advancing `rng` as Python would."""
    lib = get_lib()
    if lib is None:
        return None
    mt, pos = _rng_state(rng)
    out = np.empty(n, np.float64)
    lib.mt_random_doubles(_u32(mt), ctypes.byref(pos), n,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    _restore_rng(rng, mt, pos)
    return out


def mt_randints(rng: Random, a: int, b: int, n: int) -> np.ndarray | None:
    """`n` draws of `rng.randint(a, b)`, advancing `rng` as Python would."""
    lib = get_lib()
    if lib is None:
        return None
    mt, pos = _rng_state(rng)
    out = np.empty(n, np.int64)
    lib.mt_randints(_u32(mt), ctypes.byref(pos), a, b, n,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    _restore_rng(rng, mt, pos)
    return out

"""Build and load the port's CUDA kernels.

On first use, `csrc/*.cu` is compiled by `nvcc` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/kernels/libpht_kernels_<hash>.so csrc/*.cu

The library lands in `build/kernels/` beside the package, named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads as it is. It is loaded with `ctypes`: every pointer and the
stream pass as `c_void_p`, every C entry returns `cudaGetLastError()` of
its launch, and `check` raises on a non-zero code.

A missing `nvcc` or a failed build raises: on a machine with CUDA there is
no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name → argument types (all return int = cudaError_t)
_SIGNATURES = {
    # q, k, v, rel_h, rel_w, residual, out, B, H, W, C, bs, halo, heads,
    # is_bf16, scale, stream
    "pht_attention_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
    # a1, w1, k1, a2, w2, k2, bias, relu, out, M, N, stream
    "pht_pointwise_gemm": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _P],
    # x, w, bias, relu, residual, out, B, H, W, C, N, pad_mode, stream
    "pht_conv3x3": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "pixel_heal_thyself_tpu_torch cannot be built",
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpht_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/*.cu` into the hashed library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}",
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.pht_error_string.argtypes = [ctypes.c_int]
            handle.pht_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = lib().pht_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")

"""Build and load the port's CUDA kernels.

On first use, `csrc/*.cu` is compiled by `nvcc` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Each source compiles in its own `nvcc` process, all started together,
then one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
        -Xcompiler -fPIC -c csrc/<name>.cu -o <tmp>/<name>.o     # each, at once
    nvcc -shared -o build/kernels/libpht_kernels_<hash>.so <tmp>/*.o

The library lands in `build/kernels/` beside the package, named by a hash
of the sources (`*.cu`, `*.cuh`) and flags, so an edited source rebuilds
and an unchanged one loads as it is. It is loaded with `ctypes`: every
pointer and the stream pass as `c_void_p`, every C entry returns
`cudaGetLastError()` of its launch, and `check` raises on a non-zero code.

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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name → argument types (all return int = cudaError_t)
_SIGNATURES = {
    # q, k, v, rel_h, rel_w, residual, out, B, H, W, C, bs, halo, heads,
    # is_bf16, scale, stream
    "pht_attention_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
    # q, k, v, rel_h, rel_w, do, dq, dk, dv, dk_part, dv_part, bias_part,
    # bias_group, B, H, W, C, bs, halo, heads, is_bf16, scale, stream
    "pht_attention_bwd": [_P] * 12 + [_I] * 9 + [_F, _P],
    # a1, w1, k1, a2, w2, k2, bias, relu, pre_residual, out, M, N, stream
    "pht_pointwise_gemm": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P],
    # x, w, bias, relu, residual, out, out2, B, H, W, C, N, pad_mode, stream
    "pht_conv3x3": [_P, _P, _P, _I, _P, _P, _P] + [_I] * 6 + [_P],
    # dy, gate, wt, pre_residual, out, B, H, W, N, C, pad_mode, stream
    "pht_conv3x3_dgrad": [_P] * 5 + [_I] * 6 + [_P],
    # a1, C1, a2, C2, dy, gate, part, out, B, H, W, N, taps, pad_mode,
    # colsum, splits, stream
    "pht_weight_grad": [_P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 8 + [_P],
    # part, out, len, splits, stream
    "pht_sum_splits": [_P, _P, ctypes.c_longlong, _I, _P],
    # zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, xbc, dt, cum, states,
    # y, out, B, L, d_inner, d_state, heads, d_conv, chunk, is_bf16, stream
    "pht_ssd_chain_fwd": [_P] * 13 + [_I] * 8 + [_P],
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
    for src in sorted(CSRC.glob("*.cu*")):
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        results = [(c, p, *p.communicate()) for c, p in zip(cmds, procs)]
        link = [nvcc, "-shared", "-o", str(Path(tmp) / "lib.so"), *map(str, objs)]
        for cmd, proc, stdout, stderr in results:
            if proc.returncode != 0:
                _raise_failed(cmd, proc.returncode, stdout, stderr)
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            _raise_failed(link, proc.returncode, proc.stdout, proc.stderr)
        # atomic: a concurrent loader never sees half a file
        os.replace(Path(tmp) / "lib.so", out)
    return out


def _raise_failed(cmd: list[str], code: int, stdout: str, stderr: str):
    raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")


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


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if grad mode is on and an input requires grad.

    A kernel launched through ctypes returns a tensor with no `grad_fn`, so
    a call in grad mode would silently cut the graph. The kernel wrappers
    and their dispatchers call this first; gradients go through
    `BlockHaloAttentionFn` / `TransformerBlockFn`, whose `forward` runs with
    grad mode off."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is not differentiable: an input requires grad in grad mode. "
            "Call it through ops.attention.BlockHaloAttentionFn or "
            "ops.block_cuda.TransformerBlockFn, or under torch.no_grad()",
        )


def dispatch(name: str, x: torch.Tensor, cuda_fn, torch_fn, *args, **kw):
    """Run a kernel's wrapper for a CUDA `x` (it launches or raises) and its
    plain version for a CPU `x`; refuse grad-mode inputs that require grad
    either way."""
    refuse_autograd(name, *[t for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)])
    if x.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if x.device.type == "cpu":
        return torch_fn(*args, **kw)
    raise ValueError(f"{name}: unsupported device {x.device}")

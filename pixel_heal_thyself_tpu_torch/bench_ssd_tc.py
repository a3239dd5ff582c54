"""What holds the tensor-core bodies of K7 and K8 back, timed on the card at
the prod shape (8 × 16,384 tokens, d_inner 1024, d_state 64, bf16):

    python -m pixel_heal_thyself_tpu_torch.bench_ssd_tc

Builds `csrc/ssd_fwd.cu` and `ssd_bwd.cu` (with `attention_fwd.cu` for the
error strings) once per variant, each with its own `PHT_TF32X3_DIAG`
setting of `csrc/tf32x3.cuh`, into `build/ssd_tc_bench/`, and times every
launch of K7 and of K8 (`profile_serving.per_launch`, through the wrappers
of `ops/ssd_mega_cuda.py` with the variant's library in place of the
port's), in turns: the variants in order, then in reverse. Variants:

- `default`: the shipped split and 3×TF32 product;
- `cvt_split`: the split rounded by two `cvt.rna.tf32.f32` per element
  (the same numbers, another instruction);
- `one_pass`: one tf32 mma.sync per product (a_hi·b_hi): what two of the
  three passes cost;
- `no_mma`: no mma.sync, the fragment loads and splits kept: what the
  tensor cores cost at all.

Only `default` and `cvt_split` compute the right numbers; the others are
timings. Prints the card's name and power limit, then one line per
variant, kernel and launch.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
    fused_mamba_chain_bwd_cuda,
    fused_mamba_chain_cuda,
    fused_mamba_chain_emit_cuda,
)
from pixel_heal_thyself_tpu_torch.profile_serving import mamba_layer_inputs, per_launch

VARIANTS = {"default": 0, "cvt_split": 1, "one_pass": 2, "no_mma": 3}
SOURCES = ("ssd_fwd.cu", "ssd_bwd.cu", "attention_fwd.cu")
ENTRIES = ("pht_ssd_chain_body", "pht_ssd_chain_fwd", "pht_ssd_chain_bwd")
OUT = _build.BUILD_DIR.parent / "ssd_tc_bench"


def build(name: str, diag: int) -> ctypes.CDLL:
    """The variant's library: one nvcc per source, all at once, then a link."""
    OUT.mkdir(parents=True, exist_ok=True)
    objs = [OUT / f"{name}_{Path(src).stem}.o" for src in SOURCES]
    cmds = [[_build._nvcc(), *_build.NVCC_FLAGS, f"-DPHT_TF32X3_DIAG={diag}", "-c",
             str(_build.CSRC / src), "-o", str(obj)] for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{' '.join(cmd)}\n{err}")
    lib = OUT / f"{name}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib), *map(str, objs)], check=True)
    handle = ctypes.CDLL(str(lib))
    for entry in ENTRIES:
        fn = getattr(handle, entry)
        fn.argtypes, fn.restype = _build._SIGNATURES[entry], ctypes.c_int
    handle.pht_error_string.argtypes = [ctypes.c_int]
    handle.pht_error_string.restype = ctypes.c_char_p
    return handle


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssd_tc needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    zx, params, dims = mamba_layer_inputs(dev)
    dy = torch.randn(zx.shape[0], zx.shape[1], dims["d_inner"], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1)).bfloat16()
    for order in (list(VARIANTS), list(reversed(VARIANTS))):
        for name in order:
            _build._lib = libs[name]  # the wrappers launch through this variant's library
            _, states = fused_mamba_chain_emit_cuda(zx, *params, **dims)
            runs = {"K7": lambda: fused_mamba_chain_cuda(zx, *params, **dims),
                    "K8": lambda: fused_mamba_chain_bwd_cuda(zx, *params, states, dy, **dims)}
            for kernel, run in runs.items():
                rows = per_launch(run)
                print(f"[ssd_tc] {name:9s} {kernel} total {sum(rows.values()):.4f} ms: "
                      + ", ".join(f"{label} {ms:.4f}" for label, ms in rows.items()), flush=True)
    _build._lib = None
    print(smi)


if __name__ == "__main__":
    main()

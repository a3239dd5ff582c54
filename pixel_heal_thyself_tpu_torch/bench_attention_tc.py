"""What holds the tensor-core bodies of K1 and K4 back, timed on the card at
the prod shape (8 × 128² × 256, 4 heads, block 8, halo 3):

    python -m pixel_heal_thyself_tpu_torch.bench_attention_tc

Builds `csrc/attention_fwd.cu` and `attention_bwd.cu` (with `block_bwd.cu`
for K4's split sum) once per variant, each with its own `PHT_ATTN_DIAG` /
`PHT_ATTN_FWD_CTAS` setting of `csrc/attention_tc.cuh`, into
`build/attention_tc_bench/`, and times K1 and K4 in bf16 through the
wrappers of `ops/attention_cuda.py` with the variant's library in place of
the port's (CUDA events; K4 also per launch with
`profile_serving.per_launch`), in turns: the variants in order, then in
reverse. Variants:

- `default`: the shipped body;
- `passes`: every key-tile count on the pass plan (K1 two passes, K4
  three, the logits recomputed), as halos ≥ 5 take it: what keeping the
  logits / probabilities in registers buys at halo 3;
- `swap_k`: each kernel stages k_eff the other way (K1 through registers,
  the bias added before the shared store; K4 by cp.async and an in-place
  pass);
- `k1_2ctas`: K1's registers budgeted for two CTAs an SM (255 at halo
  3) instead of three (168; its shared memory admits three);
- `no_null_test`: K4's staging loop without its (never true) null test
  of the v destination, which changes how nvcc schedules the kernel;
- `no_mma`: no mma.sync, the fragment loads and the softmax kept: what
  the tensor cores cost at all.

Only `no_mma` computes wrong numbers; it is a timing. Prints the card's
name and power limit, then one line per variant and kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.measure import cuda_ms
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
    block_halo_attention_bwd_cuda,
    block_halo_attention_cuda,
)
from pixel_heal_thyself_tpu_torch.profile_serving import per_launch

VARIANTS = {"default": [], "passes": ["-DPHT_ATTN_DIAG=1"], "swap_k": ["-DPHT_ATTN_DIAG=3"],
            "k1_2ctas": ["-DPHT_ATTN_FWD_CTAS=2"], "no_null_test": ["-DPHT_ATTN_DIAG=4"],
            "no_mma": ["-DPHT_ATTN_DIAG=2"]}
SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "block_bwd.cu")
ENTRIES = ("pht_attention_fwd", "pht_attention_bwd", "pht_attention_fwd_tc",
           "pht_attention_bwd_tc", "pht_sum_splits")
OUT = _build.BUILD_DIR.parent / "attention_tc_bench"
SHAPE, BS, HALO, HEADS = (8, 128, 128, 256), 8, 3, 4
K4_LAUNCHES = [("attention_bwd_tc", "main"), ("attention_bwd_gather", "gather"),
               ("attention_bias_reduce", "bias reduce")]


def _prod_kernel_lines(ptxas: str) -> list:
    """ptxas's register and spill lines of the tensor-core kernels for 13
    key tiles (halo 3) and for the pass plan."""
    out, name = [], None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = next((f"{k}<{nt}>" for k in ("attention_fwd_tc_kernel",
                                                  "attention_bwd_tc_kernel")
                         for nt in ("13", "0") if f"{k}ILi{nt}E" in line), None)
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def build(name: str, flags: list) -> ctypes.CDLL:
    """The variant's library: one nvcc per source, all at once, then a link."""
    OUT.mkdir(parents=True, exist_ok=True)
    objs = [OUT / f"{name}_{Path(src).stem}.o" for src in SOURCES]
    cmds = [[_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-c",
             str(_build.CSRC / src), "-o", str(obj)] for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{' '.join(cmd)}\n{err}")
        # registers and spills of the tensor-core kernels at the prod tile count
        for line in _prod_kernel_lines(err):
            print(f"[ptxas] {name:8s} {line}", flush=True)
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
        raise SystemExit("bench_attention_tc needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    g = torch.Generator(device=dev).manual_seed(1234)
    hd = SHAPE[-1] // HEADS
    q, k, v, do = (torch.randn(SHAPE, generator=g, device=dev).bfloat16() for _ in range(4))
    rels = [torch.randn(BS + 2 * HALO, hd // 2, generator=g, device=dev) for _ in range(2)]
    att = dict(block_size=BS, halo_size=HALO, num_heads=HEADS)
    run_fwd = lambda: block_halo_attention_cuda(q, k, v, *rels, **att)  # noqa: E731
    run_bwd = lambda: block_halo_attention_bwd_cuda(q, k, v, *rels, do, **att)  # noqa: E731
    for order in (list(VARIANTS), list(reversed(VARIANTS))):
        for name in order:
            _build._lib = libs[name]  # the wrappers launch through this variant's library
            fwd, bwd = cuda_ms(run_fwd, 20), cuda_ms(run_bwd, 10)
            rows = per_launch(run_bwd, groups=K4_LAUNCHES)
            print(f"[attention_tc] {name:8s} K1 {fwd:.4f} ms, K4 {bwd:.4f} ms ("
                  + ", ".join(f"{label} {ms:.4f}" for label, ms in rows.items()) + ")",
                  flush=True)
    _build._lib = None
    print(smi)


if __name__ == "__main__":
    main()

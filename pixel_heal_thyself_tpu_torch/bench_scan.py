"""The chunked SSD scan K11, the fused conv1d + SiLU forward K9 and
backward K10, and K7's prologue, timed launch by launch on the card at the
prod shapes:

    python -m pixel_heal_thyself_tpu_torch.bench_scan

K11 at x [8, 16,384, 16, 64], d_state 64, chunk 128 (the `ssd_pallas`
section of `bench_mamba`); K9 and K10 at zxbcdt [8, 16,384, 2192] with the
window [1024, 2176) and d_conv 4 (one prod Mamba2 layer on the literal
route; K9 also at 64, 128 and 256 rows a CTA); K7's prologue on both its
bodies at the prod Mamba2 layer (the same zxbcdt, chunk 128). In bf16 and
fp32, through the port's wrappers: the device time per call of each launch
(`profile_serving.per_launch`) and the CUDA-event time per call, with the
body each launch took. Prints the card's name and power limit first and
last.

    python -m pixel_heal_thyself_tpu_torch.bench_scan --variants

builds `csrc/ssd_scan.cu`, `conv_silu.cu` and `ssd_fwd.cu` (with
`attention_fwd.cu` for the error strings) once per variant (or those
named after the flag, with `default`) into `build/scan_bench/`, prints the
CTAs an SM holds of K11's tensor-core kernels, and times the bf16
tensor-core body of K11, the vec bodies of K9 and K10 (bf16 and fp32) and
the prologue's vec body (bf16) through each, in turns (the variants in
order, then in reverse), with K11's deviation from its plain version:

- `default`: the shipped kernels;
- `scan_rn`: K11's chunk output with each k-step summed from zero and
  added with f32 adds (`PHT_SCAN_RN`), as its chunk sums are, not chained
  in the tensor cores' sums;
- `scan_no_exp`, `scan_no_mma` (wrong results): K11's chunk output with its
  decays formed without their exps, K11's tensor-core kernels without
  their mma.sync (`PHT_SCAN_DIAG` 1, 2);
- `conv_ch2`: K10's vec body at 2 channels a thread, not 4 (`PHT_CONV_VEC_CH`);
- `ring4`, `ring16`, `ring32`: the copy rings of K9's and the prologue's
  vec bodies 4, 16 or 32 rows deep, not 8 (`PHT_CONV_FWD_RING`,
  `PHT_PROLOGUE_RING`);
- `pro_dt_serial`: the prologue's dt/cum CTA walking each head's rows with
  one thread, as the general body does (`PHT_PROLOGUE_DT_SERIAL`).
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.measure import cuda_ms
from pixel_heal_thyself_tpu_torch.ops import conv_cuda
from pixel_heal_thyself_tpu_torch.ops.conv_cuda import (
    fused_causal_conv1d_silu_bwd_cuda,
    fused_causal_conv1d_silu_cuda,
)
from pixel_heal_thyself_tpu_torch.ops.ssd_cuda import ssd_pallas_cuda
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import ssd_prologue_cuda
from pixel_heal_thyself_tpu_torch.profile_serving import GROUPS, per_launch

# (b, l, heads, headdim, d_state, chunk) of K11; (b, l, columns, offset,
# width, d_conv) of K10
SCAN = (8, 16384, 16, 64, 64, 128)
CONV = (8, 16384, 2192, 1024, 1152, 4)
# name → nvcc flags
VARIANTS = {"default": [], "scan_rn": ["-DPHT_SCAN_RN=1"], "scan_no_exp": ["-DPHT_SCAN_DIAG=1"],
            "scan_no_mma": ["-DPHT_SCAN_DIAG=2"], "conv_ch2": ["-DPHT_CONV_VEC_CH=2"],
            "ring4": ["-DPHT_CONV_FWD_RING=4", "-DPHT_PROLOGUE_RING=4"],
            "ring16": ["-DPHT_CONV_FWD_RING=16", "-DPHT_PROLOGUE_RING=16"],
            "ring32": ["-DPHT_CONV_FWD_RING=32", "-DPHT_PROLOGUE_RING=32"],
            "pro_dt_serial": ["-DPHT_PROLOGUE_DT_SERIAL=1"]}
SOURCES = ("ssd_scan.cu", "conv_silu.cu", "ssd_fwd.cu", "attention_fwd.cu")
ENTRIES = ("pht_ssd_scan_fwd", "pht_conv_silu_fwd", "pht_conv_silu_bwd", "pht_ssd_prologue",
           "pht_ssd_scan_tc_occupancy")
# the prod Mamba2 layer of K7's prologue: d_inner, d_state, headdim, chunk
PROLOGUE = dict(d_inner=1024, d_state=64, headdim=64, chunk=128)
OUT = _build.BUILD_DIR.parent / "scan_bench"


def scan_inputs(device, b: int, l: int, h: int, p: int, n: int, seed: int = 2468) -> tuple:
    """Seeded Mamba-like inputs of the scan (as `chip_smoke.ssd_scan_inputs`):
    x, B, C ~ N(0, 1) and dt log-uniform on [0.001, 0.1] in bf16, A in -[1,
    16] and D in f32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    x = torch.randn(b, l, h, p, generator=g, device=device).bfloat16()
    dt = torch.exp(rand(b, l, h) * math.log(100.0) + math.log(0.001)).bfloat16()
    B = torch.randn(b, l, 1, n, generator=g, device=device).bfloat16()
    C = torch.randn(b, l, 1, n, generator=g, device=device).bfloat16()
    return x, dt, -(1 + 15 * rand(h)), B, C, torch.randn(h, generator=g, device=device)


def conv_inputs(device, b: int, l: int, ctot: int, width: int, k: int, seed: int = 97) -> tuple:
    """Seeded zxbcdt [b, l, ctot] (N(0, 0.25)), taps, bias and dy in f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(b, l, ctot, generator=g, device=device) * 0.5,
            torch.randn(k, width, generator=g, device=device) * 0.2,
            torch.randn(width, generator=g, device=device) * 0.1,
            torch.randn(b, l, width, generator=g, device=device))


def prologue_inputs(device, b: int, l: int, seed: int = 4321) -> tuple:
    """Seeded bf16 zxbcdt [b, l, 2192] and f32 conv_w, conv_b, dt_bias, A of
    the prod Mamba2 layer (as `chip_smoke.mamba_inputs`)."""
    di, n = PROLOGUE["d_inner"], PROLOGUE["d_state"]
    h, dc = di // PROLOGUE["headdim"], di + 2 * n
    g = torch.Generator(device=device).manual_seed(seed)
    return ((torch.randn(b, l, di + dc + h, generator=g, device=device) * 0.5).bfloat16(),
            torch.randn(4, dc, generator=g, device=device) * 0.2,
            torch.randn(dc, generator=g, device=device) * 0.1,
            torch.rand(h, generator=g, device=device) * 3 - 4,
            -torch.exp(torch.rand(h, generator=g, device=device) * 1.5))


def build(name: str, flags: list) -> ctypes.CDLL:
    """The variant's library: one nvcc per source, all at once, then a link."""
    OUT.mkdir(parents=True, exist_ok=True)
    objs = [OUT / f"{name}_{Path(src).stem}.o" for src in SOURCES]
    cmds = [[_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-c", str(_build.CSRC / src), "-o",
             str(obj)] for src, obj in zip(SOURCES, objs)]
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


def variants(dev, only=None) -> None:
    """K11's tc body and K10's vec body (bf16, prod shapes) through each
    variant's library (or those named in `only`), in turns."""
    from pixel_heal_thyself_tpu_torch.ops.ssd import ssd_pallas_torch

    if only and "default" not in only:
        only = ["default", *only]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        chosen = {k: v for k, v in VARIANTS.items() if only is None or k in only}
        libs = dict(zip(chosen, pool.map(lambda kv: build(*kv), chosen.items())))
    b, l, h, p, n, q = SCAN
    print(f"[variant] CTAs an SM holds: K11 chunk state "
          f"{libs['default'].pht_ssd_scan_tc_occupancy(0, q, n, p)}, chunk output "
          f"{libs['default'].pht_ssd_scan_tc_occupancy(1, q, n, p)}", flush=True)
    scan = scan_inputs(dev, b, l, h, p, n)
    ref = ssd_pallas_torch(*scan, chunk=q).float()
    scale = ref.abs().max().item()
    cb, cl, ctot, off, width, k = CONV
    zx, w, bias, dy = conv_inputs(dev, cb, cl, ctot, width, k)
    convs = {label: (zx.to(dtype), w, bias, dy.to(dtype), off, width)
             for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))}
    del zx, dy
    pro = prologue_inputs(dev, cb, cl)
    names = only or list(VARIANTS)
    for order in (names, list(reversed(names))):
        for name in order:
            _build._lib = libs[name]  # the wrappers launch through this variant's library
            err = (ssd_pallas_cuda(*scan, chunk=q).float() - ref)
            print(f"[variant] {name:10s} K11 max_rel {err.abs().max().item() / scale:.4e} "
                  f"rms_rel {err.pow(2).mean().sqrt().item() / scale:.4e}", flush=True)
            del err
            timed(f"{name:10s} K11 bf16", lambda: ssd_pallas_cuda(*scan, chunk=q), ssd_pallas_cuda)
            for label, conv in convs.items():
                timed(f"{name:10s} K9 {label}",
                      lambda a=conv: fused_causal_conv1d_silu_cuda(*a[:3], *a[4:]),
                      fused_causal_conv1d_silu_cuda)
                timed(f"{name:10s} K10 {label}",
                      lambda a=conv: fused_causal_conv1d_silu_bwd_cuda(*a),
                      fused_causal_conv1d_silu_bwd_cuda)
            timed(f"{name:10s} K7 prologue bf16 vec",
                  lambda: ssd_prologue_cuda(*pro, **PROLOGUE, body="vec"), ssd_prologue_cuda)
    _build._lib = None


def timed(name: str, fn, wrapper) -> None:
    """One line of per-launch device times, the CUDA-event time and bodies."""
    rows = per_launch(fn, groups=GROUPS)
    ms = cuda_ms(fn, 10)
    bodies = dict(getattr(wrapper, "body_launches", {}))
    print(f"[scan] {name}: {ms:.4f} ms (CUDA events); per launch "
          + ", ".join(f"{label} {t:.4f}" for label, t in rows.items())
          + (f"; bodies so far {bodies}" if bodies else ""), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", nargs="*", choices=list(VARIANTS), default=None,
                        help="time the build variants (all, or those named) in turns instead")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_scan needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if opts.variants is not None:
        variants(dev, opts.variants or None)
        print(smi)
        return
    b, l, h, p, n, q = SCAN
    scan = scan_inputs(dev, b, l, h, p, n)
    cb, cl, ctot, off, width, k = CONV
    zx, w, bias, dy = conv_inputs(dev, cb, cl, ctot, width, k)
    rows_default = conv_cuda.ROWS
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        args = tuple(t.to(dtype) if t.dim() > 1 else t for t in scan)
        timed(f"K11 {label} x {tuple(args[0].shape)}, d_state {n}, chunk {q}",
              lambda a=args: ssd_pallas_cuda(*a, chunk=q), ssd_pallas_cuda)
        conv = (zx.to(dtype), w, bias, dy.to(dtype), off, width)
        window = f"zxbcdt {tuple(zx.shape)}, window [{off}, {off + width}), k {k}"
        for rows in (64, 128, 256):
            conv_cuda.ROWS = rows
            timed(f"K9 {label} {window}, {rows} rows a CTA",
                  lambda a=conv: fused_causal_conv1d_silu_cuda(*a[:3], *a[4:]),
                  fused_causal_conv1d_silu_cuda)
        conv_cuda.ROWS = rows_default
        timed(f"K10 {label} {window}", lambda a=conv: fused_causal_conv1d_silu_bwd_cuda(*a),
              fused_causal_conv1d_silu_bwd_cuda)
        pro = prologue_inputs(dev, cb, cl)
        pro = (pro[0].to(dtype), *pro[1:])
        for body in ("vec", "general"):
            timed(f"K7 prologue {label} {body} body, {window}",
                  lambda p=pro, bd=body: ssd_prologue_cuda(*p, **PROLOGUE, body=bd),
                  ssd_prologue_cuda)
        del args, conv, pro
    print(smi)


if __name__ == "__main__":
    main()

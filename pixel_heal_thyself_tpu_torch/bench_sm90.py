"""What holds the Hopper bodies of K2, K3, K5 and K6 back, timed on the card
at the prod shapes (8 × 128² × 256, bf16):

    python -m pixel_heal_thyself_tpu_torch.bench_sm90 [--gather]

Builds `csrc/conv3x3_sm90.cu`, `pointwise_sm90.cu`, `dgrad_sm90.cu` and
`wgrad_sm90.cu` (with `block_bwd.cu` for the split sums) once per variant,
each with its own `PHT_SM90_DIAG` setting of `csrc/sm90_gemm.cuh`, into
`build/sm90_bench/`, and times every variant's K2 (one operand; two with
the f32 residual), K3, K5 (replicate, with the gate and the residual: its
gate pass and fold pre-pass included; "K5 bare": zero padding, no gate, no
residual, the main passes alone) and K6 (9 taps with the gate and db; 1 tap
with two operands and db) by CUDA events, in turns: the variants in
order, then in reverse. Every operand that can comes by TMA. Variants:

- `default`: the shipped body;
- `no_mma`: the consumers skip their wgmmas: what the copies alone cost;
- `no_copy`: the producers skip their copies: what the wgmmas alone cost;
- `no_epilogue`: the consumers of K2, K3 and K5 skip their epilogue (K6's
  body has no such variant: it runs as `default`).

The diagnostic variants compute garbage; only the default's outputs are
checked (against the library build's). With `--gather`, times instead the
port's library at 8 × 32² × 256 (the ci and dev configs' patches, which
the Hopper bodies gather by cp.async): K3 and the 9-tap K6 through the
Hopper and the general bodies. Prints the card's name and power limit, then
one line per variant (or body) and kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.measure import cuda_ms
from pixel_heal_thyself_tpu_torch.ops.block_cuda import PAD_MODES, dgrad_fold_floats, wgrad_plan

VARIANTS = {
    "default": [],
    "no_mma": ["-DPHT_SM90_DIAG=1"],
    "no_copy": ["-DPHT_SM90_DIAG=2"],
    "no_epilogue": ["-DPHT_SM90_DIAG=3"],
}
SOURCES = ("conv3x3_sm90.cu", "pointwise_sm90.cu", "dgrad_sm90.cu", "wgrad_sm90.cu",
           "block_bwd.cu")
ENTRIES = ("pht_conv3x3_sm90", "pht_pointwise_gemm_sm90", "pht_conv3x3_dgrad_sm90",
           "pht_weight_grad_sm90")
OUT = _build.BUILD_DIR.parent / "sm90_bench"


def build(name: str, flags: list[str]) -> ctypes.CDLL:
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
        getattr(handle, entry).argtypes = _build._SIGNATURES[entry]
    return handle


def gather_vs_general(dev, shape=(8, 32, 32, 256)) -> None:
    """At a frame that 64 does not divide (the ci and dev configs' 32² patches,
    batch 8, width 256) the Hopper bodies gather the image by cp.async: their
    times against the general WMMA bodies' on the same inputs, in turns."""
    lib = _build.lib()
    b, h, w, c = shape
    pixels = b * h * w
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()  # noqa: E731
    x, dy, gate, res = (rand(b, h, w, c) for _ in range(4))
    wt, bias = rand(9 * c, c) * (9 * c) ** -0.5, rand(c) * 0.1
    stream = torch.cuda.current_stream().cuda_stream
    out, g = torch.empty_like(x), torch.empty_like(dy)
    pad = PAD_MODES["replicate"]
    conv = (x.data_ptr(), wt.data_ptr(), bias.data_ptr(), 1, res.data_ptr(), out.data_ptr(),
            None, b, h, w, c, c, pad)
    wave = lib.pht_sm90_wave_ctas()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {body: wgrad_plan(9 * c, c, pixels, wave if body == "sm90" else sms, body)
             for body in ("sm90", "general")}
    part = {k: torch.empty(p.splits, 9 * c * c + c, dtype=torch.float32, device=dev)
            for k, p in plans.items()}
    dw = torch.empty(9 * c * c + c, dtype=torch.float32, device=dev)
    runs = {
        ("K3", "sm90"): lambda: lib.pht_conv3x3_sm90(*conv, stream),
        ("K3", "general"): lambda: lib.pht_conv3x3(*conv, stream),
        ("K6 9 taps", "sm90"): lambda: lib.pht_weight_grad_sm90(
            x.data_ptr(), c, None, 0, dy.data_ptr(), gate.data_ptr(), g.data_ptr(),
            part["sm90"].data_ptr(), dw.data_ptr(), b, h, w, c, 9, pad, 1,
            plans["sm90"].splits, plans["sm90"].pix_per_split, stream),
        ("K6 9 taps", "general"): lambda: lib.pht_weight_grad(
            x.data_ptr(), c, None, 0, dy.data_ptr(), gate.data_ptr(),
            part["general"].data_ptr(), dw.data_ptr(), b, h, w, c, 9, pad, 1,
            plans["general"].splits, stream),
    }
    for run in runs.values():
        _build.check(run(), "gather_vs_general")
    times = {k: [] for k in runs}
    for order in (list(runs), list(reversed(runs))):
        for k in order:
            times[k].append(cuda_ms(runs[k], 20))
    for (kernel, body), ms in times.items():
        print(f"[sm90] {b}x{h}x{w}x{c} {kernel:10s} {body:8s} "
              f"{' '.join(f'{t:.4f}' for t in ms)} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(prog="bench_sm90")
    ap.add_argument("--gather", action="store_true",
                    help="the cp.async gather against the general bodies at 8 × 32² × 256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_sm90 needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.gather:
        gather_vs_general(dev)
        print(smi)
        return
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))

    b, h, w, c = 8, 128, 128, 256
    pixels = b * h * w
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()  # noqa: E731
    x, a, dy, gate, res = (rand(b, h, w, c) for _ in range(5))
    wt, bias = rand(9 * c, c) * (9 * c) ** -0.5, rand(c) * 0.1
    w1, w2 = rand(c, c) * c**-0.5, rand(c, c) * c**-0.5
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(x)
    g = torch.empty_like(dy)
    pad = PAD_MODES["replicate"]
    fold = torch.empty(dgrad_fold_floats(b, h, w, c, "replicate"), dtype=torch.float32,
                       device=dev)

    def k2(lib, operands):
        second = (a.data_ptr(), w2.data_ptr(), c) if operands == 2 else (None, None, 0)
        pre = res.data_ptr() if operands == 2 else None
        return lambda: lib.pht_pointwise_gemm_sm90(
            x.data_ptr(), w1.data_ptr(), c, *second, None, 0, pre, out.data_ptr(), pixels, c,
            stream)

    def k3(lib):
        return lambda: lib.pht_conv3x3_sm90(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(), 1, res.data_ptr(), out.data_ptr(),
            None, b, h, w, c, c, pad, stream)

    def k5(lib, bare=False):
        if bare:  # zeros, no gate, no residual: the main passes alone
            return lambda: lib.pht_conv3x3_dgrad_sm90(
                dy.data_ptr(), None, None, wt.data_ptr(), None, None, out.data_ptr(), b, h, w,
                c, c, PAD_MODES["zeros"], stream)
        return lambda: lib.pht_conv3x3_dgrad_sm90(
            dy.data_ptr(), gate.data_ptr(), g.data_ptr(), wt.data_ptr(), res.data_ptr(),
            fold.data_ptr(), out.data_ptr(), b, h, w, c, c, pad, stream)

    def k6(lib, taps):
        m = 9 * c if taps == 9 else 2 * c
        plan = wgrad_plan(m, c, pixels, lib.pht_sm90_wave_ctas())
        part = torch.empty(plan.splits, m * c + c, dtype=torch.float32, device=dev)
        dw = torch.empty(m * c + c, dtype=torch.float32, device=dev)
        second = None if taps == 9 else a.data_ptr()
        gated = gate.data_ptr() if taps == 9 else None

        def run():
            lib.pht_weight_grad_sm90(x.data_ptr(), c, second, c if taps == 1 else 0,
                                     dy.data_ptr(), gated, g.data_ptr(), part.data_ptr(),
                                     dw.data_ptr(), b, h, w, c, taps, pad, 1, plan.splits,
                                     plan.pix_per_split, stream)
            return dw
        return run

    kernels = {"K2 1 operand": lambda lib: k2(lib, 1), "K2 2 operands": lambda lib: k2(lib, 2),
               "K3": k3, "K5": k5, "K5 bare": lambda lib: k5(lib, True),
               "K6 9 taps": lambda lib: k6(lib, 9),
               "K6 1 tap": lambda lib: k6(lib, 1)}
    # the default build against the library the port loads, to the bit
    for name, make in kernels.items():
        writes_out = not name.startswith("K6")
        make(libs["default"])()
        first = (out if writes_out else make(libs["default"])()).clone()
        make(_build.lib())()
        second = out if writes_out else make(_build.lib())()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name}: the default variant differs from the port's library")

    times = {(v, k): [] for v in VARIANTS for k in kernels}
    for order in (list(VARIANTS), list(reversed(VARIANTS))):
        for v in order:
            for k, make in kernels.items():
                times[(v, k)].append(cuda_ms(make(libs[v]), 20))
    for (v, k), ms in times.items():
        print(f"[sm90] {v:17s} {k:13s} {' '.join(f'{t:.4f}' for t in ms)} ms", flush=True)
    print(smi)


if __name__ == "__main__":
    main()

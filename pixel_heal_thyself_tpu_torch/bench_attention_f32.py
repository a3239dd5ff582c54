"""K1's and K4's float32 body against their general body, the plain versions
and SDPA, on the card at the prod fp32 shape (8 × 128² × 256, 4 heads,
block 8, halo 3):

    python -m pixel_heal_thyself_tpu_torch.bench_attention_f32 [--check | --variants]

First compiles `csrc/attention_fwd.cu` and `attention_bwd.cu` once more
with `-Xptxas -v` (into `build/attention_f32_bench/`, beside the port's own
build) and prints what ptxas reports for the float32 kernels: registers,
spills, shared memory. Then checks both bodies against the plain versions
in float32 (TF32 off): the prod shape, and halos 1–8 at 1 × 64² × 256,
within (1e-5, 1e-6) of the largest magnitude, K4 equal to the bit across
two calls, every wrapper call counted on the f32 body. With `--check` it
stops there. Otherwise it times, in turns (f32, general, general, f32),
each body with CUDA events, and once the plain versions and SDPA over the
windows gathered beforehand (the gather untimed), K4's launches with the
profiler, and prints each kernel's bound (`measure.bound`: its operations
at the f32 rate, against its bytes). Prints the card's name and power
limit first.

`--variants` instead builds K1's and K4's sources once per variant
(`csrc/attention_f32.cuh`'s `PHT_F32_DIAG`: the shipped body; without the
products that contract over the keys; without those that contract over
the channels; without either; the runtime-slot kernel at the prod shape;
and `PHT_F32_FWD_CTAS=2`, K1's registers budgeted for two CTAs an SM) into
`build/attention_f32_bench/`, and times the f32 body's K1 and K4 (main
launch and the whole call) through each, in turns: the variants in order,
then in reverse. The variants without products compute wrong numbers;
they time what is left.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.measure import bound, cuda_ms
from pixel_heal_thyself_tpu_torch.ops.attention import (
    block_halo_attention_bwd_torch,
    block_halo_attention_torch,
    blocks_from_image,
    extract_halo_windows,
    rel_bias,
)
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
    attention_body_launch,
    block_halo_attention_bwd_cuda,
    block_halo_attention_cuda,
)

SHAPE, BS, HALO, HEADS = (8, 128, 128, 256), 8, 3, 4
TOL = (1e-5, 1e-6)
OUT = _build.BUILD_DIR.parent / "attention_f32_bench"
K4_LAUNCHES = [("attention_bwd_f32", "main (f32 body)"), ("attention_bwd_kernel", "main (general)"),
               ("attention_bwd_gather", "dk/dv gather"), ("attention_bias_reduce", "bias reduce"),
               ("sum_splits", "bias group sum"), ("reduce", "drel_h/drel_w sums")]


VARIANTS = {"default": [], "no_key_products": ["-DPHT_F32_DIAG=1"],
            "no_channel_products": ["-DPHT_F32_DIAG=2"], "no_products": ["-DPHT_F32_DIAG=3"],
            "runtime_slots": ["-DPHT_F32_DIAG=4"], "k1_2ctas": ["-DPHT_F32_FWD_CTAS=2"]}
VARIANT_SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "block_bwd.cu")
VARIANT_ENTRIES = ("pht_attention_fwd_f32", "pht_attention_bwd_f32", "pht_sum_splits")


def build_variant(name: str, flags: list) -> ctypes.CDLL:
    """The variant's library: one nvcc per source, all at once, then a link."""
    OUT.mkdir(parents=True, exist_ok=True)
    objs = [OUT / f"{name}_{Path(src).stem}.o" for src in VARIANT_SOURCES]
    cmds = [[_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-c",
             str(_build.CSRC / src), "-o", str(obj)] for src, obj in zip(VARIANT_SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{' '.join(cmd)}\n{err}")
    lib = OUT / f"{name}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib), *map(str, objs)], check=True)
    handle = ctypes.CDLL(str(lib))
    for entry in VARIANT_ENTRIES:
        fn = getattr(handle, entry)
        fn.argtypes, fn.restype = _build._SIGNATURES[entry], ctypes.c_int
    handle.pht_error_string.argtypes = [ctypes.c_int]
    handle.pht_error_string.restype = ctypes.c_char_p
    return handle


def time_variants(q, k, v, do, rel, smi: str) -> None:
    """The f32 body's K1 and K4 through each variant's library, in turns."""
    from pixel_heal_thyself_tpu_torch.profile_serving import per_launch

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build_variant(*kv), VARIANTS.items())))
    att = dict(block_size=BS, halo_size=HALO, num_heads=HEADS)
    for order in (list(VARIANTS), list(reversed(VARIANTS))):
        for name in order:
            _build._lib = libs[name]  # the wrappers launch through this variant's library
            fwd = cuda_ms(lambda: block_halo_attention_cuda(q, k, v, *rel, **att), 10)
            bwd = cuda_ms(lambda: block_halo_attention_bwd_cuda(q, k, v, *rel, do, **att), 5)
            rows = per_launch(lambda: block_halo_attention_bwd_cuda(q, k, v, *rel, do, **att),
                              groups=K4_LAUNCHES)
            print(f"[variant] {name:20s} K1 {fwd:.4f} ms, K4 {bwd:.4f} ms (main "
                  f"{rows.get('main (f32 body)', float('nan')):.4f}); {smi}", flush=True)
    _build._lib = None


def ptxas_report() -> list[subprocess.Popen]:
    """Start nvcc -Xptxas -v on K1's and K4's sources (one process each)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in ("attention_fwd", "attention_bwd"):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               str(_build.CSRC / f"{name}.cu"), "-o", str(OUT / f"{name}.o")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def print_ptxas(procs) -> None:
    """ptxas's lines for the float32 kernels (the function line, then its
    resource lines until the next function)."""
    for proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{text}")
        keep = False
        for line in text.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                keep = "f32_kernel" in line
            if keep:
                print(f"[ptxas] {line.strip()}", flush=True)


def windows(x, keys=False, rel=None):
    """SDPA's operands, [windows, heads, n, head_ch] (k_eff biased when
    `rel` is given), gathered once and never timed."""
    b, h, w, c = x.shape
    hd, window = c // HEADS, BS + 2 * HALO
    if not keys:
        wins = blocks_from_image(x, BS)
    else:
        wins = extract_halo_windows(x, BS, HALO)
        if rel is not None:
            wins = (wins.reshape(*wins.shape[:5], HEADS, hd) + rel_bias(*rel)[:, :, None, :])
        wins = wins.reshape(b, h // BS, w // BS, window * window, c)
    n = wins.shape[3]
    return wins.reshape(-1, n, HEADS, hd).permute(0, 2, 1, 3).contiguous()


def deviation(got, ref) -> float:
    """The worst (max_rel, rms_rel) over the outputs, relative to each
    reference's largest magnitude; raises past TOL."""
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    worst = [0.0, 0.0]
    for g, r in zip(got, ref, strict=True):
        if not torch.isfinite(g).all():
            raise AssertionError("non-finite output")
        err, scale = (g - r).abs(), r.abs().max().item()
        worst = [max(worst[0], err.max().item() / scale),
                 max(worst[1], err.pow(2).mean().sqrt().item() / scale)]
    if worst[0] > TOL[0] or worst[1] > TOL[1]:
        raise AssertionError(f"deviation {worst} past {TOL}")
    return worst


def counted(fn, want: int):
    """fn() with both wrappers' f32 counts checked to rise by `want`."""
    before = (block_halo_attention_cuda.body_launches["f32"],
              block_halo_attention_bwd_cuda.body_launches["f32"])
    out = fn()
    after = (block_halo_attention_cuda.body_launches["f32"],
             block_halo_attention_bwd_cuda.body_launches["f32"])
    if sum(after) - sum(before) != want:
        raise AssertionError(f"f32 launches {before} → {after}, want {want} more")
    return out


def check(shape, halo: int, seed: int) -> tuple:
    """Both bodies against the plain versions at one shape; K4 twice."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do, res = (torch.randn(shape, generator=g, device="cuda") for _ in range(5))
    window, hd = BS + 2 * halo, shape[-1] // HEADS
    rel = [torch.randn((window, hd // 2), generator=g, device="cuda") for _ in range(2)]
    att = dict(block_size=BS, halo_size=halo, num_heads=HEADS)
    ref = block_halo_attention_torch(q, k, v, *rel, **att, residual=res)
    ref_g = block_halo_attention_bwd_torch(q, k, v, *rel, do, **att)
    out = counted(lambda: block_halo_attention_cuda(q, k, v, *rel, **att, residual=res), 1)
    grads = counted(lambda: block_halo_attention_bwd_cuda(q, k, v, *rel, do, **att), 1)
    again = counted(lambda: block_halo_attention_bwd_cuda(q, k, v, *rel, do, **att), 1)
    gen = attention_body_launch("general", q, k, v, *rel, **att, residual=res)
    gen_g = attention_body_launch("general", q, k, v, *rel, do, **att)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again, strict=True)):
        raise AssertionError(f"halo {halo}: two K4 calls differ")
    devs = (deviation(out, ref), deviation(grads, ref_g), deviation(gen, ref),
            deviation(gen_g, ref_g))
    print(f"[check] {tuple(shape)} halo {halo}: K1 f32 max_rel {devs[0][0]:.3e} rms "
          f"{devs[0][1]:.3e}, general {devs[2][0]:.3e}; K4 f32 max_rel {devs[1][0]:.3e} rms "
          f"{devs[1][1]:.3e} (equal to the bit across two calls), general {devs[3][0]:.3e}",
          flush=True)
    return q, k, v, do, rel


def main(argv=None) -> None:
    args = _parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_f32 needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    procs = ptxas_report()
    _build.lib()
    print_ptxas(procs)

    q, k, v, do, rel = check(SHAPE, HALO, 0)
    if args.variants:
        time_variants(q, k, v, do, rel, smi)
        return
    for halo in range(1, 9):
        check((1, 64, 64, SHAPE[-1]), halo, halo)
    if args.check:
        return

    att = dict(block_size=BS, halo_size=HALO, num_heads=HEADS)
    b, h, w, c = SHAPE
    window = BS + 2 * HALO
    flops = 2 * 2 * b * h * w * window**2 * c  # q·k and p·v over every window
    rows = {
        "K1": (lambda body: attention_body_launch(body, q, k, v, *rel, **att),
               (4 * q.numel() * 4 + 2 * 4 * rel[0].numel(), flops), 10),
        "K4": (lambda body: attention_body_launch(body, q, k, v, *rel, do, **att),
               (7 * q.numel() * 4 + 4 * 4 * rel[0].numel(), flops * 5 // 2), 5),
    }
    qw, kw_, vw = windows(q), windows(k, True, rel), windows(v, True)
    dow = windows(do)
    qg, kg, vg = (t.detach().requires_grad_() for t in (qw, kw_, vw))
    og = F.scaled_dot_product_attention(qg, kg, vg)
    library = {"K1": lambda: F.scaled_dot_product_attention(qw, kw_, vw),
               "K4": lambda: torch.autograd.grad(og, (qg, kg, vg), dow, retain_graph=True)}
    plain = {"K1": lambda: block_halo_attention_torch(q, k, v, *rel, **att),
             "K4": lambda: block_halo_attention_bwd_torch(q, k, v, *rel, do, **att)}
    for name, (run, work, iters) in rows.items():
        times = {"f32": [], "general": []}
        for body in ("f32", "general", "general", "f32"):
            times[body].append(cuda_ms(lambda body=body: run(body), iters))
        plain_ms = cuda_ms(plain[name], 2, warmup=1)
        lib_ms = cuda_ms(library[name], iters)
        bd = bound(*work, torch.float32)
        print(f"[time] {name} fp32 at {SHAPE}, halo {HALO}: f32 body "
              f"{' / '.join(f'{t:.4f}' for t in times['f32'])} ms, general body "
              f"{' / '.join(f'{t:.4f}' for t in times['general'])} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); {smi}",
              flush=True)
    from pixel_heal_thyself_tpu_torch.profile_serving import per_launch

    for body in ("f32", "general"):
        launches = per_launch(lambda body=body: rows["K4"][0](body), groups=K4_LAUNCHES)
        print(f"[time] K4 fp32 {body} body per launch: total {sum(launches.values()):.4f} ms; "
              + ", ".join(f"{label} {ms:.4f}" for label, ms in launches.items()), flush=True)


def _parse(argv):
    parser = argparse.ArgumentParser(
        description="K1's and K4's float32 body on the card (module docstring)")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="build, print ptxas's report and check; time nothing")
    mode.add_argument("--variants", action="store_true",
                      help="time the f32 body's PHT_F32_DIAG variants (module docstring)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()

"""What `chip_smoke.py`, `profile_serving` and `bench_sm90` share: bounds,
frames and a CUDA-event timer.

    python -m pixel_heal_thyself_tpu_torch.measure

prints the bound of every TPU kernel of the repo at the prod shapes (needs
only torch, no card). A bound is the least time an H100 SXM could take for
a function: the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its operations over the peak
rate of their type. For each function that reaches `pl.pallas_call` in
`pixel_heal_thyself_tpu/`: AFGSA at 8 windows of 128² × 256 channels, halo
3 (serving and the training step); Mamba at 8 × 16,384 tokens, d_inner
1024, d_state 64, 16 heads of 64, chunk 128, d_conv 4, bf16 (serving, and
the training step on 8 × 128² patches). `chip_smoke.py` computes the
ported kernels' bounds from its own tensors.
"""

from __future__ import annotations

import tempfile

import torch

# the H100 SXM's published peaks (dense): HBM bytes/s, and FLOP/s of bf16
# tensor-core products and of f32 outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16 = 2  # bytes


def bound(moved: int, flops: float, dtype) -> dict:
    """The least time the card could take for a function that moves
    `moved` bytes and does `flops` operations of `dtype`."""
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of `fn()` over `iters` calls on the current CUDA
    stream (CUDA events), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_frames(count: int, size: int) -> list:
    """`count` synthetic size² EXR frame pairs (seed 0) through
    `preprocess_data`, as `inference.run_inference` reads them."""
    from pixel_heal_thyself_tpu_torch.data.preprocessing import preprocess_data
    from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset
    from pixel_heal_thyself_tpu_torch.inference import find_frame_pairs

    with tempfile.TemporaryDirectory() as tmp:
        generate_dataset(tmp, scenes=[f"scene{i}_0" for i in range(count)],
                         height=size, width=size, seed=0)
        return [preprocess_data(n, g) for _, n, g in find_frame_pairs(tmp, 32, 1024)]


def afgsa_work() -> dict:
    """(bytes, FLOP) of the AFGSA TPU kernels at 8 × 128² × 256, halo 3."""
    p, c, win = 8 * 128 * 128, 256, 14 * 14
    img = p * c * BF16                       # one [8, 128, 128, 256] bf16 tensor
    attn = 2 * 2 * p * win * c               # q·k and p·v over every window
    gemm = 2 * p * c * c                     # one 1×1 projection
    conv = 2 * p * 9 * c * c                 # one 3×3 conv (or its dgrad / wgrad)
    rel = 2 * 14 * (c // 4 // 2) * 4         # rel_h, rel_w f32
    w_bytes = (2 + 3 + 18) * c * c * BF16    # wcat, wq/wk/wv, w1, w2
    return {
        "#1 attention_pallas.py:217 _fwd_kernel": (4 * img + rel, attn),
        "#2 attention_pallas.py:383 _bwd_kernel": (7 * img + 2 * rel, attn * 5 // 2),
        # n_aux GEMM (2c → c), q/k/v, attention, two 3×3 convs
        "#3 block_mega.py:413 _block_kernel": (3 * img + w_bytes,
                                               2 * gemm + 3 * gemm + attn + 2 * conv),
        # x, a, x1, f1, f2, dy in; dx, da and f32 weight gradients out.
        # Two 9-tap weight gradients and two dgrads, the attention backward,
        # four recomputed projections, five 1×1 weight gradients and the
        # 1×1 input gradients (2c·c + 2·c·c + c·c)
        "#4 block_mega.py:662 _bwd_kernel": (8 * img + w_bytes + 2 * w_bytes,
                                             4 * conv + attn * 5 // 2 + 5 * gemm + 5 * gemm
                                             + 5 * gemm),
    }


def mamba_chain_flops(b: int, l: int, di: int, n: int, h: int, q: int) -> tuple:
    """FLOP of the fused Mamba2 interior's forward and backward (TPU #5,
    #6) at b × l tokens: (forward, backward)."""
    p, nc = di // h, l // q
    # per (batch, chunk): C·Bᵀ, the intra-chunk products, the state's
    # readout and update
    fwd = b * nc * (2 * q * q * n + 2 * h * q * q * p + 4 * q * n * di)
    # the backward recomputes the chunk (3 of the forward's products) and
    # runs two more per product: dw3 and dxdt; dC, dst, dB, dxdt_s
    bwd = b * nc * (3 * 2 * h * q * q * p + 6 * 2 * q * n * di + 3 * 2 * q * q * n)
    return fwd, bwd


def mamba_work() -> dict:
    """(bytes, FLOP) of the Mamba TPU kernels at 8 × 16,384 tokens, with
    the port's residuals: the emit variant stores the entering states (no
    conv tails: the backward reads the raw rows from zxbcdt)."""
    b, l, di, n, h, q, k = 8, 16384, 1024, 64, 16, 128, 4
    dc, nc = di + 2 * n, l // q
    width = 2 * di + 2 * n + h
    zx, y = b * l * width * BF16, b * l * di * BF16
    fwd, bwd = mamba_chain_flops(b, l, di, n, h, q)
    states = b * nc * n * di * BF16          # the emit variant's per-chunk states
    xbc = b * l * dc * BF16
    ssd_in = b * l * (di + h + 2 * n) * BF16  # x, dt, B, C
    return {
        "#5 ssd_mega.py:256 _fwd_kernel_infer": (zx + y, fwd),
        "#5 ssd_mega.py:252 _fwd_kernel_train (emit)": (zx + y + states, fwd),
        # reads zxbcdt, the states and dy, writes dzx
        "#6 ssd_mega.py:260 _bwd_kernel": (2 * zx + y + states, bwd),
        # the port's launch 1 of #5, #5e and #6 (the `_chunk_core` prologue,
        # :114): reads the xBC window and the dt column, writes f32 xbc, dt
        # and cum
        "#5/#6 ssd_mega.py:114 prologue (K7 launch 1)": (
            b * l * (dc + h) * BF16 + b * l * (dc + 2 * h) * 4, 2 * b * l * dc * k),
        "#7 conv_pallas.py:147 _fwd_kernel": (2 * xbc, 2 * b * l * dc * k),
        "#7 conv_pallas.py:158 _bwd_kernel": (3 * xbc, 4 * b * l * dc * k),
        "#8 ssd.py:324 _ssd_fwd_kernel": (ssd_in + y, fwd),
    }


def main() -> None:
    for name, (moved, flops) in {**afgsa_work(), **mamba_work()}.items():
        res = bound(moved, flops, torch.bfloat16)
        print(f"{name}: {moved / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP → "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")


if __name__ == "__main__":
    main()

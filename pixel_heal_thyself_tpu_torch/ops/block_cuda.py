"""The whole TransformerBlock, forward and backward: CUDA kernels K2/K3/K5/K6
and the block chains.

Port of the TPU kernels `_block_kernel` (`pixel_heal_thyself_tpu/ops/
block_mega.py:413`, launched by `_mega_fwd` :586) and `_bwd_kernel`
(`:662`, launched by `_mega_bwd` :1006). On the TPU each is one Pallas call
per block; here the block is a short chain of hand-written kernels on
unpadded NHWC images. Forward:

    n   = relu(round(x·Wcat[:C] + a·Wcat[C:]) + bcat)     K2 (two operands)
    k   = round(n·Wk);  v = round(x·Wv);  q = round(n·Wq)   K2 ×3
    x1  = x + attention(q, k, v)                            K1, residual fused
    f1  = relu(round(conv3x3(x1)·W1) + b1)                  K3
    f2  = relu(round(conv3x3(f1)·W2) + b2)                  K3 (second output)
    out = x1 + f2                                           K3, residual fused

Backward, in the TPU kernel's order and at its rounding points (`emit`
saves x1, f1 and f2, whose > 0 mask is the TPU `m2`; n/k/v/q are
recomputed with K2, as the TPU kernel does):

    dW2, db2 = Σ shift(f1)ᵀ·(do⊙[f2>0])                    K6, 9 taps
    df1 = round(Σ (do⊙[f2>0])·W2ᵀ) with the pad fold        K5
    dW1, db1 = Σ shift(x1)ᵀ·(df1⊙[f1>0])                   K6, 9 taps
    dx1 = round(do + Σ (df1⊙[f1>0])·W1ᵀ), folded            K5
    dq, dk, dv, drel = attention backward (do = dx1)         K4
    dWq = nᵀ·dq;  dWk = nᵀ·dk;  dWv = xᵀ·dv                 K6, 1 tap
    dn = round(dq·Wqᵀ) + round(dk·Wkᵀ);  dz = dn⊙[n>0]      K2 ×2
    dWcat, dbcat = [x; a]ᵀ·dz, Σ dz                          K6, two operands
    dx = round(dx1 + dv·Wvᵀ + dz·Wcat[:C]ᵀ)                  K2, f32 residual
    da = round(dz·Wcat[C:]ᵀ)                                 K2

in bf16 with f32 accumulation; weight gradients are f32. The W-halo-padded
layout of the TPU kernels existed only for sublane alignment, so the port
drops it (and with it `pad_w_halo`/`unpad_w_halo`).

Weights come in kernel layout, all bf16 except rel_h/rel_w (f32): wcat
[2C, C] ([x; a] input order), wq/wk/wv [C, C] ([in, out]), w1/w2 [9C, C]
(HWIO reshaped, tap-major), biases [C]. `kernel_layout` makes them from
the parameters' own (OIHW, f32) layout.

Each kernel has a dispatcher (`pointwise_gemm`, `conv3x3`,
`conv3x3_dgrad`, `weight_grad`) that launches the kernel for CUDA tensors
and runs the plain version (`*_torch`) for CPU tensors; `*_cuda.launches`
counts the launches and `*_cuda.body_launches` the launches of each body:
the Hopper body (`*_body` gates: widths 8 divides, 16-byte aligned
operands) or the general WMMA body. None is differentiable:
`TransformerBlockFn` is the differentiable block, whose forward runs
`transformer_block_fwd` (or the plain `transformer_block_torch`) and whose
backward runs `transformer_block_bwd` (or `transformer_block_bwd_torch`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch._build import dispatch, refuse_autograd
from pixel_heal_thyself_tpu_torch.ops import library
from pixel_heal_thyself_tpu_torch.ops.attention import (
    block_halo_attention_bwd,
    block_halo_attention_bwd_torch,
    block_halo_attention_torch,
)
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import block_halo_attention_cuda
from pixel_heal_thyself_tpu_torch.ops.padding import pad2d

PAD_MODES = {"zeros": 0, "reflect": 1, "replicate": 2}
# the block's parameters, in the order TransformerBlockFn takes them
PARAM_NAMES = ("wcat", "bcat", "wq", "wk", "wv", "rel_h", "rel_w", "w1", "b1", "w2", "b2")
# the Hopper bodies of K2, K3, K5 (csrc/sm90_body.cuh) and K6
# (csrc/wgrad_sm90.cu): CTA tiles of 128 rows × 256 columns over 64-deep K
# stages, a ring of 4 stages of A (128 × 64 bf16) and B (64 × 256 bf16) in
# dynamic shared memory
SM90_TILE = (128, 256, 64)
SM90_STAGES = 4
# the general (WMMA) bodies: 128 × 128 tiles, two 256-thread CTAs per SM
# (110 registers each)
GENERAL_TILE = (128, 128)
GENERAL_CTAS_PER_SM = 2
MAX_SMEM = 232_448  # the opt-in shared memory of one CTA on the H100


class WgradPlan(NamedTuple):
    body: str  # "sm90" or "general"
    row_tiles: int
    col_tiles: int
    splits: int  # CTAs along the pixel sum
    pix_per_split: int  # pixels of each split but the last (sm90: a multiple of 64)
    smem: int  # dynamic shared memory of one CTA (bytes)


def sm90_smem() -> int:
    """Dynamic shared memory of one CTA of a Hopper body (K2, K3, K5 and K6
    alike): the ring's stages, its 3 × 4 mbarriers, 4 KB of coordinate
    tables (K3, K5: two of 128 pixels; K6: two of 64) and 1 KB to align to
    1,024. The gate of K5 and K6 is applied by a separate pass, K5's pad fold
    by a pre-pass, so neither adds stage bytes; with 9 taps or 1, one
    operand or two, the sum is the same."""
    bm, bn, bk = SM90_TILE
    return SM90_STAGES * (bm + bn) * bk * 2 + 3 * SM90_STAGES * 8 + 4096 + 1024


def wgrad_plan(m: int, n: int, pixels: int, wave: int, body: str = "sm90") -> WgradPlan:
    """K6's split of the pixel sum: as many splits as keep the grid within
    one wave of `wave` CTAs (sm90: one CTA per SM, whose ring takes most of
    its shared memory; general: `wave` is the SM count, two CTAs per SM),
    and no more than one per 64 pixels (sm90) or 256 (general). The
    splits cover the pixels in order, each but the last `pix_per_split` of
    them; the Hopper body's are never empty."""
    if body == "sm90":
        bm, bn, bk = SM90_TILE
        rows, cols, cap, least = -(-m // bm), -(-n // bn), wave, bk
    else:
        (bm, bn), bk = GENERAL_TILE, 32
        rows, cols, cap, least = -(-m // bm), -(-n // bn), GENERAL_CTAS_PER_SM * wave, 256
    splits = max(1, min(cap // (rows * cols), -(-pixels // least)))
    per = -(-pixels // splits)
    per = -(-per // bk) * bk  # (the general kernel computes the same)
    if body == "sm90":
        splits = -(-pixels // per)  # drop a split that rounding left empty
    return WgradPlan(body, rows, cols, splits, per, sm90_smem() if body == "sm90" else 0)


def _body(widths: tuple, tensors: tuple) -> str:
    """The rule of every body gate: a Hopper body needs 16-byte rows (each
    width a multiple of 8) and 16-byte aligned operands; other shapes take
    the general body. (A Hopper body itself picks how it loads its
    operands: TMA boxes where the shape allows, else a cp.async gather.)"""
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in tensors)
    return "sm90" if aligned and all(w % 8 == 0 for w in widths) else "general"


def conv3x3_body(c: int, n: int, *tensors) -> str:
    """K3's body for input channels `c`, output channels `n` and the
    operands `tensors` (`_body`'s rule)."""
    return _body((c, n), tensors)


def pointwise_gemm_body(k1: int, k2: int, n: int, *tensors) -> str:
    """K2's body for the operands' widths `k1`, `k2` (0: one operand) and
    `n` output channels (`_body`'s rule)."""
    return _body((k1, k2, n), tensors)


def conv3x3_dgrad_body(c: int, n: int, *tensors) -> str:
    """K5's body for the conv's input channels `c` (the gradient's) and
    output channels `n` (dy's) (`_body`'s rule)."""
    return _body((c, n), tensors)


def weight_grad_body(c1: int, c2: int, n: int, *tensors) -> str:
    """K6's body for the widths C1, C2 and N (`_body`'s rule)."""
    return _body((c1, c2, n), tensors)


def supports_shapes(
    b: int, h: int, w: int, c: int, *,
    block_size: int = 8, halo_size: int = 3, num_heads: int = 4,
    dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Gate for the block path (port of `block_mega.py:84`).

    Keeps the TPU gate's dtype and divisibility conditions and adds the
    explicit halo bound the TPU gate lacks (halo 0 corrupts edge columns
    there, halo > block reads out of bounds). The TPU-only conditions —
    C % 128, H % 16 and the VMEM budget — are dropped: the attention
    kernels take every 1 ≤ halo ≤ block."""
    del b
    if dtype != torch.bfloat16:
        return False
    if h % block_size or w % block_size:
        return False
    if c % num_heads or (c // num_heads) % 2:
        return False
    return 1 <= halo_size <= block_size


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _sm90_wave(device: torch.device) -> int:
    """CTAs of one wave of the Hopper bodies on `device`."""
    with torch.cuda.device(device):
        ctas = _build.lib().pht_sm90_wave_ctas()
    if ctas <= 0:
        raise RuntimeError(f"pht_sm90_wave_ctas: no CTA of the Hopper bodies fits ({ctas})")
    return ctas


def _cuda_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def _require_cuda_bf16(name: str, *tensors: torch.Tensor) -> None:
    refuse_autograd(name, *tensors)
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs all tensors on one CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} needs bf16 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _check_image(name: str, t: torch.Tensor | None, shape: tuple) -> None:
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


# ---------------------------------------------------------------- K2 --------

def _epilogue(acc: torch.Tensor, dtype, bias, relu: bool) -> torch.Tensor:
    y = acc.to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    if relu:
        y = torch.relu(y)
    return y


def pointwise_gemm_torch(a1, w1, a2=None, w2=None, bias=None, relu: bool = False,
                         pre_residual=None):
    """Plain K2: epi([pre_residual +] a1·w1 [+ a2·w2]) with f32
    accumulation, rounded once."""
    acc = a1.float() @ w1.float()
    if a2 is not None:
        acc = acc + a2.float() @ w2.float()
    if pre_residual is not None:
        acc = acc + pre_residual.float()
    return _epilogue(acc, a1.dtype, bias, relu)


def pointwise_gemm_cuda(a1, w1, a2=None, w2=None, bias=None, relu: bool = False,
                        pre_residual=None):
    """K2 on the card. a1 [..., K1], w1 [K1, N] (a2 [..., K2], w2 [K2, N]),
    bias [N], pre_residual [..., N] (added to the f32 sum before its
    rounding); all bf16, contiguous. Returns [..., N] bf16."""
    _require_cuda_bf16("pointwise_gemm_cuda", a1, w1, a2, w2, bias, pre_residual)
    k1, n = w1.shape
    if a1.shape[-1] != k1:
        raise ValueError(f"a1 {tuple(a1.shape)} does not match w1 {tuple(w1.shape)}")
    m = a1.numel() // k1
    k2 = 0
    if a2 is not None:
        k2 = w2.shape[0]
        if a2.shape[:-1] != a1.shape[:-1] or a2.shape[-1] != k2 or w2.shape[1] != n:
            raise ValueError("a2/w2 do not match a1/w1")
    _check_image("bias", bias, (n,))
    _check_image("pre_residual", pre_residual, (*a1.shape[:-1], n))
    out = torch.empty(*a1.shape[:-1], n, dtype=a1.dtype, device=a1.device)
    body = pointwise_gemm_body(k1, k2, n, a1, w1, a2, w2, bias, pre_residual, out)
    lib = _build.lib()
    err = (lib.pht_pointwise_gemm_sm90 if body == "sm90" else lib.pht_pointwise_gemm)(
        a1.data_ptr(), w1.data_ptr(), k1, _ptr(a2), _ptr(w2) if a2 is not None else None, k2,
        _ptr(bias), int(relu), _ptr(pre_residual), out.data_ptr(), m, n, _cuda_stream(a1),
    )
    pointwise_gemm_cuda.launches += 1
    pointwise_gemm_cuda.body_launches[body] += 1
    _build.check(err, f"pointwise_gemm_cuda ({body} body)")
    return out


# all launches, and by body: "sm90" (csrc/pointwise_sm90.cu) or "general"
# (block_fwd.cu's WMMA body)
pointwise_gemm_cuda.launches = 0
pointwise_gemm_cuda.body_launches = {"sm90": 0, "general": 0}


def pointwise_gemm(a1, w1, a2=None, w2=None, bias=None, relu: bool = False,
                   pre_residual=None):
    """K2 for CUDA tensors (launch or raise), the plain version for CPU."""
    return dispatch(
        "pointwise_gemm", a1, pointwise_gemm_cuda, pointwise_gemm_torch,
        a1, w1, a2, w2, bias, relu, pre_residual,
    )


# ---------------------------------------------------------------- K3 --------

def conv3x3_torch(x, w, bias, padding_mode: str, relu: bool = True, residual=None,
                  return_pre: bool = False):
    """Plain K3: [residual +] epi(conv3x3(pad(x))·w) with f32 accumulation
    rounded once (`_conv3x3_stripe` order). With `return_pre`, returns
    (out, the value before the residual)."""
    c, n = x.shape[-1], w.shape[1]
    xp = pad2d(x, 1, padding_mode).float().permute(0, 3, 1, 2)
    wk = w.float().reshape(3, 3, c, n).permute(3, 2, 0, 1)  # → OIHW
    acc = F.conv2d(xp, wk).permute(0, 2, 3, 1)
    pre = _epilogue(acc, x.dtype, bias, relu)
    y = pre if residual is None else residual + pre
    return (y, pre) if return_pre else y


def conv3x3_cuda(x, w, bias, padding_mode: str, relu: bool = True, residual=None,
                 return_pre: bool = False):
    """K3 on the card. x [B,H,W,C], w [9C, N], bias [N], residual
    [B,H,W,N]; all bf16, contiguous. Returns [B,H,W,N] bf16 (and, with
    `return_pre`, the value before the residual)."""
    _require_cuda_bf16("conv3x3_cuda", x, w, bias, residual)
    if padding_mode not in PAD_MODES:
        raise ValueError(f"unknown padding mode {padding_mode!r}")
    b, h, wd, c = x.shape
    if w.shape[0] != 9 * c:
        raise ValueError(f"w {tuple(w.shape)} is not [9·{c}, N]")
    n = w.shape[1]
    if padding_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W ≥ 2")
    _check_image("bias", bias, (n,))
    _check_image("residual", residual, (b, h, wd, n))
    out = torch.empty(b, h, wd, n, dtype=x.dtype, device=x.device)
    pre = torch.empty_like(out) if return_pre else None
    body = conv3x3_body(c, n, x, w, bias, residual, out, pre)
    args = (x.data_ptr(), w.data_ptr(), _ptr(bias), int(relu), _ptr(residual),
            out.data_ptr(), _ptr(pre), b, h, wd, c, n, PAD_MODES[padding_mode])
    lib = _build.lib()
    err = (lib.pht_conv3x3_sm90 if body == "sm90" else lib.pht_conv3x3)(*args, _cuda_stream(x))
    conv3x3_cuda.launches += 1
    conv3x3_cuda.body_launches[body] += 1
    _build.check(err, f"conv3x3_cuda ({body} body)")
    return (out, pre) if return_pre else out


# all launches, and by body: "sm90" (csrc/conv3x3_sm90.cu) or "general"
# (block_fwd.cu's WMMA body)
conv3x3_cuda.launches = 0
conv3x3_cuda.body_launches = {"sm90": 0, "general": 0}


def conv3x3(x, w, bias, padding_mode: str, relu: bool = True, residual=None,
            return_pre: bool = False):
    """K3 for CUDA tensors (launch or raise), the plain version for CPU."""
    return dispatch(
        "conv3x3", x, conv3x3_cuda, conv3x3_torch,
        x, w, bias, padding_mode, relu, residual, return_pre,
    )


# ---------------------------------------------------------------- K5 --------

def _gated(dy: torch.Tensor, gate: torch.Tensor | None) -> torch.Tensor:
    """dy ⊙ [gate > 0] (exact in dy's dtype)."""
    return dy if gate is None else torch.where(gate > 0, dy, torch.zeros_like(dy))


def _fold_pad_grad(gp: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """Gradient w.r.t. a 1-padded NHWC input → gradient w.r.t. the input:
    reflect folds pad −1 into index 1 and pad n into n−2, replicate into 0
    and n−1 (rows first, then columns, as `block_mega._fold_pad_grads`);
    zero padding drops the pad."""
    if padding_mode != "zeros":
        gp = gp.clone()
        lo = 2 if padding_mode == "reflect" else 1  # padded index of the target
        for dim in (1, 2):
            n = gp.shape[dim] - 2
            hi = n - 1 if padding_mode == "reflect" else n
            gp.select(dim, lo).add_(gp.select(dim, 0))
            gp.select(dim, hi).add_(gp.select(dim, n + 1))
    return gp[:, 1:-1, 1:-1]


def fold_lines(n: int, padding_mode: str) -> tuple[int, int]:
    """The coordinates onto which reflect (1, n − 2) and replicate (0, n − 1)
    padding fold the gradient of the padded ring, on the low and high side."""
    return (1, n - 2) if padding_mode == "reflect" else (0, n - 1)


def dgrad_fold_floats(b: int, h: int, w: int, c: int, padding_mode: str) -> int:
    """f32 entries of K5's fold side buffer: a row-line part [B][2][W][C]
    and a column-line part [B][H][2][C]; none for zero padding."""
    return 0 if padding_mode == "zeros" else 2 * b * (w + h) * c


def dgrad_fold_torch(g, w, padding_mode: str) -> torch.Tensor:
    """Plain version of K5's fold pre-pass: the f32 terms that reflect or
    replicate padding folds onto the lines next to the frame edge, in the
    side buffer's layout (flat f32, `dgrad_fold_floats` entries). g [B,H,W,N]
    is the gated output gradient, w [9C, N]. Row line s (top 0, bottom 1)
    at pixel x: Σ_kx g[row, x + 1 − kx]·W[ky, kx]ᵀ over in-frame sources,
    with row 0, ky 0 (top) or row H − 1, ky 2 (bottom), plus the corner
    terms on the column fold lines (column 0 through kx 0, column W − 1
    through kx 2). Column line s at pixel y: Σ_ky g[y + 1 − ky, col]·W[ky,
    kx]ᵀ with column 0, kx 0 (left) or W − 1, kx 2 (right)."""
    if padding_mode not in ("reflect", "replicate"):
        raise ValueError(f"no pad fold for {padding_mode!r} padding")
    b, h, wd, n = g.shape
    c = w.shape[0] // 9
    wt = w.float().view(3, 3, c, n)
    gf = g.float()
    gz = F.pad(gf, (0, 0, 1, 1, 1, 1))  # zeros around the frame: [b, h + 2, w + 2, n]
    (tx0, tx1), sides = fold_lines(wd, padding_mode), ((0, 0), (2, -1))
    rows = []
    for k, src in sides:  # k: the fold tap's ky; src: the source row
        line = gz[:, src % h + 1]  # [b, w + 2, n]
        acc = sum(line[:, 2 - kx:2 - kx + wd] @ wt[k, kx].t() for kx in range(3))
        acc[:, tx0] += gf[:, src % h, 0] @ wt[k, 0].t()
        acc[:, tx1] += gf[:, src % h, wd - 1] @ wt[k, 2].t()
        rows.append(acc)
    cols = []
    for k, src in sides:  # k: the fold tap's kx; src: the source column
        line = gz[:, :, src % wd + 1]  # [b, h + 2, n]
        cols.append(sum(line[:, 2 - ky:2 - ky + h] @ wt[ky, k].t() for ky in range(3)))
    return torch.cat([torch.stack(rows, 1).reshape(-1), torch.stack(cols, 2).reshape(-1)])


def conv3x3_dgrad_torch(dy, gate, w, padding_mode: str, residual=None):
    """Plain K5: round(fold(Σ_taps (dy⊙[gate>0])·W[tap]ᵀ) [+ residual]),
    every term summed in f32. dy/gate [B,H,W,N], w [9C, N] (the forward's
    kernel-layout weight), residual [B,H,W,C]. Returns [B,H,W,C]."""
    c, n = w.shape[0] // 9, w.shape[1]
    dpre = _gated(dy, gate).float().permute(0, 3, 1, 2)
    wk = w.float().reshape(3, 3, c, n).permute(3, 2, 0, 1)  # OIHW [N, C, 3, 3]
    gp = F.conv_transpose2d(dpre, wk).permute(0, 2, 3, 1)  # w.r.t. the padded input
    g = _fold_pad_grad(gp, padding_mode)
    if residual is not None:
        g = g + residual.float()
    return g.to(dy.dtype)


def conv3x3_dgrad_cuda(dy, gate, w, padding_mode: str, residual=None):
    """K5 on the card; arguments as `conv3x3_dgrad_torch`, all bf16,
    contiguous."""
    _require_cuda_bf16("conv3x3_dgrad_cuda", dy, gate, w, residual)
    if padding_mode not in PAD_MODES:
        raise ValueError(f"unknown padding mode {padding_mode!r}")
    b, h, wd, n = dy.shape
    if w.shape[1] != n or w.shape[0] % 9:
        raise ValueError(f"w {tuple(w.shape)} is not [9·C, {n}]")
    c = w.shape[0] // 9
    if padding_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W ≥ 2")
    _check_image("gate", gate, dy.shape)
    _check_image("residual", residual, (b, h, wd, c))
    out = torch.empty(b, h, wd, c, dtype=dy.dtype, device=dy.device)
    body = conv3x3_dgrad_body(c, n, dy, gate, w, residual, out)
    pad = PAD_MODES[padding_mode]
    if body == "sm90":  # W as it is: the body reads it K-major
        g = torch.empty_like(dy) if gate is not None else None  # dy ⊙ [gate > 0]
        floats = dgrad_fold_floats(b, h, wd, c, padding_mode)
        fold = torch.empty(floats, dtype=torch.float32, device=dy.device) if floats else None
        err = _build.lib().pht_conv3x3_dgrad_sm90(
            dy.data_ptr(), _ptr(gate), _ptr(g), w.data_ptr(), _ptr(residual), _ptr(fold),
            out.data_ptr(), b, h, wd, n, c, pad, _cuda_stream(dy),
        )
    else:
        wt = w.view(9, c, n).transpose(1, 2).contiguous()  # per-tap Wᵀ [9, N, C]
        err = _build.lib().pht_conv3x3_dgrad(
            dy.data_ptr(), _ptr(gate), wt.data_ptr(), _ptr(residual), out.data_ptr(),
            b, h, wd, n, c, pad, _cuda_stream(dy),
        )
    conv3x3_dgrad_cuda.launches += 1
    conv3x3_dgrad_cuda.body_launches[body] += 1
    _build.check(err, f"conv3x3_dgrad_cuda ({body} body)")
    return out


# all launches, and by body: "sm90" (csrc/dgrad_sm90.cu) or "general"
# (block_bwd.cu's WMMA body)
conv3x3_dgrad_cuda.launches = 0
conv3x3_dgrad_cuda.body_launches = {"sm90": 0, "general": 0}


def conv3x3_dgrad(dy, gate, w, padding_mode: str, residual=None):
    """K5 for CUDA tensors (launch or raise), the plain version for CPU."""
    return dispatch(
        "conv3x3_dgrad", dy, conv3x3_dgrad_cuda, conv3x3_dgrad_torch,
        dy, gate, w, padding_mode, residual,
    )


# ---------------------------------------------------------------- K6 --------

def weight_grad_torch(x, dy, gate=None, x2=None, *, taps: int = 1,
                      padding_mode: str = "zeros", colsum: bool = False):
    """Plain K6: (dW, db) in f32. dW [taps·C1 (+ C2), N] = Σ_pixels
    shift_tap(x)ᵀ·(dy⊙[gate>0]) (taps 9: the 3×3 conv weight gradient,
    tap-major rows, `padding_mode` padding; taps 1 with `x2`: rows of x
    then of x2); db = Σ_pixels dy⊙[gate>0] when `colsum`, else None."""
    dpre = _gated(dy, gate).float().reshape(-1, dy.shape[-1])
    if taps == 9:
        b, h, w, c = x.shape
        xp = pad2d(x, 1, padding_mode).float()
        cols = [xp[:, i:i + h, j:j + w].reshape(-1, c) for i in range(3) for j in range(3)]
    elif taps == 1:
        cols = [x.float().reshape(-1, x.shape[-1])]
        if x2 is not None:
            cols.append(x2.float().reshape(-1, x2.shape[-1]))
    else:
        raise ValueError(f"taps={taps} (1 or 9)")
    dw = torch.cat([col.t() @ dpre for col in cols], dim=0)
    return dw, (dpre.sum(0) if colsum else None)


def weight_grad_cuda(x, dy, gate=None, x2=None, *, taps: int = 1,
                     padding_mode: str = "zeros", colsum: bool = False):
    """K6 on the card; arguments as `weight_grad_torch`, all bf16,
    contiguous NHWC. Splits the pixel sum over CTAs and adds the f32
    partials in a fixed order."""
    _require_cuda_bf16("weight_grad_cuda", x, dy, gate, x2)
    if padding_mode not in PAD_MODES:
        raise ValueError(f"unknown padding mode {padding_mode!r}")
    if taps not in (1, 9) or (taps == 9 and x2 is not None):
        raise ValueError(f"taps={taps} with x2: 1 or 9 taps, a second operand only with 1")
    b, h, w, c1 = x.shape
    n = dy.shape[-1]
    if dy.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} differ in pixels")
    if taps == 9 and padding_mode == "reflect" and (h < 2 or w < 2):
        raise ValueError("reflect padding needs H, W ≥ 2")
    _check_image("gate", gate, dy.shape)
    c2 = 0 if x2 is None else x2.shape[-1]
    if x2 is not None:
        _check_image("x2", x2, (b, h, w, c2))
    m = taps * c1 + c2
    body = weight_grad_body(c1, c2, n, x, dy, gate, x2)
    wave = _sm90_wave(x.device) if body == "sm90" else _sm_count(x.device)
    plan = wgrad_plan(m, n, b * h * w, wave, body)
    size = m * n + (n if colsum else 0)
    part = torch.empty(plan.splits, size, dtype=torch.float32, device=x.device)
    out = torch.empty(size, dtype=torch.float32, device=x.device)
    pad = PAD_MODES[padding_mode]
    if body == "sm90":
        g = torch.empty_like(dy) if gate is not None else None  # dy ⊙ [gate > 0]
        err = _build.lib().pht_weight_grad_sm90(
            x.data_ptr(), c1, _ptr(x2), c2, dy.data_ptr(), _ptr(gate), _ptr(g),
            part.data_ptr(), out.data_ptr(), b, h, w, n, taps, pad, int(colsum),
            plan.splits, plan.pix_per_split, _cuda_stream(x),
        )
    else:
        err = _build.lib().pht_weight_grad(
            x.data_ptr(), c1, _ptr(x2), c2, dy.data_ptr(), _ptr(gate), part.data_ptr(),
            out.data_ptr(), b, h, w, n, taps, pad, int(colsum), plan.splits, _cuda_stream(x),
        )
    weight_grad_cuda.launches += 1
    weight_grad_cuda.body_launches[body] += 1
    _build.check(err, f"weight_grad_cuda ({body} body)")
    return out[: m * n].view(m, n), (out[m * n:] if colsum else None)


# all launches, and by body: "sm90" (csrc/wgrad_sm90.cu) or "general"
# (block_bwd.cu's WMMA body)
weight_grad_cuda.launches = 0
weight_grad_cuda.body_launches = {"sm90": 0, "general": 0}


def weight_grad(x, dy, gate=None, x2=None, *, taps: int = 1, padding_mode: str = "zeros",
                colsum: bool = False):
    """K6 for CUDA tensors (launch or raise), the plain version for CPU."""
    return dispatch(
        "weight_grad", x, weight_grad_cuda, weight_grad_torch, x, dy, gate, x2,
        taps=taps, padding_mode=padding_mode, colsum=colsum,
    )


# ---------------------------------------------------------------- block -----

def _block_chain(gemm, attention, conv, x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w,
                 w1, b1, w2, b2, *, block_size, halo_size, num_heads, padding_mode, emit):
    c = x.shape[-1]
    n = gemm(x, wcat[:c], a, wcat[c:], bcat, relu=True)
    k = gemm(n, wk)
    v = gemm(x, wv)
    q = gemm(n, wq)
    x1 = attention(
        q, k, v, rel_h, rel_w, block_size=block_size, halo_size=halo_size,
        num_heads=num_heads, residual=x,
    )
    f1 = conv(x1, w1, b1, padding_mode, relu=True)
    if not emit:
        return conv(f1, w2, b2, padding_mode, relu=True, residual=x1)
    out, f2 = conv(f1, w2, b2, padding_mode, relu=True, residual=x1, return_pre=True)
    return out, x1, f1, f2


def transformer_block_torch(x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
                            *, block_size=8, halo_size=3, num_heads=4,
                            padding_mode="reflect", emit=False):
    """Plain block forward on [B,H,W,C] images (kernel-layout weights, see
    the module docstring); the TPU kernel's rounding points. With `emit`,
    returns (out, x1, f1, f2) for the backward."""
    return _block_chain(
        pointwise_gemm_torch, block_halo_attention_torch, conv3x3_torch,
        x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
        block_size=block_size, halo_size=halo_size, num_heads=num_heads,
        padding_mode=padding_mode, emit=emit,
    )


def _require_supported(name, x, block_size, halo_size, num_heads):
    b, h, w, c = x.shape
    if not supports_shapes(b, h, w, c, block_size=block_size, halo_size=halo_size,
                           num_heads=num_heads, dtype=x.dtype):
        raise ValueError(
            f"{name} does not support {tuple(x.shape)} {x.dtype} "
            f"(block {block_size}, halo {halo_size}, heads {num_heads})",
        )


def transformer_block_cuda(x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
                           *, block_size=8, halo_size=3, num_heads=4,
                           padding_mode="reflect", emit=False):
    """Block forward on the card: K2 → K1 → K3 → K3, each wrapper launching
    or raising."""
    return _block_chain(
        pointwise_gemm_cuda, block_halo_attention_cuda, conv3x3_cuda,
        x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
        block_size=block_size, halo_size=halo_size, num_heads=num_heads,
        padding_mode=padding_mode, emit=emit,
    )


def transformer_block_fwd(x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
                          *, block_size=8, halo_size=3, num_heads=4,
                          padding_mode="reflect", emit=False):
    """Block forward: `transformer_block_cuda` for CUDA tensors, the plain
    version for CPU tensors. Without `emit` (serving) through
    `ops/library.py`, which `torch.export` keeps as the op
    `pht::transformer_block_fwd`."""
    _require_supported("transformer_block_fwd", x, block_size, halo_size, num_heads)
    weights = (wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2)
    if emit:
        return dispatch("transformer_block_fwd", x, transformer_block_cuda,
                        transformer_block_torch, x, a, *weights, block_size=block_size,
                        halo_size=halo_size, num_heads=num_heads, padding_mode=padding_mode,
                        emit=True)
    return library.transformer_block_fwd(x, a, *weights, block_size, halo_size, num_heads,
                                         padding_mode)


def _block_bwd_chain(gemm, attention_bwd, dgrad, wgrad, x, a, x1, f1, f2, do,
                     wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, w2,
                     *, block_size, halo_size, num_heads, padding_mode):
    c = x.shape[-1]
    conv = dict(taps=9, padding_mode=padding_mode, colsum=True)
    # conv2, then conv1 (ReLU masks f2 > 0 and f1 > 0)
    dw2, db2 = wgrad(f1, do, f2, **conv)
    df1 = dgrad(do, f2, w2, padding_mode)
    dw1, db1 = wgrad(x1, df1, f1, **conv)
    dx1 = dgrad(df1, f1, w1, padding_mode, residual=do)
    # recompute n, k, v, q (the TPU kernel's phase B)
    n = gemm(x, wcat[:c], a, wcat[c:], bcat, relu=True)
    k = gemm(n, wk)
    v = gemm(x, wv)
    q = gemm(n, wq)
    dq, dk, dv, drel_h, drel_w = attention_bwd(
        q, k, v, rel_h, rel_w, dx1, block_size=block_size, halo_size=halo_size,
        num_heads=num_heads,
    )
    # projections
    dwq, _ = wgrad(n, dq)
    dwk, _ = wgrad(n, dk)
    dwv, _ = wgrad(x, dv)
    dn = gemm(dq, wq.t().contiguous()) + gemm(dk, wk.t().contiguous())
    dz = torch.where(n > 0, dn, torch.zeros_like(dn))
    dwcat, dbcat = wgrad(x, dz, None, a, colsum=True)
    wcat_t = wcat.t()  # [C, 2C]: the x half, then the a half
    dx = gemm(dv, wv.t().contiguous(), dz, wcat_t[:, :c].contiguous(), pre_residual=dx1)
    da = gemm(dz, wcat_t[:, c:].contiguous())
    return dx, da, dwcat, dbcat, dwq, dwk, dwv, drel_h, drel_w, dw1, db1, dw2, db2


def transformer_block_bwd_torch(x, a, x1, f1, f2, do, wcat, bcat, wq, wk, wv, rel_h, rel_w,
                                w1, b1, w2, b2, *, block_size=8, halo_size=3, num_heads=4,
                                padding_mode="reflect"):
    """Plain block backward (not autograd): the 13 gradients (dx, da, then
    the weights' in `PARAM_NAMES` order, kernel layout, f32) from the
    forward's inputs, its `emit` outputs x1/f1/f2 and the output gradient
    `do`, at the rounding points of the TPU `_bwd_kernel`."""
    del b1, b2
    return _block_bwd_chain(
        pointwise_gemm_torch, block_halo_attention_bwd_torch, conv3x3_dgrad_torch,
        weight_grad_torch, x, a, x1, f1, f2, do, wcat, bcat, wq, wk, wv, rel_h, rel_w,
        w1, w2, block_size=block_size, halo_size=halo_size, num_heads=num_heads,
        padding_mode=padding_mode,
    )


def transformer_block_bwd(x, a, x1, f1, f2, do, wcat, bcat, wq, wk, wv, rel_h, rel_w,
                          w1, b1, w2, b2, *, block_size=8, halo_size=3, num_heads=4,
                          padding_mode="reflect"):
    """Block backward through the dispatchers: K6/K5 → K6/K5 → K4 → K6/K2
    on the card for CUDA tensors (each launches or raises), the plain
    version for CPU tensors."""
    del b1, b2
    _require_supported("transformer_block_bwd", x, block_size, halo_size, num_heads)
    return _block_bwd_chain(
        pointwise_gemm, block_halo_attention_bwd, conv3x3_dgrad, weight_grad,
        x, a, x1, f1, f2, do, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, w2,
        block_size=block_size, halo_size=halo_size, num_heads=num_heads,
        padding_mode=padding_mode,
    )


def kernel_layout(dtype, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2) -> dict:
    """The block's parameters (OIHW convs, f32) in the kernels' layout:
    1×1 convs [in, out], 3×3 convs HWIO reshaped to [9·in, out], all in
    `dtype` except rel_h/rel_w (f32)."""

    def mat(w):  # OIHW 1×1 → [in, out]
        return w[:, :, 0, 0].t().to(dtype).contiguous()

    def taps(w):  # OIHW 3×3 → HWIO → [9·in, out]
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).to(dtype).contiguous()

    return dict(
        wcat=mat(wcat), bcat=bcat.to(dtype), wq=mat(wq), wk=mat(wk), wv=mat(wv),
        rel_h=rel_h.float(), rel_w=rel_w.float(),
        w1=taps(w1), b1=b1.to(dtype), w2=taps(w2), b2=b2.to(dtype),
    )


def param_layout(grads: tuple, params: tuple) -> tuple:
    """Kernel-layout weight gradients (`PARAM_NAMES` order) → the
    parameters' own layouts (the inverse of `kernel_layout`), f32."""
    out = []
    for name, g, p in zip(PARAM_NAMES, grads, params):
        if name in ("wcat", "wq", "wk", "wv"):
            g = g.t()[:, :, None, None]
        elif name in ("w1", "w2"):
            g = g.reshape(3, 3, p.shape[1], p.shape[0]).permute(3, 2, 0, 1)
        out.append(g.to(p.dtype).contiguous())
    return tuple(out)


class BlockConfig(NamedTuple):
    block_size: int
    halo_size: int
    num_heads: int
    padding_mode: str
    use_kernels: bool  # False: the plain versions on any device


class TransformerBlockFn(torch.autograd.Function):
    """The differentiable whole block (port of the TPU custom VJP
    `_mega_core`, `ops/block_mega.py:1133-1171`).

    `apply(cfg, x, a, *params)`: x, a [B,H,W,C] bf16; `params` in
    `PARAM_NAMES` order in their own layout and dtype (f32, OIHW convs).
    The layout change and bf16 cast happen inside `forward`, so the
    weight gradients come back in f32 (torch's engine casts a returned
    gradient to its input's dtype: bf16 copies as inputs would round every
    f32-accumulated dW). The forward saves x, a and the `emit` outputs
    x1, f1, f2 (4 more bf16 images per block: 268 MB at 8 × 128² × 256);
    n, k, v, q are recomputed in the backward. First-order only."""

    @staticmethod
    def forward(ctx, cfg: BlockConfig, x, a, *params):
        kw = kernel_layout(x.dtype, *params)
        fwd = transformer_block_fwd if cfg.use_kernels else transformer_block_torch
        geom = dict(block_size=cfg.block_size, halo_size=cfg.halo_size,
                    num_heads=cfg.num_heads, padding_mode=cfg.padding_mode)
        out, x1, f1, f2 = fwd(x, a, **kw, **geom, emit=True)
        ctx.cfg, ctx.geom = cfg, geom
        ctx.save_for_backward(x, a, x1, f1, f2, *params)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        x, a, x1, f1, f2, *params = ctx.saved_tensors
        kw = kernel_layout(x.dtype, *params)
        bwd = transformer_block_bwd if ctx.cfg.use_kernels else transformer_block_bwd_torch
        dx, da, *dw = bwd(x, a, x1, f1, f2, do.contiguous(), **kw, **ctx.geom)
        return (None, dx, da, *param_layout(tuple(dw), tuple(params)))

"""The whole-TransformerBlock forward: CUDA kernels K2/K3 and the block chain.

Port of the TPU kernel `_block_kernel` (`pixel_heal_thyself_tpu/ops/
block_mega.py:413`, `emit=False`, launched by `_mega_fwd` :586). On the
TPU that kernel is one Pallas call per block; here the block is a short
chain of hand-written kernels on unpadded NHWC images:

    n   = relu(round(x·Wcat[:C] + a·Wcat[C:]) + bcat)     K2 (two operands)
    k   = round(n·Wk);  v = round(x·Wv);  q = round(n·Wq)   K2 ×3
    x1  = x + attention(q, k, v)                            K1, residual fused
    f1  = relu(round(conv3x3(x1)·W1) + b1)                  K3
    out = x1 + relu(round(conv3x3(f1)·W2) + b2)             K3, residual fused

in bf16 with f32 accumulation and the TPU kernel's rounding points. The
W-halo-padded layout of the TPU kernel existed only for sublane alignment,
so the port drops it (and with it `pad_w_halo`/`unpad_w_halo`).

Weights come in kernel layout, all bf16 except rel_h/rel_w (f32): wcat
[2C, C] ([x; a] input order), wq/wk/wv [C, C] ([in, out]), w1/w2 [9C, C]
(HWIO reshaped, tap-major), biases [C].

Each kernel has a dispatcher (`pointwise_gemm`, `conv3x3`) that launches
the kernel for CUDA tensors and runs the plain version (`*_torch`) for CPU
tensors; `*_cuda.launches` counts the launches. `transformer_block_torch`
is the plain block; `transformer_block_fwd` is the same chain through the
dispatchers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.ops.attention import (
    block_halo_attention,
    block_halo_attention_torch,
)
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
    MAX_SMEM_BYTES,
    attention_smem_bytes,
)
from pixel_heal_thyself_tpu_torch.ops.padding import pad2d

PAD_MODES = {"zeros": 0, "reflect": 1, "replicate": 2}


def supports_shapes(
    b: int, h: int, w: int, c: int, *,
    block_size: int = 8, halo_size: int = 3, num_heads: int = 4,
    dtype: torch.dtype = torch.bfloat16,
) -> bool:
    """Gate for the block path (port of `block_mega.py:84`).

    Keeps the TPU gate's dtype and divisibility conditions and adds the
    explicit halo bound the TPU gate lacks (halo 0 corrupts edge columns
    there, halo > block reads out of bounds). The TPU-only conditions —
    C % 128, H % 16 and the VMEM budget — are dropped; the attention
    kernel's shared-memory plan must fit instead."""
    if dtype != torch.bfloat16:
        return False
    if h % block_size or w % block_size:
        return False
    if c % num_heads or (c // num_heads) % 2:
        return False
    if not 1 <= halo_size <= block_size:
        return False
    hd = c // num_heads
    return attention_smem_bytes(block_size, halo_size, hd, dtype) <= MAX_SMEM_BYTES


def _cuda_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda_bf16(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs all tensors on one CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} needs bf16 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _dispatch(name: str, x: torch.Tensor, cuda_fn, torch_fn, *args, **kw):
    if x.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if x.device.type == "cpu":
        return torch_fn(*args, **kw)
    raise ValueError(f"{name}: unsupported device {x.device}")


# ---------------------------------------------------------------- K2 --------

def _epilogue(acc: torch.Tensor, dtype, bias, relu: bool) -> torch.Tensor:
    y = acc.to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    if relu:
        y = torch.relu(y)
    return y


def pointwise_gemm_torch(a1, w1, a2=None, w2=None, bias=None, relu: bool = False):
    """Plain K2: epi(a1·w1 [+ a2·w2]) with f32 accumulation, rounded once."""
    acc = a1.float() @ w1.float()
    if a2 is not None:
        acc = acc + a2.float() @ w2.float()
    return _epilogue(acc, a1.dtype, bias, relu)


def pointwise_gemm_cuda(a1, w1, a2=None, w2=None, bias=None, relu: bool = False):
    """K2 on the card. a1 [..., K1], w1 [K1, N] (a2 [..., K2], w2 [K2, N]),
    bias [N]; all bf16, contiguous. Returns [..., N] bf16."""
    ops = [a1, w1] + ([a2, w2] if a2 is not None else []) + ([bias] if bias is not None else [])
    _require_cuda_bf16("pointwise_gemm_cuda", *ops)
    k1, n = w1.shape
    if a1.shape[-1] != k1:
        raise ValueError(f"a1 {tuple(a1.shape)} does not match w1 {tuple(w1.shape)}")
    m = a1.numel() // k1
    k2 = 0
    if a2 is not None:
        k2 = w2.shape[0]
        if a2.shape[:-1] != a1.shape[:-1] or a2.shape[-1] != k2 or w2.shape[1] != n:
            raise ValueError("a2/w2 do not match a1/w1")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({n},)")
    out = torch.empty(*a1.shape[:-1], n, dtype=a1.dtype, device=a1.device)
    err = _build.lib().pht_pointwise_gemm(
        a1.data_ptr(), w1.data_ptr(), k1,
        a2.data_ptr() if a2 is not None else None,
        w2.data_ptr() if a2 is not None else None, k2,
        bias.data_ptr() if bias is not None else None, int(relu),
        out.data_ptr(), m, n, _cuda_stream(a1),
    )
    pointwise_gemm_cuda.launches += 1
    _build.check(err, "pointwise_gemm_cuda")
    return out


pointwise_gemm_cuda.launches = 0


def pointwise_gemm(a1, w1, a2=None, w2=None, bias=None, relu: bool = False):
    """K2 for CUDA tensors (launch or raise), the plain version for CPU."""
    return _dispatch(
        "pointwise_gemm", a1, pointwise_gemm_cuda, pointwise_gemm_torch,
        a1, w1, a2, w2, bias, relu,
    )


# ---------------------------------------------------------------- K3 --------

def conv3x3_torch(x, w, bias, padding_mode: str, relu: bool = True, residual=None):
    """Plain K3: [residual +] epi(conv3x3(pad(x))·w) with f32 accumulation
    rounded once (`_conv3x3_stripe` order)."""
    c, n = x.shape[-1], w.shape[1]
    xp = pad2d(x, 1, padding_mode).float().permute(0, 3, 1, 2)
    wk = w.float().reshape(3, 3, c, n).permute(3, 2, 0, 1)  # → OIHW
    acc = F.conv2d(xp, wk).permute(0, 2, 3, 1)
    y = _epilogue(acc, x.dtype, bias, relu)
    if residual is not None:
        y = residual + y
    return y


def conv3x3_cuda(x, w, bias, padding_mode: str, relu: bool = True, residual=None):
    """K3 on the card. x [B,H,W,C], w [9C, N], bias [N], residual
    [B,H,W,N]; all bf16, contiguous. Returns [B,H,W,N] bf16."""
    ops = [x, w] + ([bias] if bias is not None else []) + (
        [residual] if residual is not None else [])
    _require_cuda_bf16("conv3x3_cuda", *ops)
    if padding_mode not in PAD_MODES:
        raise ValueError(f"unknown padding mode {padding_mode!r}")
    b, h, wd, c = x.shape
    if w.shape[0] != 9 * c:
        raise ValueError(f"w {tuple(w.shape)} is not [9·{c}, N]")
    n = w.shape[1]
    if padding_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W ≥ 2")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({n},)")
    if residual is not None and residual.shape != (b, h, wd, n):
        raise ValueError(f"residual shape {tuple(residual.shape)} != {(b, h, wd, n)}")
    out = torch.empty(b, h, wd, n, dtype=x.dtype, device=x.device)
    err = _build.lib().pht_conv3x3(
        x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        int(relu), residual.data_ptr() if residual is not None else None,
        out.data_ptr(), b, h, wd, c, n, PAD_MODES[padding_mode], _cuda_stream(x),
    )
    conv3x3_cuda.launches += 1
    _build.check(err, "conv3x3_cuda")
    return out


conv3x3_cuda.launches = 0


def conv3x3(x, w, bias, padding_mode: str, relu: bool = True, residual=None):
    """K3 for CUDA tensors (launch or raise), the plain version for CPU."""
    return _dispatch(
        "conv3x3", x, conv3x3_cuda, conv3x3_torch,
        x, w, bias, padding_mode, relu, residual,
    )


# ---------------------------------------------------------------- block -----

def _block_chain(gemm, attention, conv, x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w,
                 w1, b1, w2, b2, *, block_size, halo_size, num_heads, padding_mode):
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
    return conv(f1, w2, b2, padding_mode, relu=True, residual=x1)


def transformer_block_torch(x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
                            *, block_size=8, halo_size=3, num_heads=4,
                            padding_mode="reflect"):
    """Plain block forward on [B,H,W,C] bf16 images (kernel-layout weights,
    see the module docstring); the TPU kernel's rounding points."""
    return _block_chain(
        pointwise_gemm_torch, block_halo_attention_torch, conv3x3_torch,
        x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
        block_size=block_size, halo_size=halo_size, num_heads=num_heads,
        padding_mode=padding_mode,
    )


def transformer_block_fwd(x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
                          *, block_size=8, halo_size=3, num_heads=4,
                          padding_mode="reflect"):
    """Block forward: K2 → K1 → K3 → K3 on the card for CUDA tensors (each
    launches or raises), the plain version for CPU tensors."""
    b, h, w, c = x.shape
    if not supports_shapes(b, h, w, c, block_size=block_size, halo_size=halo_size,
                           num_heads=num_heads, dtype=x.dtype):
        raise ValueError(
            f"transformer_block_fwd does not support {tuple(x.shape)} {x.dtype} "
            f"(block {block_size}, halo {halo_size}, heads {num_heads})",
        )
    return _block_chain(
        pointwise_gemm, block_halo_attention, conv3x3,
        x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2,
        block_size=block_size, halo_size=halo_size, num_heads=num_heads,
        padding_mode=padding_mode,
    )

"""Wrapper of the block-halo attention CUDA kernel (K1, `csrc/attention_fwd.cu`).

Replaces the TPU kernel `pixel_heal_thyself_tpu/ops/attention_pallas.py:217`
(`_fwd_kernel`). Semantics and rounding order are those of the plain
`ops.attention.block_halo_attention_torch`, which the CPU tests hold
against the JAX package and `chip_smoke.py` holds this kernel against on
the card. `block_halo_attention_cuda.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch import _build

# the opt-in shared-memory ceiling of one CTA on Hopper (227 KB)
MAX_SMEM_BYTES = 232448


def attention_smem_bytes(block_size: int, halo_size: int, head_ch: int, dtype) -> int:
    """Shared memory one CTA of K1 uses (mirrors `smem_bytes` in the .cu)."""
    nq = block_size * block_size
    nk = (block_size + 2 * halo_size) ** 2
    elem = 2 if dtype == torch.bfloat16 else 4
    return nq * nk * 4 + (nq * head_ch + 2 * nk * head_ch) * elem


def _check_inputs(q, k, v, rel_h, rel_w, residual, block_size, halo_size, num_heads):
    if q.device.type != "cuda":
        raise ValueError(f"block_halo_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"block_halo_attention_cuda: dtype {q.dtype} (bf16 or fp32)")
    b, h, w, c = q.shape
    tensors = [k, v] + ([residual] if residual is not None else [])
    for t in [q, *tensors]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v (and residual) must share shape, dtype, device")
        if not t.is_contiguous():
            raise ValueError("block_halo_attention_cuda needs contiguous NHWC tensors")
    if h % block_size or w % block_size:
        raise ValueError(f"H×W = {h}×{w} not divisible by block_size={block_size}")
    if c % num_heads or (c // num_heads) % 2:
        raise ValueError(f"C={c} must split into {num_heads} heads of even width")
    if not 1 <= halo_size <= block_size:
        raise ValueError(f"halo_size={halo_size} must be in [1, block_size]")
    window = block_size + 2 * halo_size
    hd = c // num_heads
    for name, r in (("rel_h", rel_h), ("rel_w", rel_w)):
        if r.shape != (window, hd // 2):
            raise ValueError(f"{name} shape {tuple(r.shape)} != {(window, hd // 2)}")
    smem = attention_smem_bytes(block_size, halo_size, hd, q.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"block_halo_attention_cuda: {smem} B of shared memory per CTA "
            f"exceeds {MAX_SMEM_BYTES} (block {block_size}, halo {halo_size}, "
            f"head_ch {hd})",
        )


def block_halo_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    *,
    block_size: int,
    halo_size: int,
    num_heads: int,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K1 on `torch.cuda.current_stream()`: [B,H,W,C] q/k/v (bf16
    or fp32, contiguous) → [B,H,W,C], plus `residual` when given."""
    _check_inputs(q, k, v, rel_h, rel_w, residual, block_size, halo_size, num_heads)
    b, h, w, c = q.shape
    rh = rel_h.to(device=q.device, dtype=torch.float32).contiguous()
    rw = rel_w.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    hd = c // num_heads
    scale = float(np.float32(hd) ** np.float32(-0.5))
    lib = _build.lib()
    err = lib.pht_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        b, h, w, c, block_size, halo_size, num_heads,
        int(q.dtype == torch.bfloat16), ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    block_halo_attention_cuda.launches += 1
    _build.check(err, "block_halo_attention_cuda")
    return out


block_halo_attention_cuda.launches = 0

"""Wrappers of the block-halo attention CUDA kernels: forward K1
(`csrc/attention_fwd.cu`) and backward K4 (`csrc/attention_bwd.cu`).

K1 replaces the TPU kernel `pixel_heal_thyself_tpu/ops/attention_pallas.py:217`
(`_fwd_kernel`), K4 the TPU kernel `:383` (`_bwd_kernel`) and the
attention stage of `ops/block_mega.py:662`. Semantics and rounding order
are those of the plain `ops.attention.block_halo_attention_torch` and
`block_halo_attention_bwd_torch`, which the CPU tests hold against the JAX
package and `chip_smoke.py` holds these kernels against on the card. Both
run every 1 ≤ halo ≤ block in bf16 and fp32: where a window's one-stage
shared-memory plan does not fit, the kernels walk the keys in chunks.
`block_halo_attention_cuda.launches` / `block_halo_attention_bwd_cuda.
launches` count the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch import _build

# windows per first-level group of K4's bias-gradient reduction
_BIAS_GROUP = 16


def _check_inputs(q, tensors, rel_h, rel_w, block_size, halo_size, num_heads, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {q.dtype} (bf16 or fp32)")
    b, h, w, c = q.shape
    for t in [q, *tensors]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: q, k, v (do, residual) must share shape, dtype, device")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous NHWC tensors")
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


def _f32(r: torch.Tensor, device) -> torch.Tensor:
    return r.to(device=device, dtype=torch.float32).contiguous()


def _scale(head_ch: int) -> ctypes.c_float:
    return ctypes.c_float(float(np.float32(head_ch) ** np.float32(-0.5)))


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
    _build.refuse_autograd("block_halo_attention_cuda", q, k, v, rel_h, rel_w, residual)
    _check_inputs(q, [k, v] + ([residual] if residual is not None else []), rel_h, rel_w,
                  block_size, halo_size, num_heads, "block_halo_attention_cuda")
    b, h, w, c = q.shape
    rh, rw = _f32(rel_h, q.device), _f32(rel_w, q.device)
    out = torch.empty_like(q)
    err = _build.lib().pht_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        b, h, w, c, block_size, halo_size, num_heads,
        int(q.dtype == torch.bfloat16), _scale(c // num_heads),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    block_halo_attention_cuda.launches += 1
    _build.check(err, "block_halo_attention_cuda")
    return out


block_halo_attention_cuda.launches = 0


def block_halo_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    do: torch.Tensor,
    *,
    block_size: int,
    halo_size: int,
    num_heads: int,
) -> tuple[torch.Tensor, ...]:
    """Launch K4: (dq, dk, dv) in q's dtype and f32 (drel_h, drel_w).

    Scratch: f32 per-window dk/dv partials [windows, window², C] (2 × 411
    MB at the prod shape 8 × 128² × 256) and the bias-gradient groups."""
    _build.refuse_autograd("block_halo_attention_bwd_cuda", q, k, v, rel_h, rel_w, do)
    _check_inputs(q, [k, v, do], rel_h, rel_w, block_size, halo_size, num_heads,
                  "block_halo_attention_bwd_cuda")
    b, h, w, c = q.shape
    hd = c // num_heads
    window = block_size + 2 * halo_size
    nk = window * window
    nwin = b * (h // block_size) * (w // block_size)
    ngroups = -(-nwin // _BIAS_GROUP)
    dev = q.device
    rh, rw = _f32(rel_h, dev), _f32(rel_w, dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dk_part = torch.empty(nwin, nk, c, dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    bias_part = torch.empty(ngroups, nk, hd, dtype=torch.float32, device=dev)
    dbias = torch.empty(window, window, hd, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.lib()
    err = lib.pht_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), bias_part.data_ptr(), _BIAS_GROUP,
        b, h, w, c, block_size, halo_size, num_heads,
        int(q.dtype == torch.bfloat16), _scale(hd), stream,
    )
    block_halo_attention_bwd_cuda.launches += 1
    _build.check(err, "block_halo_attention_bwd_cuda")
    _build.check(lib.pht_sum_splits(bias_part.data_ptr(), dbias.data_ptr(), nk * hd,
                                    ngroups, stream), "block_halo_attention_bwd_cuda")
    # rel-pos bias gradients: the same unpack as the TPU wrapper
    # (attention_pallas.py:633-637)
    half = hd // 2
    return dq, dk, dv, dbias[..., :half].sum(1), dbias[..., half:].sum(0)


block_halo_attention_bwd_cuda.launches = 0

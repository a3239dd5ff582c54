"""Wrapper of the fused Mamba2-chain forward kernel K7 (`csrc/ssd_fwd.cu`).

K7 replaces the TPU kernel `pixel_heal_thyself_tpu/ops/ssd_mega.py:256`
(`_fwd_kernel_infer`). It runs as five launches on the current stream
(prologue, chunk states, state pass, chunk outputs, gated RMSNorm; design
in the source's header) with f32 scratch allocated here: at the prod
serving shape (8 × 16,384 tokens, d_inner 1024, d_state 64) 1.4 GB. The
plain version is `ops.ssd_mega.fused_mamba_chain_torch`.
`fused_mamba_chain_cuda.launches` counts the calls that launched.

Beyond `supports_shapes`, the card limits a chunk's shared memory to one
CTA's 227 KB: the C entry refuses a larger one (d_state 128 at headdim 64
and chunk 128, which no config uses) with cudaErrorInvalidValue before it
launches anything, and `_build.check` raises.
"""

from __future__ import annotations

import torch

from pixel_heal_thyself_tpu_torch import _build


def fused_mamba_chain_cuda(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> torch.Tensor:
    """Launch K7: zxbcdt [b, l, 2·d_inner + 2·d_state + h] (bf16 or fp32,
    contiguous, on a CUDA device) → [b, l, d_inner] in its dtype."""
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import chain_dims, supports_shapes

    _build.refuse_autograd("fused_mamba_chain_cuda", zxbcdt, conv_w, conv_b, dt_bias, A, D,
                           norm_w)
    if zxbcdt.device.type != "cuda":
        raise ValueError(f"fused_mamba_chain_cuda needs a CUDA tensor, got {zxbcdt.device}")
    if zxbcdt.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_mamba_chain_cuda: dtype {zxbcdt.dtype} (bf16 or fp32)")
    if not zxbcdt.is_contiguous():
        raise ValueError("fused_mamba_chain_cuda needs a contiguous zxbcdt")
    b, l, k, dc, h = chain_dims(zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim)
    if not supports_shapes(l, d_inner, 1, d_state, headdim, k, chunk):
        raise ValueError(f"fused_mamba_chain_cuda: unsupported shape l={l}, d_inner={d_inner}, "
                         f"d_state={d_state}, headdim={headdim}, d_conv={k}, chunk={chunk}")
    dev = zxbcdt.device
    f32 = dict(dtype=torch.float32, device=dev)
    params = [t.to(**f32).contiguous() for t in (conv_w, conv_b, dt_bias, A, D, norm_w)]
    xbc = torch.empty(b, l, dc, **f32)
    dt = torch.empty(b, l, h, **f32)
    cum = torch.empty(b, l, h, **f32)
    states = torch.empty(b, l // chunk, h, d_state, headdim, **f32)
    y = torch.empty(b, l, d_inner, **f32)
    out = torch.empty(b, l, d_inner, dtype=zxbcdt.dtype, device=dev)
    err = _build.lib().pht_ssd_chain_fwd(
        zxbcdt.data_ptr(), *(t.data_ptr() for t in params),
        xbc.data_ptr(), dt.data_ptr(), cum.data_ptr(), states.data_ptr(), y.data_ptr(),
        out.data_ptr(), b, l, d_inner, d_state, h, k, chunk,
        int(zxbcdt.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "fused_mamba_chain_cuda")
    fused_mamba_chain_cuda.launches += 1
    return out


fused_mamba_chain_cuda.launches = 0

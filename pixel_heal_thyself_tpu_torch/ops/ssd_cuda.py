"""Wrapper of the chunked SSD scan kernel K11 (`csrc/ssd_scan.cu`).

K11 replaces the TPU kernel `pixel_heal_thyself_tpu/ops/ssd.py:324`
(`_ssd_fwd_kernel`, the forward-only `ssd_pallas`), with the preparation
around its call and the D skip: four launches (the dt·A cumsum, chunk
states, a state pass that rounds the carried state to the input dtype after
every chunk, chunk outputs; design in the source's header) with f32
scratch allocated here, 272 MB at 8 × 16,384 tokens, 16 heads of 64,
d_state 64. The plain version is `ops.ssd.ssd_pallas_torch`.
`ssd_pallas_cuda.launches` counts the calls that launched.

Beyond the shapes checked here, a chunk must fit one CTA's 227 KB of shared
memory: the C entry refuses a larger one (cudaErrorInvalidValue, before it
launches anything) and `_build.check` raises.
"""

from __future__ import annotations

import torch

from pixel_heal_thyself_tpu_torch import _build


def ssd_pallas_cuda(x, dt, A, B, C, D=None, chunk: int = 128) -> torch.Tensor:
    """Launch K11: x [b, l, h, p] (bf16 or fp32, on a CUDA device), dt
    [b, l, h], A [h], B, C [b, l, 1, d_state] in x's dtype, D [h] or None;
    l a multiple of `chunk` → y [b, l, h, p] in x's dtype."""
    what = "ssd_pallas_cuda"
    _build.refuse_autograd(what, x, dt, A, B, C, D)
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    dtype = x.dtype
    if dtype not in (torch.bfloat16, torch.float32) or B.dtype != dtype or C.dtype != dtype:
        raise TypeError(f"{what}: x {dtype}, B {B.dtype}, C {C.dtype} (one of bf16, fp32)")
    if dt.dtype not in (torch.bfloat16, torch.float32) or A.dtype not in (torch.bfloat16,
                                                                          torch.float32):
        raise TypeError(f"{what}: dt {dt.dtype}, A {A.dtype} (bf16 or fp32)")
    b, l, h, p = x.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, l, 1, n) or tuple(C.shape) != (b, l, 1, n)
            or (D is not None and tuple(D.shape) != (h,))
            or l == 0 or l % chunk or chunk % 4 or n % 4 or p % 4):
        raise ValueError(f"{what}: unsupported shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
                         f"chunk {chunk}")
    dev = x.device
    # dt·A is formed in bf16 when both are bf16 (type promotion), then cast
    round_dA = torch.promote_types(dt.dtype, A.dtype) == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=dev)
    dt32, A32 = dt.float().contiguous(), A.float().contiguous()
    D32 = None if D is None else D.to(dtype).float().contiguous()
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    cum = torch.empty(b, l, h, **f32)
    states = torch.empty(b, l // chunk, h, n, p, **f32)
    y = torch.empty_like(x)
    err = _build.lib().pht_ssd_scan_fwd(
        x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if D32 is None else D32.data_ptr(), cum.data_ptr(), states.data_ptr(), y.data_ptr(),
        b, l, h, p, n, chunk, int(round_dA), int(dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, what)
    ssd_pallas_cuda.launches += 1
    return y


ssd_pallas_cuda.launches = 0

"""Wrapper of the chunked SSD scan kernel K11 (`csrc/ssd_scan.cu`).

K11 replaces the TPU kernel `pixel_heal_thyself_tpu/ops/ssd.py:324`
(`_ssd_fwd_kernel`, the forward-only `ssd_pallas`), with the preparation
around its call and the D skip. The plain version is
`ops.ssd.ssd_pallas_torch`. Two bodies (design in the source's header):

- "tc", the tensor-core body, for bf16 at the shapes of `ssd_scan_body`
  (the prod shape: 8 × 16,384 tokens, 16 heads of 64, d_state 64, chunk
  128): three launches (the cumsum, the chunk states with their carry, the
  chunk outputs) on mma.sync bf16, with 25 MB of f32 cumsums and 134 MB of
  bf16 entering states as scratch at the prod shape;
- "general", the scalar-FMA body, for fp32 and every other shape: four
  launches with 272 MB of f32 scratch at that shape.

The wrapper picks the body by `ssd_scan_body` and names it to the C entry,
which refuses a shape the named body does not take (the library's
`pht_ssd_scan_body` states the same rule; a card test holds the two
equal). `ssd_pallas_cuda.launches` counts the calls that launched and
`.body_launches` each body's.

Beyond the shapes checked here, a general-body chunk must fit one CTA's
227 KB of shared memory: the C entry refuses a larger one
(cudaErrorInvalidValue, before it launches anything) and `_build.check`
raises.
"""

from __future__ import annotations

import torch

from pixel_heal_thyself_tpu_torch import _build

SKEW = 8  # bf16 elements appended to every shared row of the tc body
RING = 5  # stages of the tc chunk-state kernel's copy ring


def ssd_scan_body(dtype: torch.dtype, d_state: int, headdim: int, chunk: int,
                  aligned: bool = True) -> str:
    """The body K11 takes: "tc" (tensor cores) for bf16 with chunk, d_state
    and headdim multiples of 16 up to 128, 64 and 64 and 16-byte aligned
    tensors (csrc/ssd_scan.cu `scan_tc_body`); "general" otherwise."""
    tc = (dtype == torch.bfloat16 and aligned and chunk % 16 == 0 and 16 <= chunk <= 128
          and d_state % 16 == 0 and 16 <= d_state <= 64 and headdim % 16 == 0
          and 16 <= headdim <= 64)
    return "tc" if tc else "general"


def ssd_scan_tc_smem(d_state: int, headdim: int, chunk: int) -> dict:
    """Dynamic shared memory (bytes) of one CTA of the tc body's chunk-state
    and chunk-output kernels, as `csrc/ssd_scan.cu` lays it out
    (`pht_ssd_scan_tc_smem`): the chunk state's ring of x, B and the
    per-token vectors; the chunk output's C, xdt (or B), two heads' x and
    states, the scores' causal tiles and two heads' vectors."""
    q, n, p = chunk, d_state, headdim
    ln, lp, tiles = n + SKEW, p + SKEW, (q // 16) * (q // 16 + 1) // 2
    return {"state": RING * (2 * q * lp + 2 * q * ln + 12 * q),
            "output": 2 * (q * ln + q * max(ln, lp) + 2 * q * lp + 2 * n * lp) + 512 * tiles
            + 16 * q}


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
    y = torch.empty_like(x)
    body = ssd_scan_body(dtype, n, p, chunk, all(t.data_ptr() % 16 == 0 for t in (x, B, C)))
    if body == "tc":  # cum, round(dt), decay to the end chunk-major; the states in bf16
        cum = torch.empty(b, l // chunk, h, 3 * chunk, **f32)
        states = torch.empty(b, l // chunk, h, n, p, dtype=dtype, device=dev)
    else:
        cum = torch.empty(b, l, h, **f32)
        states = torch.empty(b, l // chunk, h, n, p, **f32)
    err = _build.lib().pht_ssd_scan_fwd(
        x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if D32 is None else D32.data_ptr(), cum.data_ptr(), states.data_ptr(), y.data_ptr(),
        b, l, h, p, n, chunk, int(round_dA), int(dtype == torch.bfloat16), int(body == "tc"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, what)
    ssd_pallas_cuda.launches += 1
    ssd_pallas_cuda.body_launches[body] += 1
    return y


ssd_pallas_cuda.launches = 0
ssd_pallas_cuda.body_launches = {"tc": 0, "general": 0}

"""Mamba2 SSD (state-space dual) scan, plain PyTorch.

Port of `pixel_heal_thyself_tpu/ops/ssd.py`: `ssd_naive` (:36, the
time-step oracle) and `ssd_chunked` (:221, the chunked matmul form that
the literal Mamba2 layer runs). Semantics, with scalar-per-head decay:

    state_t = exp(dt_t·A_h)·state_{t-1} + dt_t·(B_t ⊗ x_t)
    y_t     = C_t · state_t + D_h·x_t

`ssd_chunked` rounds to the input dtype at the points where the JAX
function does (its contractions accumulate in f32, `preferred_element_type`):
in float32 every cast is the identity. The sequence-sharded entry points
(`initial_state`, `ssd_sharded`) wait for the multi-GPU slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[b, l, g, n] → [b, l, h, n], each group broadcast over its heads."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


def ssd_naive(x, dt, A, B, C, D=None):
    """Time-step scan. x: [b, l, h, p], dt: [b, l, h], A: [h], B, C:
    [b, l, g, n] (h % g == 0). Returns [b, l, h, p] in x's dtype."""
    b, l, h, p = x.shape
    Bh, Ch = _heads(B, h), _heads(C, h)
    dA = torch.exp(dt * A[None, None, :])
    xdt = x * dt[..., None]
    state = x.new_zeros(b, h, B.shape[3], p)
    ys = []
    for t in range(l):
        state = dA[:, t, :, None, None] * state + Bh[:, t, :, :, None] * xdt[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y


def _mm(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation (JAX `preferred_element_type=f32`)."""
    return torch.einsum(eq, *(o.float() for o in ops))


def ssd_chunked(x, dt, A, B, C, D=None, chunk: int = 128):
    """Chunked matmul-form SSD; same signature and semantics as
    `ssd_naive`. Intra-chunk attention-like products with a causal decay
    mask, the inter-chunk state carried by a short loop over per-chunk
    summaries (`_ssd_stacks` / `_ssd_carry` / `_ssd_outputs` of the JAX
    function, with every chunk in one batch)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    dtype = x.dtype
    q = min(chunk, l)
    pad = (-l) % q
    if pad:  # padded tokens have dt = 0: decay 1, no state increment
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (l + pad) // q

    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)
    xc = x.reshape(b, nc, q, g, rep, p)
    dtc = dt.reshape(b, nc, q, g, rep)
    dA = (dtc * A.reshape(g, rep)).float()
    cum = torch.cumsum(dA, dim=2)                           # [b,nc,q,g,rep] f32
    xdt = xc * dtc[..., None].to(dtype)
    decay_to_end = torch.exp(cum[:, :, -1:] - cum).to(dtype)
    S = _mm("bcjgn,bcjgrp->bcgrnp", Bc, xdt * decay_to_end[..., None]).to(dtype)
    a = torch.exp(cum[:, :, -1]).to(dtype)                   # [b,nc,g,rep]

    state = torch.zeros_like(S[:, 0])
    st_in = []
    for c in range(nc):
        st_in.append(state)
        state = a[:, c, ..., None, None] * state + S[:, c]
    st = torch.stack(st_in, dim=1)                           # [b,nc,g,rep,n,p]

    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    cumT = cum.permute(0, 1, 3, 4, 2)                        # [b,nc,g,rep,q]
    diff = cumT[..., :, None] - cumT[..., None, :]
    lmask = torch.exp(diff.masked_fill(~causal, float("-inf"))).to(dtype)
    scores = _mm("bcign,bcjgn->bcgij", Cc, Bc).to(dtype)
    y = _mm("bcgrij,bcjgrp->bcigrp", scores[:, :, :, None] * lmask, xdt).to(dtype)
    in_decay = torch.exp(cum).to(dtype)                      # [b,nc,q,g,rep]
    y = y + in_decay[..., None] * _mm("bcign,bcgrnp->bcigrp", Cc, st).to(dtype)
    y = y.reshape(b, nc * q, h, p)[:, :l]
    if D is not None:
        y = y + x[:, :l] * D[None, None, :, None].to(dtype)
    return y

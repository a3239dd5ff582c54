"""The fused Mamba2 layer interior (PyTorch port of `ops/ssd_mega.py`).

`fused_mamba_chain(zxbcdt, ...)` computes RMSNormGated(SSD(silu(conv1d(
xBC)), softplus(dt + dt_bias), A, D), z): everything of a Mamba2 layer
between in_proj and out_proj, through `ops/library.py` (under
`torch.export` the op `pht::fused_mamba_chain`). For a CUDA tensor it
launches the kernel K7
(`ops/ssd_mega_cuda.py`, `csrc/ssd_fwd.cu`), the port of the TPU kernel
`pixel_heal_thyself_tpu/ops/ssd_mega.py:256` (`_fwd_kernel_infer`); for a
CPU tensor it runs `fused_mamba_chain_torch`, the plain version that the
CPU tests hold against the JAX function in interpret mode and
`chip_smoke.py` holds the kernel against on the card.

The plain version follows the TPU kernel's `_chunk_core` / `_fwd_body`
(:114-249): f32 inside, one rounding to the compute dtype at the output,
the conv taps added in the kernel's order, the state carried from chunk
to chunk. Its chunks run as one batch; only the state carry loops.

Gradients go through `MambaChainFn`, the port of the TPU custom VJP
(:569-619): its forward is the emit variant (TPU `_fwd_kernel_train`,
:252), which also returns the state entering each chunk rounded to the
input dtype; its backward is `fused_mamba_chain_bwd_torch`, the plain
version of the TPU `_bwd_kernel` (:260-406), or on the card the kernel K8
(`csrc/ssd_bwd.cu`). The raw dispatchers refuse inputs that require grad
in grad mode: their outputs would have no `grad_fn`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.ops import library
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
    fused_mamba_chain_bwd_cuda,
    fused_mamba_chain_emit_cuda,
)

_EPS = 1e-5  # RMSNormGated eps
_TAIL = 8    # the TPU kernel's carried conv rows: d_conv ≤ _TAIL + 1


def supports_shapes(
    l: int, d_inner: int, ngroups: int, d_state: int, headdim: int,
    d_conv: int, chunk: int,
) -> bool:
    """The JAX gate (`ops/ssd_mega.py:52`): callers take the literal
    chain otherwise. On the card the kernel also needs a chunk's staging
    to fit one CTA's 227 KB of shared memory; a shape this gate admits but
    that does not fit (d_state 128 at headdim 64 and chunk 128; no config
    has one) raises there (`ops/ssd_mega_cuda.py`)."""
    return (
        ngroups == 1
        and d_conv <= _TAIL + 1
        and l % chunk == 0
        and l >= chunk
        and chunk % 8 == 0
        and d_inner % 128 == 0
        and headdim in (8, 16, 32, 64, 128)
        and d_state % 8 == 0
    )


def chain_dims(zxbcdt, conv_w, dt_bias, d_inner: int, d_state: int, headdim: int) -> tuple:
    """(b, l, k, dc, h), checking the layout `zxbcdt = [z | xBC | dt]`."""
    b, l, width = zxbcdt.shape
    k, dc = conv_w.shape
    h = dt_bias.shape[0]
    if dc != d_inner + 2 * d_state or width != 2 * d_inner + 2 * d_state + h:
        raise ValueError(f"zxbcdt width {width} / conv width {dc} do not match "
                         f"d_inner={d_inner}, d_state={d_state}, heads={h}")
    if h * headdim != d_inner:
        raise ValueError(f"{h} heads × headdim {headdim} != d_inner {d_inner}")
    return b, l, k, dc, h


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def dsilu(x: torch.Tensor) -> torch.Tensor:
    """d silu(x) / dx = s·(1 + x·(1 − s)), s = sigmoid(x)."""
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def chain_conv(zx, conv_w, conv_b, d_inner: int) -> torch.Tensor:
    """The causal depthwise conv of xBC in f32 `zx` [b, l, width], bias
    added: the pre-activation [b, l, dc]. Tap k-1 first, then the older
    taps, then the bias, as the TPU kernel."""
    l = zx.shape[1]
    k, dc = conv_w.shape
    xr = zx[..., d_inner:d_inner + dc]
    wb = conv_w.float()
    xp = F.pad(xr, (0, 0, k - 1, 0))
    pre = xr * wb[k - 1]
    for j in range(k - 1):
        pre = pre + xp[:, j:j + l] * wb[j]
    return pre + conv_b.float()


def chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner: int, chunk: int) -> tuple:
    """The chain's first stage on f32 `zx` [b, l, width]: xBC = silu(causal
    conv) [b, l, dc], dt = softplus(dt + dt_bias) and its in-chunk cumsum
    of dt·A, both [b, l/chunk, chunk, h]."""
    b, l, _ = zx.shape
    dc = conv_w.shape[1]
    h = dt_bias.shape[0]
    xbc = F.silu(chain_conv(zx, conv_w, conv_b, d_inner))
    dt = softplus(zx[..., d_inner + dc:] + dt_bias.float()).reshape(b, l // chunk, chunk, h)
    return xbc, dt, torch.cumsum(dt * A.float(), dim=2)


def _chunk_views(xbc, dt, d_inner: int, d_state: int, headdim: int) -> tuple:
    """x [b,nc,q,h,p], B and C [b,nc,q,n] of the f32 xBC, and the causal
    mask [q, q]."""
    b, nc, q, h = dt.shape
    di, n = d_inner, d_state
    x = xbc[..., :di].reshape(b, nc, q, h, headdim)
    Bc = xbc[..., di:di + n].reshape(b, nc, q, n)
    Cc = xbc[..., di + n:].reshape(b, nc, q, n)
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xbc.device))
    return x, Bc, Cc, causal


def _decay_mask(cum, causal) -> torch.Tensor:
    """exp(cum_t − cum_j) for j ≤ t, else 0: [b, nc, h, t, j]."""
    cumT = cum.transpose(2, 3)                                       # [b,nc,h,q]
    diff = cumT[..., :, None] - cumT[..., None, :]
    return torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)


def chain_scan(xbc, dt, cum, D, d_inner: int, d_state: int, headdim: int,
               states=None) -> tuple:
    """The chunked SSD scan plus the D skip: (f32 y [b, l, d_inner], the
    state entering each chunk [b, nc, h, n, p]). Without `states` the state
    is carried from chunk to chunk (f32); with them (the emit variant's
    saved states, as the backward recomputes) each chunk reads its own."""
    b, nc, q, h = dt.shape
    x, Bc, Cc, causal = _chunk_views(xbc, dt, d_inner, d_state, headdim)
    xdt = x * dt[..., None]
    w3 = (Cc @ Bc.transpose(-1, -2))[:, :, None] * _decay_mask(cum, causal)
    y = torch.einsum("bchtj,bcjhp->bcthp", w3, xdt)
    del w3

    if states is None:
        cum_last = cum[:, :, -1:]                                    # [b,nc,1,h]
        S = torch.einsum("bcjn,bcjhp->bchnp", Bc, xdt * torch.exp(cum_last - cum)[..., None])
        a = torch.exp(cum_last[:, :, 0])[..., None, None]            # [b,nc,h,1,1]
        state = torch.zeros_like(S[:, 0])
        st_in = []
        for c in range(nc):
            st_in.append(state)
            state = a[:, c] * state + S[:, c]
        states = torch.stack(st_in, dim=1)                           # [b,nc,h,n,p]
    st = states.float()
    y = y + torch.exp(cum)[..., None] * torch.einsum("bctn,bchnp->bcthp", Cc, st)
    y = y + x * D.float()[:, None]
    return y.reshape(b, nc * q, d_inner), states


def chain_norm(y, z, norm_w, dtype: torch.dtype) -> torch.Tensor:
    """The gated RMSNorm of f32 `y` by f32 `z`, rounded once to `dtype`."""
    g = y * F.silu(z)
    rstd = torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + _EPS)
    return (g * rstd * norm_w.float()).to(dtype)


def fused_mamba_chain_torch(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128, emit: bool = False,
):
    """Plain PyTorch version of the fused chain: zxbcdt [b, l, 2·d_inner +
    2·d_state + h] → [b, l, d_inner] in zxbcdt's dtype, in the kernel's
    three stages: prologue, scan, gated norm. `emit` also returns the state
    entering each chunk, [b, l/chunk, h, d_state, headdim] rounded to
    zxbcdt's dtype as the TPU kernel stores it (`ssd_mega.py:228-231`)."""
    l = chain_dims(zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim)[1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    zx = zxbcdt.float()
    xbc, dt, cum = chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    y, states = chain_scan(xbc, dt, cum, D, d_inner, d_state, headdim)
    out = chain_norm(y, zx[..., :d_inner], norm_w, zxbcdt.dtype)
    return (out, states.to(zxbcdt.dtype)) if emit else out


# ---- the backward (TPU `_bwd_kernel`, ssd_mega.py:260-406), in stages ------

def chain_norm_bwd(y, z, norm_w, dy) -> tuple:
    """Backward of the gated norm at f32 y, z, dy: (dy_ssd, dz, dnorm_w)."""
    sz = F.silu(z)
    g = y * sz
    rstd = torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + _EPS)
    dyw = dy * norm_w.float()
    dnw = (dy * g * rstd).sum(dim=(0, 1))
    du = rstd * dyw - g * (rstd**3 / y.shape[-1]) * (dyw * g).sum(dim=-1, keepdim=True)
    return du * sz, du * y * dsilu(z), dnw


def chain_dstate_local(xbc, cum, dy_ssd, d_inner: int, d_state: int, headdim: int):
    """Each chunk's own term of the gradient of the state entering it,
    Cᵀ·(dy_ssd ⊙ exp(cum)): [b, nc, h, n, p] f32."""
    b, nc, q, h = cum.shape
    _, _, Cc, _ = _chunk_views(xbc, cum, d_inner, d_state, headdim)
    dr = dy_ssd.reshape(b, nc, q, h, headdim) * torch.exp(cum)[..., None]
    return torch.einsum("bctn,bcthp->bchnp", Cc, dr)


def chain_reverse_carry(dst_local, cum) -> torch.Tensor:
    """The gradient of the state leaving each chunk, carried from the last
    chunk back: dst_out[c] = dst_local[c+1] + a[c+1]·dst_out[c+1], zero for
    the last chunk (a = exp(cum_last), the chunk's decay)."""
    a = torch.exp(cum[:, :, -1])[..., None, None]                   # [b,nc,h,1,1]
    nc = dst_local.shape[1]
    st = torch.zeros_like(dst_local[:, 0])
    out = [None] * nc
    for c in range(nc - 1, -1, -1):
        out[c] = st
        st = a[:, c] * st + dst_local[:, c]
    return torch.stack(out, dim=1)


def chain_scan_bwd(xbc, dt, cum, A, D, states, dst_out, dy_ssd,
                   d_inner: int, d_state: int, headdim: int) -> tuple:
    """Backward of `chain_scan` at the saved entering `states`, given the
    gradient of each chunk's leaving state `dst_out`: (dxBC [b, l, dc]
    (post-SiLU), ddt [b, l, h] (post-softplus), dA [h], dD [h]), all f32.
    Follows `_bwd_kernel` :310-367."""
    b, nc, q, h = dt.shape
    p = headdim
    x, Bc, Cc, causal = _chunk_views(xbc, dt, d_inner, d_state, headdim)
    dys = dy_ssd.reshape(b, nc, q, h, p)
    st = states.float()
    xdt = x * dt[..., None]
    lmask = _decay_mask(cum, causal)                                 # [b,nc,h,t,j]
    w3 = (Cc @ Bc.transpose(-1, -2))[:, :, None] * lmask

    # D skip: y3 = x ⊙ D
    dD = (dys * x).sum(dim=(0, 1, 2, 4))
    dx = dys * D.float()[:, None]
    # readout y2 = exp(cum) ⊙ (C · st_in)
    e = torch.exp(cum)[..., None]
    dr = dys * e
    dcum = (dys * e * torch.einsum("bctn,bchnp->bcthp", Cc, st)).sum(-1)    # [b,nc,q,h]
    dC = torch.einsum("bcthp,bchnp->bctn", dr, st)
    # intra-chunk: y1[t] = Σ_j w3[t, j] xdt[j]
    dw3 = torch.einsum("bcthp,bcjhp->bchtj", dys, xdt)
    dxdt = torch.einsum("bchtj,bcthp->bcjhp", w3, dys)
    ds = (dw3 * lmask).sum(dim=2)                                    # [b,nc,t,j]
    ddiff = dw3 * w3
    dcumT = ddiff.sum(-1) - ddiff.sum(-2)                            # [b,nc,h,q]
    del dw3, w3, lmask, ddiff
    # state update: st_out = a ⊙ st_in + Bᵀ (xdt ⊙ d2), d2 = exp(cum_last − cum)
    cum_last = cum[:, :, -1]                                         # [b,nc,h]
    dcum_last = (dst_out * st).sum(dim=(-1, -2)) * torch.exp(cum_last)
    d2 = torch.exp(cum_last[:, :, None] - cum)[..., None]
    xdt_s = xdt * d2
    dB = torch.einsum("bcjhp,bchnp->bcjn", xdt_s, dst_out)
    dxdt_s = torch.einsum("bcjn,bchnp->bcjhp", Bc, dst_out)
    dxdt = dxdt + dxdt_s * d2
    dd2 = (dxdt_s * xdt_s).sum(-1)                                   # [b,nc,q,h]
    dcum = dcum - dd2 + dcumT.transpose(2, 3)
    dcum_last = dcum_last + dd2.sum(dim=2)
    # scores = C · Bᵀ
    dC = dC + ds @ Bc
    dB = dB + ds.transpose(-1, -2) @ Cc
    # cum = in-chunk cumsum of dA, cum_last = its sum → reverse cumsum
    ddA = dcum.flip(2).cumsum(2).flip(2) + dcum_last[:, :, None]
    ddt = ddA * A.float() + (dxdt * x).sum(-1)
    dA = (ddA * dt).sum(dim=(0, 1, 2))
    dx = dx + dxdt * dt[..., None]
    l = nc * q
    dxbc = torch.cat([dx.reshape(b, l, d_inner), dB.reshape(b, l, -1), dC.reshape(b, l, -1)],
                     dim=-1)
    return dxbc, ddt.reshape(b, l, h), dA, dD


def chain_prologue_bwd(zx, conv_w, conv_b, dt_bias, dxbc, ddt, d_inner: int) -> tuple:
    """Backward of `chain_prologue`: (dxBC_raw [b, l, dc], dconv_w [k, dc],
    dconv_b [dc], ddt_raw [b, l, h], ddt_bias [h]), all f32. The conv
    transpose reads rows past the chunk (zeros past the sequence end), the
    tap sums rows before it (zeros before the start). `_bwd_kernel`
    :365-401."""
    l = zx.shape[1]
    k, dc = conv_w.shape
    wb = conv_w.float()
    dpre = dxbc * dsilu(chain_conv(zx, conv_w, conv_b, d_inner))
    dp = F.pad(dpre, (0, 0, 0, k - 1))
    dxr = dpre * wb[k - 1]
    for j in range(k - 1):
        s = k - 1 - j
        dxr = dxr + dp[:, s:s + l] * wb[j]
    xp = F.pad(zx[..., d_inner:d_inner + dc], (0, 0, k - 1, 0))
    dw = torch.stack([(dpre * xp[:, j:j + l]).sum(dim=(0, 1)) for j in range(k)])
    ddtr = ddt * torch.sigmoid(zx[..., d_inner + dc:] + dt_bias.float())
    return dxr, dw, dpre.sum(dim=(0, 1)), ddtr, ddtr.sum(dim=(0, 1))


def fused_mamba_chain_bwd_torch(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, states, dy,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> tuple:
    """Plain PyTorch version of the fused chain's VJP (TPU #6) at the
    emitted entering `states`: (dzx [b, l, width] in zxbcdt's dtype,
    dconv_w, dconv_b, ddt_bias, dA, dD, dnorm_w in their parameters'
    dtypes, from f32 sums). Every intermediate is f32; chunks run as one
    batch and only the reverse carry of the state gradient loops."""
    chain_dims(zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim)
    zx = zxbcdt.float()
    dyf = dy.to(zxbcdt.dtype).float()
    xbc, dt, cum = chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    y, _ = chain_scan(xbc, dt, cum, D, d_inner, d_state, headdim, states=states)
    dy_ssd, dz, dnw = chain_norm_bwd(y, zx[..., :d_inner], norm_w, dyf)
    del y
    dst_out = chain_reverse_carry(
        chain_dstate_local(xbc, cum, dy_ssd, d_inner, d_state, headdim), cum)
    dxbc, ddt, dA, dD = chain_scan_bwd(xbc, dt, cum, A, D, states, dst_out, dy_ssd,
                                       d_inner, d_state, headdim)
    dxr, dw, db, ddtr, dbias = chain_prologue_bwd(zx, conv_w, conv_b, dt_bias, dxbc, ddt,
                                                  d_inner)
    dzx = torch.cat([dz, dxr, ddtr], dim=-1).to(zxbcdt.dtype)
    return (dzx, dw.to(conv_w.dtype), db.to(conv_b.dtype), dbias.to(dt_bias.dtype),
            dA.to(A.dtype), dD.to(D.dtype), dnw.to(norm_w.dtype))


def fused_mamba_chain(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> torch.Tensor:
    """Through `ops/library.py` (under `torch.export` the op
    `pht::fused_mamba_chain`): the kernel for a CUDA `zxbcdt` (it launches
    or raises), the plain version for a CPU one; inputs that require grad
    in grad mode are refused either way."""
    return library.fused_mamba_chain(zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, d_inner,
                                     d_state, headdim, chunk)


def fused_mamba_chain_emit(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> tuple:
    """The emit variant (TPU `_fwd_kernel_train`): (out, the state entering
    each chunk in zxbcdt's dtype), through K7 for a CUDA `zxbcdt` and the
    plain version for a CPU one."""
    return _build.dispatch(
        "fused_mamba_chain_emit", zxbcdt, fused_mamba_chain_emit_cuda,
        partial(fused_mamba_chain_torch, emit=True), zxbcdt, conv_w, conv_b, dt_bias, A, D,
        norm_w, d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk,
    )


def fused_mamba_chain_bwd(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, states, dy,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> tuple:
    """The chain's VJP: K8 for a CUDA `zxbcdt`, the plain version for a CPU
    one."""
    return _build.dispatch(
        "fused_mamba_chain_bwd", zxbcdt, fused_mamba_chain_bwd_cuda,
        fused_mamba_chain_bwd_torch, zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, states, dy,
        d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk,
    )


class MambaChainConfig(NamedTuple):
    d_inner: int
    d_state: int
    headdim: int
    chunk: int
    use_kernels: bool  # False: the plain pair on any device


class MambaChainFn(torch.autograd.Function):
    """The differentiable fused chain (port of the TPU custom VJP,
    `ops/ssd_mega.py:569-619`).

    `apply(cfg, zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w)` → [b, l,
    d_inner] in zxbcdt's dtype. The forward runs the emit variant and saves
    zxbcdt, the parameters and the entering states (b·l/chunk·d_state·
    d_inner values in zxbcdt's dtype: 134 MB per layer at 8 × 16,384 tokens
    of d_inner 1024, d_state 64, bf16); the backward recomputes the rest.
    Deterministic, so `torch.utils.checkpoint` may recompute it.
    First-order only."""

    @staticmethod
    def forward(ctx, cfg: MambaChainConfig, zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w):
        dims = dict(d_inner=cfg.d_inner, d_state=cfg.d_state, headdim=cfg.headdim,
                    chunk=cfg.chunk)
        params = (conv_w, conv_b, dt_bias, A, D, norm_w)
        if cfg.use_kernels:
            out, states = fused_mamba_chain_emit(zxbcdt, *params, **dims)
        else:
            out, states = fused_mamba_chain_torch(zxbcdt, *params, **dims, emit=True)
        ctx.cfg, ctx.dims = cfg, dims
        ctx.save_for_backward(zxbcdt, *params, states)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        zxbcdt, *params, states = ctx.saved_tensors
        bwd = fused_mamba_chain_bwd if ctx.cfg.use_kernels else fused_mamba_chain_bwd_torch
        return (None, *bwd(zxbcdt, *params, states, dy.contiguous(), **ctx.dims))

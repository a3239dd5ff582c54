"""The fused Mamba2 layer interior (PyTorch port of `ops/ssd_mega.py`).

`fused_mamba_chain(zxbcdt, ...)` computes RMSNormGated(SSD(silu(conv1d(
xBC)), softplus(dt + dt_bias), A, D), z): everything of a Mamba2 layer
between in_proj and out_proj. For a CUDA tensor it launches the kernel K7
(`ops/ssd_mega_cuda.py`, `csrc/ssd_fwd.cu`), the port of the TPU kernel
`pixel_heal_thyself_tpu/ops/ssd_mega.py:256` (`_fwd_kernel_infer`); for a
CPU tensor it runs `fused_mamba_chain_torch`, the plain version that the
CPU tests hold against the JAX function in interpret mode and
`chip_smoke.py` holds the kernel against on the card.

The plain version follows the TPU kernel's `_chunk_core` / `_fwd_body`
(:114-249): f32 inside, one rounding to the compute dtype at the output,
the conv taps added in the kernel's order, the state carried from chunk
to chunk. Its chunks run as one batch; only the state carry loops.

Forward only: the dispatcher refuses inputs that require grad in grad
mode (the backward kernel, TPU #6, comes with Mamba training).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch import _build
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_cuda

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


def chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner: int, chunk: int) -> tuple:
    """The chain's first stage on f32 `zx` [b, l, width]: xBC = silu(causal
    conv) [b, l, dc], dt = softplus(dt + dt_bias) and its in-chunk cumsum
    of dt·A, both [b, l/chunk, chunk, h]."""
    b, l, _ = zx.shape
    k, dc = conv_w.shape
    h = dt_bias.shape[0]
    xr = zx[..., d_inner:d_inner + dc]
    wb = conv_w.float()
    # causal conv: tap k-1 first, then the older taps, then the bias
    xp = F.pad(xr, (0, 0, k - 1, 0))
    pre = xr * wb[k - 1]
    for j in range(k - 1):
        pre = pre + xp[:, j:j + l] * wb[j]
    xbc = F.silu(pre + conv_b.float())
    dt = softplus(zx[..., d_inner + dc:] + dt_bias.float()).reshape(b, l // chunk, chunk, h)
    return xbc, dt, torch.cumsum(dt * A.float(), dim=2)


def chain_scan(xbc, dt, cum, D, d_inner: int, d_state: int, headdim: int) -> torch.Tensor:
    """The chunked SSD scan with the state carried from chunk to chunk,
    plus the D skip: f32 y [b, l, d_inner]."""
    b, nc, q, h = dt.shape
    di, n, p = d_inner, d_state, headdim
    x = xbc[..., :di].reshape(b, nc, q, h, p)
    Bc = xbc[..., di:di + n].reshape(b, nc, q, n)
    Cc = xbc[..., di + n:].reshape(b, nc, q, n)
    xdt = x * dt[..., None]

    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xbc.device))
    cumT = cum.transpose(2, 3)                                       # [b,nc,h,q]
    diff = cumT[..., :, None] - cumT[..., None, :]                   # [b,nc,h,t,j]
    lmask = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    w3 = (Cc @ Bc.transpose(-1, -2))[:, :, None] * lmask
    y = torch.einsum("bchtj,bcjhp->bcthp", w3, xdt)
    del diff, lmask, w3

    cum_last = cum[:, :, -1:]                                        # [b,nc,1,h]
    S = torch.einsum("bcjn,bcjhp->bchnp", Bc, xdt * torch.exp(cum_last - cum)[..., None])
    a = torch.exp(cum_last[:, :, 0])[..., None, None]                # [b,nc,h,1,1]
    state = torch.zeros_like(S[:, 0])
    st_in = []
    for c in range(nc):
        st_in.append(state)
        state = a[:, c] * state + S[:, c]
    st = torch.stack(st_in, dim=1)                                   # [b,nc,h,n,p]
    y = y + torch.exp(cum)[..., None] * torch.einsum("bctn,bchnp->bcthp", Cc, st)
    y = y + x * D.float()[:, None]
    return y.reshape(b, nc * q, di)


def chain_norm(y, z, norm_w, dtype: torch.dtype) -> torch.Tensor:
    """The gated RMSNorm of f32 `y` by f32 `z`, rounded once to `dtype`."""
    g = y * F.silu(z)
    rstd = torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + _EPS)
    return (g * rstd * norm_w.float()).to(dtype)


def fused_mamba_chain_torch(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of the fused chain: zxbcdt [b, l, 2·d_inner +
    2·d_state + h] → [b, l, d_inner] in zxbcdt's dtype, in the kernel's
    three stages: prologue, scan, gated norm."""
    l = chain_dims(zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim)[1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    zx = zxbcdt.float()
    xbc, dt, cum = chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    y = chain_scan(xbc, dt, cum, D, d_inner, d_state, headdim)
    return chain_norm(y, zx[..., :d_inner], norm_w, zxbcdt.dtype)


def fused_mamba_chain(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> torch.Tensor:
    """The kernel for a CUDA `zxbcdt` (it launches or raises), the plain
    version for a CPU one; inputs that require grad in grad mode are
    refused either way."""
    return _build.dispatch(
        "fused_mamba_chain", zxbcdt, fused_mamba_chain_cuda, fused_mamba_chain_torch,
        zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
        d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk,
    )

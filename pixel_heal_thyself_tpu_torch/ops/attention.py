"""Feature-guided block-local halo self-attention (AFGSA) — plain PyTorch.

Port of `pixel_heal_thyself_tpu/ops/attention.py`: each non-overlapping
`block × block` tile of queries attends to the `(block+2·halo)²` key/value
window centred on it. Keys and values outside the frame are ZERO vectors
that still receive the relative positional bias and take part in the
softmax (the reference's `F.unfold(..., padding=halo)` zero padding) —
they are never masked out. The decomposed relative embedding adds `rel_h`
to the first half of each head's channels and `rel_w` to the second half,
shared across heads.

`block_halo_attention_torch` follows the rounding order of the TPU kernel
(`ops/attention_pallas.py:217` `_fwd_kernel`) that the CUDA kernel
(`ops/attention_cuda.py`) replaces: keys + bias in f32 rounded to the
input dtype, f32 logits scaled by `head_ch**-0.5`, f32 softmax with the
probabilities rounded to the input dtype, f32 P·V rounded once. (The JAX
XLA path scales q in the input dtype instead; in float32 the two agree to
rounding.) Query curve orderings are an exact no-op for attention, which
treats query rows independently; the arguments are accepted and ignored,
as the Pallas path does.

`block_halo_attention_bwd_torch` is the plain backward with the rounding
points of the TPU backward (`ops/attention_pallas.py:383` `_bwd_kernel`)
and its CUDA port K4, except that each key's window gradients are summed
in f32 and rounded once (the TPU kernel adds bf16-rounded window
gradients in bf16).

`block_halo_attention` / `block_halo_attention_bwd` are the dispatching
entry points: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor (the forward through `ops/library.py`, which `torch.export`
keeps as the op `pht::block_halo_attention`). Neither is differentiable
and both refuse inputs that require grad in grad mode; `BlockHaloAttentionFn` is the differentiable op whose
forward and backward run them, and `QKVBlockHaloAttentionFn` the same op
with the q/k/v projections folded in (the `fold_qkv` variant).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pixel_heal_thyself_tpu_torch._build import dispatch
from pixel_heal_thyself_tpu_torch.ops import library
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import block_halo_attention_bwd_cuda


def extract_halo_windows(x: torch.Tensor, block_size: int, halo_size: int) -> torch.Tensor:
    """[B, H, W, C] → [B, hb, wb, window, window, C] overlapping windows at
    stride `block_size`, zero-padded at the frame borders."""
    bs, halo = block_size, halo_size
    if halo > bs:
        raise ValueError("halo_size must be ≤ block_size")
    window = bs + 2 * halo
    xp = F.pad(x, (0, 0, halo, halo, halo, halo))
    wins = xp.unfold(1, window, bs).unfold(2, window, bs)  # [B,hb,wb,C,win,win]
    return wins.permute(0, 1, 2, 4, 5, 3)


def blocks_from_image(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """[B,H,W,C] → [B, hb, wb, block², C] of raster-flattened tiles."""
    b, h, w, c = x.shape
    hb, wb = h // block_size, w // block_size
    x = x.reshape(b, hb, block_size, wb, block_size, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hb, wb, block_size * block_size, c)


def image_from_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Inverse of `blocks_from_image`: [B,hb,wb,block²,C] → [B,H,W,C]."""
    b, hb, wb, _, c = x.shape
    x = x.reshape(b, hb, wb, block_size, block_size, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hb * block_size, wb * block_size, c)


def overlap_add_windows(wins: torch.Tensor, h: int, w: int, block_size: int,
                        halo_size: int) -> torch.Tensor:
    """Inverse gather of `extract_halo_windows`: [B, hb, wb, window, window,
    C] → [B, H, W, C], summing the windows that overlap each pixel and
    dropping values that fall outside the frame."""
    b, hb, wb, window, _, c = wins.shape
    cols = wins.permute(0, 5, 3, 4, 1, 2).reshape(b, c * window * window, hb * wb)
    img = F.fold(cols, (h, w), window, stride=block_size, padding=halo_size)
    return img.permute(0, 2, 3, 1)


def rel_bias(rel_h: torch.Tensor, rel_w: torch.Tensor) -> torch.Tensor:
    """[window, window, head_ch] f32 key bias: row embedding on the first
    half of each head's channels, column embedding on the second."""
    window, half = rel_h.shape
    return torch.cat(
        [
            rel_h.float()[:, None, :].expand(window, window, half),
            rel_w.float()[None, :, :].expand(window, window, half),
        ],
        dim=-1,
    )


def block_halo_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    curve_indices=None,
    inv_curve_indices=None,
    *,
    block_size: int,
    halo_size: int,
    num_heads: int,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """Block-halo attention, plain PyTorch.

    q, k, v: [B, H, W, C] projected feature maps in the compute dtype.
    rel_h, rel_w: [window, head_ch//2]. Returns [B, H, W, C] in q's dtype;
    with `residual`, returns `residual + attention` (both rounded to the
    dtype, the block's first residual)."""
    del curve_indices, inv_curve_indices
    b, h, w, c = q.shape
    bs = block_size
    window = bs + 2 * halo_size
    hd = c // num_heads
    dtype = q.dtype
    hb, wb = h // bs, w // bs
    nq, nk = bs * bs, window * window

    qh = blocks_from_image(q, bs).reshape(b, hb, wb, nq, num_heads, hd)
    qh = qh.permute(0, 1, 2, 4, 3, 5).float()  # [B,hb,wb,heads,nq,hd]

    kw = extract_halo_windows(k, bs, halo_size)
    kw = kw.reshape(b, hb, wb, window, window, num_heads, hd).float()
    kw = (kw + rel_bias(rel_h, rel_w)[:, :, None, :]).to(dtype)
    kh = kw.reshape(b, hb, wb, nk, num_heads, hd).permute(0, 1, 2, 4, 3, 5).float()
    vw = extract_halo_windows(v, bs, halo_size)
    vh = vw.reshape(b, hb, wb, nk, num_heads, hd).permute(0, 1, 2, 4, 3, 5).float()

    scale = torch.tensor(hd, dtype=torch.float32) ** -0.5
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    attn = torch.softmax(logits, dim=-1).to(dtype).float()
    out = torch.matmul(attn, vh).to(dtype)  # [B,hb,wb,heads,nq,hd]

    out = out.permute(0, 1, 2, 4, 3, 5).reshape(b, hb, wb, nq, c)
    out = image_from_blocks(out, bs)
    if residual is not None:
        out = residual + out
    return out


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, hb, wb, n, C] → f32 [B, hb, wb, heads, n, hd]."""
    b, hb, wb, n, c = x.shape
    return x.reshape(b, hb, wb, n, num_heads, c // num_heads).permute(0, 1, 2, 4, 3, 5).float()


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `_heads` (keeps the dtype)."""
    b, hb, wb, heads, n, hd = x.shape
    return x.permute(0, 1, 2, 4, 3, 5).reshape(b, hb, wb, n, heads * hd)


def block_halo_attention_bwd_torch(
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
    """Plain backward of `block_halo_attention_torch` (not autograd).

    Returns (dq, dk, dv) in q's dtype and (drel_h, drel_w) in f32:
    probabilities recomputed in f32; dattn = do·vᵀ; dl = round(P·(dattn −
    Σ dattn·P)); dq = round(dl·k_eff·scale); window gradients dk_w =
    dlᵀ·q·scale and dv_w = round(P)ᵀ·do in f32, overlap-added in f32 and
    rounded once. The bias gradient sums the f32 dk_w of every key, inside
    the frame or not, over windows and heads."""
    b, h, w, c = q.shape
    bs = block_size
    window = bs + 2 * halo_size
    hd = c // num_heads
    half = hd // 2
    dtype = q.dtype
    hb, wb = h // bs, w // bs

    qh = _heads(blocks_from_image(q, bs), num_heads)
    doh = _heads(blocks_from_image(do, bs), num_heads)
    kw = extract_halo_windows(k, bs, halo_size).reshape(b, hb, wb, window, window, num_heads, hd)
    kw = (kw.float() + rel_bias(rel_h, rel_w)[:, :, None, :]).to(dtype)
    kh = _heads(kw.reshape(b, hb, wb, window * window, c), num_heads)
    vh = _heads(extract_halo_windows(v, bs, halo_size).reshape(b, hb, wb, -1, c), num_heads)

    scale = torch.tensor(hd, dtype=torch.float32) ** -0.5
    attn = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    dattn = torch.matmul(doh, vh.transpose(-1, -2))
    dl = (attn * (dattn - (dattn * attn).sum(-1, keepdim=True))).to(dtype).float()
    dq = (torch.matmul(dl, kh) * scale).to(dtype)
    dk_w = torch.matmul(dl.transpose(-1, -2), qh) * scale  # [B,hb,wb,heads,nk,hd]
    dv_w = torch.matmul(attn.to(dtype).float().transpose(-1, -2), doh)

    dbias = dk_w.sum(dim=(0, 1, 2, 3)).reshape(window, window, hd)

    def image(win: torch.Tensor) -> torch.Tensor:
        win = _unheads(win).reshape(b, hb, wb, window, window, c)
        return overlap_add_windows(win, h, w, bs, halo_size).to(dtype)

    dq = image_from_blocks(_unheads(dq), bs)
    return (dq, image(dk_w), image(dv_w),
            dbias[..., :half].sum(1), dbias[..., half:].sum(0))


def block_halo_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    curve_indices=None,
    inv_curve_indices=None,
    *,
    block_size: int,
    halo_size: int,
    num_heads: int,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dispatching entry point (`ops/library.py`; the op
    `pht::block_halo_attention` under `torch.export`): the CUDA kernel for
    CUDA tensors (launch or raise), the plain version for CPU tensors. Not
    differentiable."""
    _, h, w, _ = q.shape
    if h % block_size != 0 or w % block_size != 0:
        raise ValueError(
            f"feature map H×W = {h}×{w} must be divisible by "
            f"block_size={block_size}; pad or tile the input "
            f"(inference.py tiles full frames to block-aligned sizes)",
        )
    return library.block_halo_attention(q, k, v, rel_h, rel_w, residual, block_size, halo_size,
                                        num_heads)


def block_halo_attention_bwd(q, k, v, rel_h, rel_w, do, *, block_size: int, halo_size: int,
                             num_heads: int) -> tuple[torch.Tensor, ...]:
    """Backward dispatcher: K4 for CUDA tensors (launch or raise), the plain
    version for CPU tensors. Returns (dq, dk, dv, drel_h, drel_w)."""
    return dispatch("block_halo_attention_bwd", q, block_halo_attention_bwd_cuda,
                    block_halo_attention_bwd_torch, q, k, v, rel_h, rel_w, do,
                    block_size=block_size, halo_size=halo_size, num_heads=num_heads)


class BlockHaloAttentionFn(torch.autograd.Function):
    """Differentiable block-halo attention (port of the TPU custom VJP
    `_attention_core`, `ops/attention_pallas.py:654-682`).

    `apply(q, k, v, rel_h, rel_w, residual, block_size, halo_size,
    num_heads)`: the forward runs `block_halo_attention` (K1 on the card),
    the backward `block_halo_attention_bwd` (K4); the residual's gradient
    is the incoming gradient itself. First-order only."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, residual, block_size, halo_size, num_heads):
        ctx.cfg = dict(block_size=block_size, halo_size=halo_size, num_heads=num_heads)
        ctx.has_residual = residual is not None
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        return block_halo_attention(q, k, v, rel_h, rel_w, residual=residual, **ctx.cfg)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, rel_h, rel_w = ctx.saved_tensors
        dq, dk, dv, drel_h, drel_w = block_halo_attention_bwd(
            q, k, v, rel_h, rel_w, do.contiguous(), **ctx.cfg,
        )
        dres = do if ctx.has_residual else None
        return (dq, dk, dv, drel_h.to(rel_h.dtype), drel_w.to(rel_w.dtype), dres,
                None, None, None)


def _qkv_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A bias-free 1×1 projection x [..., C_in] · w [C_in, C_out] in x's
    dtype (`attention_pallas._qkv_project` :709)."""
    return torch.matmul(x, w.to(x.dtype))


def qkv_block_halo_attention_torch(n_aux, noisy, wq, wk, wv, rel_h, rel_w, *, block_size: int,
                                   halo_size: int, num_heads: int, residual=None):
    """Plain version of `QKVBlockHaloAttentionFn`: the projections around
    `block_halo_attention_torch`, differentiable by autograd."""
    q, k, v = _qkv_project(n_aux, wq), _qkv_project(n_aux, wk), _qkv_project(noisy, wv)
    return block_halo_attention_torch(q, k, v, rel_h, rel_w, block_size=block_size,
                                      halo_size=halo_size, num_heads=num_heads, residual=residual)


class QKVBlockHaloAttentionFn(torch.autograd.Function):
    """Block-halo attention with the q/k/v 1×1 projections folded into the
    op (port of `qkv_block_halo_attention_pallas`,
    `ops/attention_pallas.py:686-793`, the `fold_qkv` variant).

    `apply(n_aux, noisy, wq, wk, wv, rel_h, rel_w, residual, block_size,
    halo_size, num_heads)`, with the weights [C_in, C_out]: the forward
    projects q = n_aux·wq, k = n_aux·wk, v = noisy·wv in the compute dtype
    and runs `block_halo_attention` (K1 on the card, with the fused
    residual); the backward runs `block_halo_attention_bwd` (K4), then the
    weight gradients as f32-accumulated products (dwq = n_auxᵀ·dq, ...) and
    the input gradients as compute-dtype products summed in the compute
    dtype (dn_aux = dq·wqᵀ + dk·wkᵀ, dnoisy = dv·wvᵀ), as `_qkv_core_bwd`
    (:740-770). The TPU op projects k and v from W-halo-padded inputs and
    keeps dk and dv padded through its products, slicing after them; K1
    and K4 work on the unpadded layout instead. The numbers are the same:
    the pad columns of the inputs are zero, so they project to zero keys
    and values and cancel from the weight gradients, and the slice drops
    exactly the pad columns' input gradients. First-order only."""

    @staticmethod
    def forward(ctx, n_aux, noisy, wq, wk, wv, rel_h, rel_w, residual, block_size, halo_size,
                num_heads):
        ctx.cfg = dict(block_size=block_size, halo_size=halo_size, num_heads=num_heads)
        ctx.has_residual = residual is not None
        q = _qkv_project(n_aux, wq).contiguous()
        k = _qkv_project(n_aux, wk).contiguous()
        v = _qkv_project(noisy, wv).contiguous()
        ctx.save_for_backward(n_aux, noisy, q, k, v, wq, wk, wv, rel_h, rel_w)
        return block_halo_attention(q, k, v, rel_h, rel_w, residual=residual, **ctx.cfg)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        n_aux, noisy, q, k, v, wq, wk, wv, rel_h, rel_w = ctx.saved_tensors
        dq, dk, dv, drel_h, drel_w = block_halo_attention_bwd(
            q, k, v, rel_h, rel_w, do.to(q.dtype).contiguous(), **ctx.cfg,
        )

        def wgrad(x, dy, w):  # f32 accumulation, as preferred_element_type=f32
            c = x.shape[-1]
            return torch.matmul(x.reshape(-1, c).t().float(),
                                dy.reshape(-1, dy.shape[-1]).float()).to(w.dtype)

        dn_aux = _qkv_project(dq, wq.t()) + _qkv_project(dk, wk.t())
        dnoisy = _qkv_project(dv, wv.t())
        dres = do if ctx.has_residual else None
        return (dn_aux, dnoisy, wgrad(n_aux, dq, wq), wgrad(n_aux, dk, wk), wgrad(noisy, dv, wv),
                drel_h.to(rel_h.dtype), drel_w.to(rel_w.dtype), dres, None, None, None)

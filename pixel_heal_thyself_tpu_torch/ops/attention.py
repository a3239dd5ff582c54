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

`block_halo_attention` is the dispatching entry point: the CUDA kernel for
a CUDA tensor, this plain version for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch.ops.attention_cuda import block_halo_attention_cuda


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
    """Dispatching entry point: the CUDA kernel for CUDA tensors (launch or
    raise), the plain version for CPU tensors."""
    _, h, w, _ = q.shape
    if h % block_size != 0 or w % block_size != 0:
        raise ValueError(
            f"feature map H×W = {h}×{w} must be divisible by "
            f"block_size={block_size}; pad or tile the input "
            f"(inference.py tiles full frames to block-aligned sizes)",
        )
    kw = dict(
        block_size=block_size, halo_size=halo_size, num_heads=num_heads,
        residual=residual,
    )
    if q.device.type == "cuda":
        return block_halo_attention_cuda(q, k, v, rel_h, rel_w, **kw)
    if q.device.type == "cpu":
        return block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw)
    raise ValueError(f"block_halo_attention: unsupported device {q.device}")

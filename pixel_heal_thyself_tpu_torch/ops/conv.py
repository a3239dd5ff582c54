"""Causal depthwise 1-D convolution (PyTorch port).

Port of `pixel_heal_thyself_tpu/ops/conv.py:17` (`causal_depthwise_conv1d`).
The kernel is tiny (k = 4), so the convolution is k shifted multiply-adds
over the [b, l, c] activations, in the JAX package's order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_depthwise_conv1d(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
    initial_tokens: torch.Tensor | None = None,
) -> torch.Tensor:
    """x: [b, l, c]; weight: [k, c] (tap 0 = oldest); bias: [c] or None.

    Output position i sees inputs [i-k+1, i] (zeros before the sequence,
    or `initial_tokens` [b, k-1, c]: the tokens that precede x, which the
    sequence-sharded path takes from the previous rank), computed in x's
    dtype: `w[k-1]·x`, then tap t = 0..k-2 on the input shifted right by
    k-1-t, then the bias."""
    k = weight.shape[0]
    l = x.shape[1]
    if initial_tokens is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    elif initial_tokens.shape[1] != k - 1:
        raise ValueError(f"initial_tokens {tuple(initial_tokens.shape)}: need k-1 = {k - 1} "
                         "tokens")
    else:
        xp = torch.cat([initial_tokens.to(x.dtype), x], dim=1)
    w = weight.to(x.dtype)
    y = w[k - 1] * x
    for t in range(k - 1):
        y = y + w[t] * xp[:, t:t + l]
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y

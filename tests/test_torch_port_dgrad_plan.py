"""K5's Hopper body computes the 3×3 conv input gradient in two parts: the
main passes (each tap's source pixel y + 1 − ky, x + 1 − kx, zero padding)
and, for reflect and replicate padding, the fold lines' f32 terms, which a
pre-pass writes to a side buffer and the epilogue adds, by the buffer's
indexing, before the single rounding (csrc/dgrad_sm90.cu, csrc/sm90_body.cuh).
On the CPU: that decomposition, in f32, equals `conv3x3_dgrad_torch`, on
square and ragged frames, so the algebra holds before the card runs it."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
    conv3x3_dgrad_torch,
    dgrad_fold_floats,
    dgrad_fold_torch,
    fold_lines,
)

SHAPES = [(1, 5, 7, 8, 16), (2, 8, 8, 16, 8), (1, 3, 3, 8, 8), (1, 2, 2, 8, 8),
          (1, 2, 3, 8, 16), (1, 6, 64, 8, 8)]


def _bf16(rng, shape, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).to(
        torch.bfloat16)


def main_passes(g, w):
    """Σ_taps g[y + 1 − ky, x + 1 − kx]·W[ky, kx]ᵀ over in-frame sources, f32."""
    b, h, wd, n = g.shape
    c = w.shape[0] // 9
    wt = w.float().view(3, 3, c, n)
    gz = F.pad(g.float(), (0, 0, 1, 1, 1, 1))
    return sum(gz[:, 2 - ky:2 - ky + h, 2 - kx:2 - kx + wd] @ wt[ky, kx].t()
               for ky in range(3) for kx in range(3))


def add_fold(acc, fold, padding_mode):
    """The epilogue's reads of the side buffer: a pixel on row line s adds
    rows[b, s, x], on column line s cols[b, y, s] (both, on a corner; a line
    that is both fold lines of a small frame adds both)."""
    b, h, wd, c = acc.shape
    rows = fold[:2 * b * wd * c].view(b, 2, wd, c)
    cols = fold[2 * b * wd * c:].view(b, h, 2, c)
    acc = acc.clone()
    for s, (ty, tx) in enumerate(zip(fold_lines(h, padding_mode), fold_lines(wd, padding_mode))):
        acc[:, ty] += rows[:, s]
        acc[:, :, tx] += cols[:, :, s]
    return acc


@pytest.mark.parametrize("padding_mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sm90_dgrad_decomposition_matches_plain(padding_mode, shape):
    rng = np.random.default_rng(3)
    b, h, wd, c, n = shape
    dy, gate = _bf16(rng, (b, h, wd, n)), _bf16(rng, (b, h, wd, n))
    w = _bf16(rng, (9 * c, n), (9 * c) ** -0.5)
    res = _bf16(rng, (b, h, wd, c))
    g = torch.where(gate > 0, dy, torch.zeros_like(dy))  # the gate pass, exact in bf16
    got = main_passes(g, w)
    if padding_mode != "zeros":
        fold = dgrad_fold_torch(g, w, padding_mode)
        assert fold.dtype == torch.float32
        assert fold.numel() == dgrad_fold_floats(b, h, wd, c, padding_mode)
        got = add_fold(got, fold, padding_mode)
    got = got + res.float()
    # the plain version in f32 (bf16-valued inputs): the same sums before
    # the rounding, in another order
    ref = conv3x3_dgrad_torch(dy.float(), gate.float(), w.float(), padding_mode, res.float())
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-6 * scale
    # ... and rounded once, as the kernel does, within one bf16 ulp
    rounded = conv3x3_dgrad_torch(dy, gate, w, padding_mode, res).float()
    assert (got.to(torch.bfloat16).float() - rounded).abs().max().item() <= 2**-8 * scale


def test_fold_side_buffer_size():
    """4 MB at the prod shape (8 × 128² × 256); nothing for zero padding."""
    assert dgrad_fold_floats(8, 128, 128, 256, "replicate") * 4 == 4 * 2**20
    assert dgrad_fold_floats(8, 128, 128, 256, "reflect") == 2 * 8 * 256 * 256
    assert dgrad_fold_floats(8, 128, 128, 256, "zeros") == 0


@pytest.mark.parametrize("n,padding_mode,lines", [(128, "reflect", (1, 126)),
                                                  (128, "replicate", (0, 127)),
                                                  (3, "reflect", (1, 1)), (2, "reflect", (1, 0)),
                                                  (1, "replicate", (0, 0))])
def test_fold_lines(n, padding_mode, lines):
    assert fold_lines(n, padding_mode) == lines


@pytest.mark.parametrize("padding_mode", ["reflect", "replicate"])
def test_fold_terms_vanish_off_the_edge_rows(padding_mode):
    """The side buffer holds only what the padded ring folds in: with g
    zero on the frame's outer rows and columns, every fold term is zero."""
    rng = np.random.default_rng(4)
    g = _bf16(rng, (2, 6, 7, 8))
    g[:, 0] = g[:, -1] = 0
    g[:, :, 0] = g[:, :, -1] = 0
    w = _bf16(rng, (9 * 16, 8))
    assert not dgrad_fold_torch(g, w, padding_mode).any()


def test_fold_pre_pass_has_no_zero_padding_form():
    """Zero padding folds nothing: the side buffer is empty and the plain
    pre-pass refuses the mode, as the C entry does."""
    g = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    w = torch.zeros(9 * 8, 8, dtype=torch.bfloat16)
    assert dgrad_fold_floats(1, 4, 4, 8, "zeros") == 0
    with pytest.raises(ValueError):
        dgrad_fold_torch(g, w, "zeros")

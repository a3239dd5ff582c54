"""PyTorch port: plain block-halo attention against the JAX XLA path.

`block_halo_attention_torch` follows the TPU kernel's rounding order (f32
logits scaled after the product); `block_halo_attention_xla` scales q
first. In float32 the two differ only by rounding: tolerance 1e-5
relative to the largest output. Frames of 8×8 and 16×24 make most keys
edge keys, which must be zero vectors plus the rel bias, never masked.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.ops.attention import (  # noqa: E402
    block_halo_attention_xla,
)
from pixel_heal_thyself_tpu.ops.attention import (  # noqa: E402
    extract_halo_windows as jextract,
)
from pixel_heal_thyself_tpu.ops.curves import (  # noqa: E402
    CurveOrder,
    inverse_permutation,
    make_curve_indices,
)
from pixel_heal_thyself_tpu_torch.ops.attention import (  # noqa: E402
    block_halo_attention,
    block_halo_attention_torch,
    blocks_from_image,
    extract_halo_windows,
    image_from_blocks,
)
from pixel_heal_thyself_tpu_torch.ops.block_cuda import supports_shapes  # noqa: E402

BS = 8


def _inputs(seed, b, h, w, c, heads, halo):
    rng = np.random.default_rng(seed)
    window = BS + 2 * halo
    q, k, v = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(3))
    rel_h = rng.standard_normal((window, c // heads // 2)).astype(np.float32)
    rel_w = rng.standard_normal((window, c // heads // 2)).astype(np.float32)
    return q, k, v, rel_h, rel_w


@pytest.mark.parametrize("halo", [1, 2, 3])
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hw", [(8, 8), (16, 24)])
def test_attention_matches_xla(halo, heads, hw):
    h, w = hw
    q, k, v, rel_h, rel_w = _inputs(halo * 10 + heads, 2, h, w, 16, heads, halo)
    order = make_curve_indices(BS, CurveOrder.HILBERT)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(block_halo_attention_xla(
            *map(jnp.asarray, (q, k, v, rel_h, rel_w)),
            jnp.asarray(order), jnp.asarray(inverse_permutation(order)),
            block_size=BS, halo_size=halo, num_heads=heads,
        ))
    t = [torch.from_numpy(a) for a in (q, k, v, rel_h, rel_w)]
    got = block_halo_attention_torch(*t, order, None, block_size=BS, halo_size=halo,
                                     num_heads=heads).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the dispatcher takes the plain version for CPU tensors
    disp = block_halo_attention(*t, block_size=BS, halo_size=halo, num_heads=heads)
    np.testing.assert_array_equal(disp.numpy(), got)


def test_residual_is_added_after_rounding():
    q, k, v, rel_h, rel_w = _inputs(0, 1, 16, 16, 16, 2, 3)
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    res = torch.from_numpy(q).bfloat16()
    kw = dict(block_size=BS, halo_size=3, num_heads=2)
    rh, rw = torch.from_numpy(rel_h), torch.from_numpy(rel_w)
    plain = block_halo_attention_torch(*t, rh, rw, **kw)
    fused = block_halo_attention_torch(*t, rh, rw, residual=res, **kw)
    assert torch.equal(fused, res + plain)


def test_windows_and_blocks_match_jax():
    x = np.random.default_rng(5).standard_normal((2, 16, 24, 3)).astype(np.float32)
    got = extract_halo_windows(torch.from_numpy(x), BS, 3).numpy()
    want = np.asarray(jextract(jnp.asarray(x), BS, 3))
    np.testing.assert_array_equal(got, want)
    xt = torch.from_numpy(x)
    assert torch.equal(image_from_blocks(blocks_from_image(xt, BS), BS), xt)
    with pytest.raises(ValueError, match="halo_size"):
        extract_halo_windows(xt, BS, BS + 1)


def test_dispatcher_rejects_unaligned_frames():
    q = torch.zeros(1, 12, 16, 8)
    with pytest.raises(ValueError, match="divisible by block_size"):
        block_halo_attention(q, q, q, torch.zeros(14, 2), torch.zeros(14, 2),
                             block_size=BS, halo_size=3, num_heads=2)


@pytest.mark.parametrize(
    "halo,ok", [(0, False), (1, True), (3, True), (8, True), (9, False)],
)
def test_block_gate_bounds_halo(halo, ok):
    """The port's gate admits only 1 ≤ halo ≤ block (the TPU gate lets
    halo 0 and halo > block through)."""
    assert supports_shapes(8, 128, 128, 128, block_size=BS, halo_size=halo,
                           num_heads=4, dtype=torch.bfloat16) is ok


def test_block_gate_other_conditions():
    kw = dict(block_size=BS, halo_size=3, num_heads=4)
    assert supports_shapes(8, 128, 128, 256, **kw, dtype=torch.bfloat16)
    assert not supports_shapes(8, 128, 128, 256, **kw, dtype=torch.float32)
    assert not supports_shapes(8, 120, 132, 256, **kw, dtype=torch.bfloat16)
    assert not supports_shapes(8, 128, 128, 254, **kw, dtype=torch.bfloat16)
    # TPU-only conditions are gone: C % 128 and H % 16
    assert supports_shapes(2, 40, 32, 64, **kw, dtype=torch.bfloat16)
    # no shared-memory term: a 24² window at head_ch 64, whose one-stage
    # plan needs 296 KB per CTA, runs the key-chunked attention kernels
    assert supports_shapes(8, 128, 128, 256, block_size=BS, halo_size=8,
                           num_heads=4, dtype=torch.bfloat16)

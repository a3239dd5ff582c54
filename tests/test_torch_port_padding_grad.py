"""PyTorch port: reflect and replicate padding under autograd.

Where a gradient flows back, `ops.padding.pad2d` pads reflect and
replicate by slices and concatenations (F.pad's CUDA backward for those
modes sums the border into the input with atomics, in an order that
changes from run to run; it was the op that made the literal Mamba
route's backward vary, PERF.md §6). The padded values equal the
no-grad F.pad path's to the bit; the input gradient equals `jax.vjp` of
the JAX package's `pad2d` within 1e-6 (float32 sums of the border's 2-4
terms in another order) and F.pad's own backward within the same bound.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pixel_heal_thyself_tpu.ops.padding import pad2d as jpad2d  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.padding import pad2d  # noqa: E402


@pytest.mark.parametrize("pad", [1, 2, 3])
@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_padding_gradient_matches_jax_and_f_pad(mode, pad):
    rng = np.random.default_rng(pad)
    x = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)
    dy = rng.standard_normal((2, 9 + 2 * pad, 7 + 2 * pad, 5)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pad2d(xt, pad, mode)
    with torch.no_grad():
        assert torch.equal(y, pad2d(xt, pad, mode))
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    want_y, vjp = jax.vjp(lambda a: jpad2d(a, pad, mode), jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]), rtol=0,
                               atol=1e-6)
    x2 = torch.from_numpy(x).requires_grad_(True)
    y2 = F.pad(x2.permute(0, 3, 1, 2), (pad,) * 4, mode=mode).permute(0, 2, 3, 1)
    (ref,) = torch.autograd.grad(y2, x2, torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)

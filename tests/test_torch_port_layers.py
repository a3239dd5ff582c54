"""PyTorch port: `ops/padding.pad2d` and `models/layers.ConvBlock` against
the JAX package, in float32 on the CPU.

Same numpy inputs and the same flax weights (HWIO → OIHW) go through both.
Padding is pure data movement, so it must match exactly; a conv differs
only in float32 summation order (tolerance 1e-5 relative to the largest
output).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.layers import ConvBlock as JConvBlock  # noqa: E402
from pixel_heal_thyself_tpu.ops.padding import pad2d as jpad2d  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.layers import ConvBlock, apply_act  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.padding import pad2d  # noqa: E402


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("pad", [0, 1, 2])
def test_pad2d_matches_jax(mode, pad):
    x = np.random.default_rng(0).standard_normal((2, 7, 9, 3)).astype(np.float32)
    got = pad2d(torch.from_numpy(x), pad, mode).numpy()
    want = np.asarray(jpad2d(jnp.asarray(x), pad, mode))
    np.testing.assert_array_equal(got, want)


def test_pad2d_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown padding mode"):
        pad2d(torch.zeros(1, 4, 4, 1), 1, "circular")


@pytest.mark.parametrize(
    "ksize,mode,act",
    [(1, "zeros", "relu"), (3, "reflect", "leakyrelu"), (5, "replicate", None),
     (3, "zeros", "relu")],
)
def test_conv_block_matches_flax(ksize, mode, act):
    rng = np.random.default_rng(ksize)
    cin, cout = 5, 6
    x = rng.standard_normal((2, 12, 10, cin)).astype(np.float32)
    jblock = JConvBlock(cout, kernel_size=ksize, padding=ksize // 2,
                        padding_mode=mode, act_type=act)
    params = jblock.init(jax.random.PRNGKey(ksize), jnp.asarray(x))["params"]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))

    block = ConvBlock(cin, cout, ksize, padding=ksize // 2, padding_mode=mode, act_type=act)
    kernel = np.asarray(params["Conv_0"]["kernel"])
    block.load_state_dict({
        "conv.weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(np.array(params["Conv_0"]["bias"])),
    })
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_conv_block_init_is_torch_default_and_seeded():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = ConvBlock(4, 8, 3, generator=g1)
    b = ConvBlock(4, 8, 3, generator=g2)
    bound = 1.0 / np.sqrt(3 * 3 * 4)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
        assert p.abs().max().item() <= bound


def test_apply_act_rejects_unknown():
    x = torch.tensor([-1.0, 2.0])
    assert torch.equal(apply_act(x, "relu"), torch.tensor([0.0, 2.0]))
    assert torch.allclose(apply_act(x, "leakyrelu"), torch.tensor([-0.2, 2.0]))
    with pytest.raises(NotImplementedError):
        apply_act(x, "gelu")

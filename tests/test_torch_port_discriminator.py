"""PyTorch port: the norms, strided ConvBlock and DiscriminatorVGG against flax.

Same numpy inputs and the same flax parameters (filled with seeded random
values, so a transposed or misplaced weight cannot pass) go through both
packages in float32 on the CPU. The norms normalise in float32 in both;
a conv differs only in float32 summation order. Tolerance: 1e-5 relative
to the largest output for single layers, 1e-4 for the whole critic
(seven convs, four batch norms and two dense layers in float32).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.models.layers import BatchNorm2d as JBatchNorm2d  # noqa: E402
from pixel_heal_thyself_tpu.models.layers import ConvBlock as JConvBlock  # noqa: E402
from pixel_heal_thyself_tpu.models.layers import InstanceNorm2d as JInstanceNorm2d  # noqa: E402
from pixel_heal_thyself_tpu.models.layers import PReLU as JPReLU  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.layers import (  # noqa: E402
    BatchNorm2d,
    ConvBlock,
    InstanceNorm2d,
    PReLU,
)
from pixel_heal_thyself_tpu_torch.params import discriminator_state_from_flax  # noqa: E402


def _random_params(module, x, seed):
    """The module's flax variables (shapes from `init`, traced without
    running it) filled with seeded values (ones/zeros initialisers would
    hide a swapped scale/bias)."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        fan = float(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4.0
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(np.float32)

    return jax.tree.map(fill, jax.eval_shape(module.init, jax.random.PRNGKey(0), x))


def _close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_batchnorm_matches_flax():
    x = np.random.default_rng(0).standard_normal((3, 5, 6, 8)).astype(np.float32) * 3 + 1
    params = _random_params(JBatchNorm2d(), jnp.asarray(x), 1)
    want = JBatchNorm2d().apply(params, jnp.asarray(x))
    bn = BatchNorm2d(8)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params["params"].items()})
    _close(bn(torch.from_numpy(x)), want, 1e-5)


def test_instancenorm_and_prelu_match_flax():
    x = np.random.default_rng(2).standard_normal((2, 5, 6, 4)).astype(np.float32) * 2 - 1
    want = JInstanceNorm2d().apply({}, jnp.asarray(x))
    _close(InstanceNorm2d()(torch.from_numpy(x)), want, 1e-5)
    jp = JPReLU()
    params = jp.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _close(PReLU()(torch.from_numpy(x)), jp.apply(params, jnp.asarray(x)), 0)


@pytest.mark.parametrize("k,stride,norm,act", [
    (4, 2, "batch", "leakyrelu"), (3, 1, "instance", "relu"), (3, 2, None, "prelu"),
])
def test_strided_convblock_matches_flax(k, stride, norm, act):
    x = np.random.default_rng(3).standard_normal((2, 10, 12, 5)).astype(np.float32)
    jb = JConvBlock(7, kernel_size=k, stride=stride, padding=1, norm_type=norm, act_type=act)
    params = _random_params(jb, jnp.asarray(x), 4)["params"]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jb.apply)({"params": params}, jnp.asarray(x))
    block = ConvBlock(5, 7, k, stride=stride, padding=1, norm_type=norm, act_type=act)
    state = {
        "conv.weight": torch.from_numpy(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(params["Conv_0"]["bias"]),
    }
    if norm == "batch":
        state["norm.scale"] = torch.from_numpy(params["BatchNorm2d_0"]["scale"])
        state["norm.bias"] = torch.from_numpy(params["BatchNorm2d_0"]["bias"])
    if act == "prelu":
        state["prelu.slope"] = torch.from_numpy(params["PReLU_0"]["slope"])
    block.load_state_dict(state)
    _close(block(torch.from_numpy(x)), want, 1e-5)


def test_discriminator_vgg_matches_jax_through_bridge():
    x = np.random.default_rng(5).standard_normal((3, 16, 16, 3)).astype(np.float32)
    jd = JDiscriminatorVGG(input_size=16, base_nf=8)
    params = _random_params(jd, jnp.asarray(x), 6)["params"]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jd.apply)({"params": params}, jnp.asarray(x))
    d = DiscriminatorVGG(input_size=16, base_nf=8)
    d.load_state_dict(discriminator_state_from_flax(params))
    got = d(torch.from_numpy(x))
    assert got.shape == (3, 1) and got.dtype == torch.float32
    _close(got, want, 1e-4)


def test_prod_discriminator_param_count_matches_jax():
    jd = JDiscriminatorVGG(input_size=128, base_nf=64, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    d = DiscriminatorVGG(input_size=128, base_nf=64, dtype=torch.bfloat16)
    assert sum(p.numel() for p in d.parameters()) == want


def test_discriminator_bridge_rejects_unknown_names():
    with pytest.raises(KeyError):
        discriminator_state_from_flax({"Dense_7": {"kernel": np.zeros((2, 2))}})

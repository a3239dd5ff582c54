"""The port's fresh initialisation against the JAX package's initialisers.

For the prod `AFGSANet` and the prod critic `DiscriminatorVGG(128, 64)`,
each leaf's distribution is read off the JAX model: `jax.eval_shape` of
its `init` (no flax init runs) with `nn.Module.param` recording which
initialiser each leaf takes, and the bound or std that initialiser gives
at the leaf's JAX shape (`pixel_heal_thyself_tpu/utils/init.py`: torch's
default uniform bound 1/sqrt(fan_in), kaiming normal fan-out, N(0, 1);
flax's ones and zeros; PReLU's 0.2). The bridge (`params.py`) names each
leaf as the port does. The port's model is built from a seeded generator
with `torch.Tensor.uniform_` / `normal_` recording what each parameter was
drawn from: its bound or std must equal the JAX one (1e-6 relative), a
constant leaf must hold the JAX constant, and each drawn leaf's sample
mean and std must lie within 6 standard errors of the distribution's
(a uniform leaf also inside its bound).
"""

from __future__ import annotations

import inspect
import math
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.utils import init as jinit  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, afgsa_prod_kwargs  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    discriminator_state_from_flax,
)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the JAX AFGSANet at -cn prod (afgsa_prod_kwargs without the port's
# kernel switches)
JAX_PROD = dict(input_channels=3, aux_input_channels=7, base_ch=256, enc_ch=256, num_sa=5,
                block_size=8, halo_size=3, num_heads=4, num_gcp=0, padding_mode="replicate")


def _jax_spec(init_fn, shape: tuple):
    """(kind, value) of the JAX initialiser at `shape`: ("uniform", bound),
    ("normal", std) or ("const", c)."""
    if init_fn is jinit.torch_default_kernel_init:
        return "uniform", 1.0 / math.sqrt(jinit._conv_fans(shape)[0])
    if init_fn is jinit.kaiming_normal_fan_out:
        return "normal", math.sqrt(2.0 / jinit._conv_fans(shape)[1])
    if init_fn is jinit.normal_unit:
        return "normal", 1.0
    if init_fn.__qualname__ == "torch_default_bias_init.<locals>.init":
        return "uniform", inspect.getclosurevars(init_fn).nonlocals["bound"]
    value = np.asarray(init_fn(jax.random.PRNGKey(0), shape))
    assert value.size and np.all(value == value.flat[0]), f"{init_fn} is not a known initialiser"
    return "const", float(value.flat[0])


def _spec_by_path(module, args) -> dict:
    """{flax path string: (kind, value)} from the recorded initialisers,
    keyed by the module path flax records alongside each call."""
    out = {}
    param = fnn.Module.param

    def recording(self, name, init_fn, *init_args, **kwargs):
        path = "".join(f"['{p}']" for p in (*self.scope.path, name))
        out[path] = (init_fn, tuple(init_args[0]))
        return param(self, name, init_fn, *init_args, **kwargs)

    with mock.patch.object(fnn.Module, "param", recording):
        jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return {path: _jax_spec(*rec) for path, rec in out.items()}


def jax_expected(module, args, bridge) -> dict:
    """{port parameter name: (kind, value)} of the JAX `module`'s init."""
    by_path = _spec_by_path(module, args)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    indexed = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(flat)])
    paths = [jax.tree_util.keystr(p) for p, _ in flat]
    return {name: by_path[paths[int(t.flatten()[0])]] for name, t in bridge(indexed).items()}


def port_draws(build) -> tuple:
    """(model, {parameter name: ("uniform", bound) | ("normal", std)}) of
    `build()`, from what `uniform_`/`normal_` were called with."""
    calls: dict = {}
    uniform, normal = torch.Tensor.uniform_, torch.Tensor.normal_

    def rec_uniform(self, a=0.0, b=1.0, *args, **kwargs):
        assert a == -b, f"an asymmetric uniform draw U({a}, {b})"
        calls[self.data_ptr()] = ("uniform", float(b))
        return uniform(self, a, b, *args, **kwargs)

    def rec_normal(self, mean=0.0, std=1.0, *args, **kwargs):
        assert mean == 0.0, f"a normal draw with mean {mean}"
        calls[self.data_ptr()] = ("normal", float(std))
        return normal(self, mean, std, *args, **kwargs)

    with mock.patch.object(torch.Tensor, "uniform_", rec_uniform), \
            mock.patch.object(torch.Tensor, "normal_", rec_normal):
        model = build()
    return model, {n: calls.get(p.data_ptr()) for n, p in model.named_parameters()}


def check_init(expected: dict, model: torch.nn.Module, drawn: dict) -> int:
    """Hold each port parameter against its JAX spec; returns the number
    checked."""
    params = dict(model.named_parameters())
    assert set(params) == set(expected)
    for name, (kind, value) in expected.items():
        x = params[name].detach().double().flatten()
        if kind == "const":
            assert drawn[name] is None, name
            assert torch.all(x == value), f"{name}: not the constant {value}"
            continue
        assert drawn[name] is not None and drawn[name][0] == kind, (name, drawn[name], kind)
        assert drawn[name][1] == pytest.approx(value, rel=1e-6), (name, drawn[name], value)
        sigma = value / math.sqrt(3.0) if kind == "uniform" else value
        kurtosis = 1.8 if kind == "uniform" else 3.0
        n = x.numel()
        assert abs(x.mean().item()) <= 6 * sigma / math.sqrt(n), name
        if n > 1:
            rel_se = math.sqrt((kurtosis - 1) / n) / 2
            assert abs(x.std().item() / sigma - 1) <= 6 * rel_se + 1 / n, name
        if kind == "uniform":
            assert x.abs().max().item() <= value * (1 + 2**-23), name  # float32 rounding
    return len(expected)


def test_prod_afgsanet_init_matches_jax():
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    a = jnp.zeros((1, 16, 16, 7), jnp.float32)
    expected = jax_expected(JAFGSANet(**JAX_PROD), (x, a), afgsa_state_from_flax)
    kwargs = dict(afgsa_prod_kwargs(), use_kernels=False, use_block_kernel=False)
    model, drawn = port_draws(
        lambda: AFGSANet(**kwargs, generator=torch.Generator().manual_seed(990819)))
    assert {kind for kind, _ in expected.values()} == {"uniform", "normal"}
    assert check_init(expected, model, drawn) == len(list(model.parameters()))


def test_prod_critic_init_matches_jax():
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    expected = jax_expected(JDiscriminatorVGG(input_size=128, base_nf=64), (x,),
                            discriminator_state_from_flax)
    model, drawn = port_draws(lambda: DiscriminatorVGG(
        in_nc=3, base_nf=64, input_size=128, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(990820)))
    assert {kind for kind, _ in expected.values()} == {"uniform", "const"}
    assert check_init(expected, model, drawn) == len(list(model.parameters()))

"""PyTorch port: the GAN critics beyond DiscriminatorVGG, against flax.

`DiscriminatorVGG128`, `PatchGANDiscriminator`, `SNConv`,
`PatchDiscriminator` and `MultiScaleDiscriminator` run on the same seeded
numpy inputs as the JAX classes, in float32 on the CPU, from the same
flax variables (shapes from `init`, traced without running it, filled
with seeded values; the spectral norms' `u` seeded unit vectors) carried
across by `params.py`. Tolerances relative to the largest output: 1e-5
for one SNConv (float32 sums in another order; the port flattens the
weight OIHW, flax HWIO, which permutes the power iteration's sums), 1e-4
for a whole critic (up to ten convs in float32). The spectral norm's `u`:
after a call inside `spectral_norm_update` it equals flax's `spectral`
collection after a `mutable=["spectral"]` apply (1e-5 absolute; a unit
vector), and a call outside leaves it as it was to the bit, as flax's
immutable apply does. SNConv's gradients w.r.t. its weight (through σ)
and its input against `jax.grad`: 1e-4 relative to the largest.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models import discriminators as jd  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import (  # noqa: E402
    DiscriminatorVGG128,
    MultiScaleDiscriminator,
    PatchDiscriminator,
    PatchGANDiscriminator,
    SNConv,
    spectral_norm_update,
)
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    discriminator_vgg128_state_from_flax,
    multiscale_discriminator_state_from_flax,
    patchgan_state_from_flax,
)


def _close(got, want, rel, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def _variables(module, x, seed) -> dict:
    """flax variables of `module` with seeded values: kernels and biases
    at the torch-default scale, BatchNorm scale 1 ± 0.1 and bias ± 0.1,
    each `u` a seeded unit vector."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if str(path[-2].key).startswith("BatchNorm"):
            base = 1.0 if name == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan = float(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 16.0
        return rng.uniform(-1, 1, leaf.shape).astype(np.float32) * fan**-0.5

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _image(seed, b, s, c=3):
    return np.random.default_rng(seed).uniform(-1, 2, (b, s, s, c)).astype(np.float32)


def _patch_state(params: dict, spectral: dict) -> dict:
    """A lone PatchDiscriminator's flax trees → its port state_dict."""
    state = multiscale_discriminator_state_from_flax({"D1": params}, {"D1": spectral})
    return {k.removeprefix("d1."): v for k, v in state.items()}


def test_discriminator_vgg128_matches_jax():
    x = _image(0, 2, 128)
    jmodel = jd.DiscriminatorVGG128(base_nf=4)
    variables = _variables(jmodel, x, 1)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(variables, jnp.asarray(x))
    model = DiscriminatorVGG128(base_nf=4)
    model.load_state_dict(discriminator_vgg128_state_from_flax(variables["params"]))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 1)
    _close(got, want, 1e-4)


def test_patchgan_discriminator_matches_jax():
    x = _image(2, 2, 32)
    jmodel = jd.PatchGANDiscriminator(base_nf=4)
    variables = _variables(jmodel, x, 3)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(variables, jnp.asarray(x))
    model = PatchGANDiscriminator(base_nf=4)
    model.load_state_dict(patchgan_state_from_flax(variables["params"]))
    got = model(torch.from_numpy(x))
    assert got.shape == (2, 2, 2, 1)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("features,stride", [(16, 2), (1, 1)])
def test_snconv_matches_jax_and_writes_u_only_when_asked(features, stride):
    x = _image(4, 2, 12, c=6)
    jconv = jd.SNConv(features, kernel_size=4, stride=stride, padding=1)
    variables = _variables(jconv, x, 5)
    with jax.default_matmul_precision("highest"):
        want, new_vars = jconv.apply(variables, jnp.asarray(x), mutable=["spectral"])
    conv = SNConv(6, features, 4, stride, 1)
    state = _patch_state({"SNConv_0": variables["params"]}, {"SNConv_0": variables["spectral"]})
    conv.load_state_dict({k.removeprefix("convs.0."): v for k, v in state.items()})
    with torch.no_grad():
        u_old = conv.u.clone()
        _close(conv(torch.from_numpy(x)), want, 1e-5, "output")
        assert torch.equal(conv.u, u_old)  # not asked to write
        with spectral_norm_update(conv):
            _close(conv(torch.from_numpy(x)), want, 1e-5, "output (writing u)")
    assert conv.update_u is False
    np.testing.assert_allclose(conv.u.numpy(), np.asarray(new_vars["spectral"]["u"]),
                               rtol=0, atol=1e-5)

    # gradients w.r.t. the weight (σ's included) and the input, old u
    def loss(params, xx):
        out = jconv.apply({"params": params, "spectral": variables["spectral"]}, xx)
        return jnp.sum(out * out)

    with jax.default_matmul_precision("highest"):
        gk, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    conv.u.copy_(torch.from_numpy(np.asarray(variables["spectral"]["u"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    conv(xt).square().sum().backward()
    _close(conv.weight.grad, np.transpose(np.asarray(gk["kernel"]), (3, 2, 0, 1)), 1e-4, "dw")
    _close(conv.bias.grad, gk["bias"], 1e-4, "db")
    _close(xt.grad, gx, 1e-4, "dx")


def test_patch_discriminator_matches_jax():
    x = _image(6, 2, 32)
    jmodel = jd.PatchDiscriminator(base_nf=8, input_size=32)
    variables = _variables(jmodel, x, 7)
    with jax.default_matmul_precision("highest"):
        want, new_vars = jmodel.apply(variables, jnp.asarray(x), mutable=["spectral"])
    model = PatchDiscriminator(base_nf=8, input_size=32)
    assert len(model.convs) == len(variables["params"]) == 4
    model.load_state_dict(_patch_state(variables["params"], variables["spectral"]))
    with torch.no_grad(), spectral_norm_update(model):
        got = model(torch.from_numpy(x))
    _close(got, want, 1e-4)
    want_u = _patch_state(variables["params"], new_vars["spectral"])
    for name, u in model.state_dict().items():
        if name.endswith(".u"):
            np.testing.assert_allclose(u.numpy(), want_u[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


def test_multiscale_discriminator_matches_jax():
    x = _image(8, 2, 32)
    jmodel = jd.MultiScaleDiscriminator(in_nc=3, patch_size=32)
    variables = _variables(jmodel, x, 9)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(variables, jnp.asarray(x))
        _, new_vars = jmodel.apply(variables, jnp.asarray(x), mutable=["spectral"])
    model = MultiScaleDiscriminator(in_nc=3, patch_size=32)
    state = multiscale_discriminator_state_from_flax(variables["params"], variables["spectral"])
    assert state.keys() == model.state_dict().keys()
    model.load_state_dict(state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert isinstance(got, list) and len(got) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        _close(g, w, 1e-4, f"scale {i}")
    with torch.no_grad(), spectral_norm_update(model):
        model(torch.from_numpy(x))
    want_u = multiscale_discriminator_state_from_flax(variables["params"],
                                                     new_vars["spectral"])
    for name, u in model.state_dict().items():
        if name.endswith(".u"):
            np.testing.assert_allclose(u.numpy(), want_u[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


def test_multiscale_bridge_rejects_unknown_names():
    with pytest.raises(KeyError):
        multiscale_discriminator_state_from_flax({"D4": {}}, {"D4": {}})
    with pytest.raises(KeyError):
        multiscale_discriminator_state_from_flax({"D1": {"Conv_0": {}}}, {"D1": {}})

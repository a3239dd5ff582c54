"""PyTorch port: the Mamba2 denoiser's modules against the JAX package.

Small sizes on the CPU, weights and inputs from seeded numpy, one flax
param tree loaded into both packages (`params.mamba_state_from_flax`).
Tolerances, relative to the reference's largest magnitude:
- `RMSNormGated` in float32: 1e-6 (f32 reductions in another order); in
  bf16: 2**-6, four bf16 ulps (the gate, the SiLU and the scale product
  each round to bf16, and XLA fuses some of those steps in f32, so a few
  values land on the other side of a rounding boundary);
- `LayerNormTorch` in float32: 1e-5 (the inputs sit at 50, where an f32
  sum of 64 values carries about one ulp of 3,200, 2.4e-4, into the mean);
  in bf16: 2**-7, two bf16 ulps (only the affine output rounds);
- `positional_encoding_2d`: exact;
- `MambaDenoiserNet` in float32 (base_ch 32, d_inner 128, headdim 32,
  d_state 16, 2 blocks, 32² inputs, so l = 1024 passes the fused gate):
  1e-4 for both of the port's routes against the JAX model's XLA chain,
  with `num_gcp` > 0 so that the `CheckpointMambaBlock_<j>` names map.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models import mamba as jmamba  # noqa: E402
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import mamba_kwargs_from_config  # noqa: E402
from pixel_heal_thyself_tpu_torch.models import mamba  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import count_params  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import mamba_state_from_flax  # noqa: E402

SMALL = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16, headdim=32, expansion=4,
             padding_mode="replicate")


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _fill(rng):
    """Seeded values for a flax param leaf, scaled by its role."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "A_log":
            return rng.uniform(0.0, 1.5, leaf.shape).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-4.0, -1.0, leaf.shape).astype(np.float32)
        if name in ("scale", "weight", "D"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan = float(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 10.0
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(np.float32)
    return fill


@functools.lru_cache(maxsize=None)
def _small_params(num_gcp: int) -> dict:
    jmodel = jmamba.MambaDenoiserNet(**SMALL, num_gcp=num_gcp)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 32, 32, 7)))["params"]
    return jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(num_gcp)), shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gated_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, z = (rng.standard_normal((2, 40, 64)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmamba.RMSNormGated().apply({"params": {"weight": w}}, jnp.asarray(x).astype(jd),
                                       jnp.asarray(z).astype(jd))
    norm = mamba.RMSNormGated(64)
    norm.weight.data = torch.from_numpy(w)
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(td), torch.from_numpy(z).to(td))
    assert got.dtype == td
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           1e-6 if dtype == "float32" else 2**-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_torch_matches_jax(dtype):
    rng = np.random.default_rng(1)
    # a mean far above the spread: the case where bf16 (x - mean) cancels
    x = (50.0 + rng.standard_normal((2, 40, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmamba.LayerNormTorch(dtype=jd).apply({"params": {"scale": scale, "bias": bias}},
                                                 jnp.asarray(x).astype(jd))
    norm = mamba.LayerNormTorch(64, dtype=td)
    norm.scale.data, norm.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(td))
    assert got.dtype == td
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           1e-5 if dtype == "float32" else 2**-7)


@pytest.mark.parametrize("c,h,w", [(32, 8, 8), (256, 16, 24)])
def test_positional_encoding_2d_is_exact(c, h, w):
    np.testing.assert_array_equal(mamba.positional_encoding_2d(c, h, w),
                                  jmamba.positional_encoding_2d(c, h, w))


@pytest.mark.parametrize("num_gcp", [0, 1])
@pytest.mark.parametrize("fused", [False, True])
def test_denoiser_matches_jax(fused, num_gcp):
    params = _small_params(num_gcp)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    aux = rng.uniform(-1, 1, (2, 32, 32, 7)).astype(np.float32)
    jmodel = jmamba.MambaDenoiserNet(**SMALL, num_gcp=num_gcp)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply({"params": params}, x, aux)
    model = mamba.MambaDenoiserNet(**SMALL, num_gcp=num_gcp, use_kernels=True,
                                   use_megakernel=fused).eval()
    model.load_state_dict(mamba_state_from_flax(params))
    assert model.blocks[0].mamba.fused_route(32 * 32) == fused
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(aux))
    _close(got, want, 1e-4)


def test_denoiser_grad_mode():
    """The literal route trains through autograd (and through the
    checkpointed blocks); the fused route trains through `MambaChainFn`
    and gives the literal route's gradients (fp32: 1e-4 of each gradient's
    largest magnitude, f32 sums in another order; 48 numpy seeds read at
    most 6.3e-6, the per-head dt_bias sums. The inputs are seeded: a pre-
    activation within rounding of a ReLU kink would flip a unit and move
    every gradient upstream of it)."""
    params = _small_params(1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32))
    aux = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 7)).astype(np.float32))
    grads = []
    for fused in (False, True):
        model = mamba.MambaDenoiserNet(**SMALL, num_gcp=1, use_kernels=True,
                                       use_megakernel=fused)
        model.load_state_dict(mamba_state_from_flax(params))
        model(x, aux).sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    literal, fused = grads
    assert any(n.startswith("blocks.1.") for n in literal)
    assert literal.keys() == fused.keys()
    for name, g in literal.items():
        assert torch.isfinite(g).all(), name
        _close(fused[name], g, 1e-4)


def test_state_dict_names_cover_the_flax_tree():
    params = _small_params(1)
    state = mamba_state_from_flax(params)
    model = mamba.MambaDenoiserNet(**SMALL, num_gcp=1)
    assert state.keys() == model.state_dict().keys()
    assert len(state) == len(jax.tree.leaves(params))
    w = params["CheckpointMambaBlock_0"]["mamba"]["in_proj"]["kernel"]
    np.testing.assert_array_equal(state["blocks.1.mamba.in_proj.weight"].numpy(), w.T)


def test_prod_kwargs_match_config_and_params():
    cfg = ConfigRegistry.create_config(compose("prod", ["model=mamba"],
                                               resolve_interpolations=False))
    assert mamba.mamba_prod_kwargs() == mamba_kwargs_from_config(cfg)
    kw = mamba.mamba_prod_kwargs()
    jmodel = jmamba.MambaDenoiserNet(
        base_ch=kw["base_ch"], enc_ch=kw["enc_ch"], num_blocks=kw["num_blocks"],
        d_state=kw["d_state"], headdim=kw["headdim"], expansion=kw["expansion"],
    )
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((1, 8, 8, 7)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = mamba.MambaDenoiserNet(**kw)
    assert count_params(model) == want

"""PyTorch port: the AFGSANet generator and its weights bridge.

A small AFGSANet (base_ch 16, enc_ch 16, 2 blocks, 2 heads, 32×32) is
initialised in flax, carried into the port by `afgsa_state_from_flax`
and run on the same numpy inputs in float32 (JAX at HIGHEST precision).
Only float32 summation order differs through the encoders, two blocks and
the decoder: tolerance 1e-4 relative to the largest output. `num_gcp` 2
exercises flax's `CheckpointTransformerBlock_<j>` parameter names.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import afgsa_kwargs_from_config  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import (  # noqa: E402
    AFGSANet,
    afgsa_prod_kwargs,
    count_params,
)
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    load_params_npz,
)

SMALL = dict(base_ch=16, enc_ch=16, num_sa=2, num_heads=2)


def _inputs(seed, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (b, h, w, 3)).astype(np.float32)
    a = rng.uniform(-1.0, 1.0, (b, h, w, 7)).astype(np.float32)
    return x, a


@functools.lru_cache(maxsize=None)
def _flax_params(num_gcp: int) -> dict:
    """The flax param tree of the small model (its names and shapes from
    `init`, traced without compiling), filled with seeded numpy values at
    the torch-default scale."""
    jmodel = JAFGSANet(**SMALL, num_gcp=num_gcp)
    x, a = _inputs(0, b=1, h=8, w=8)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, a)["params"]
    rng = np.random.default_rng(num_gcp)

    def fill(path, leaf):
        name = str(path[-1].key)
        scale = 1.0 if name.startswith("rel_") else (
            0.1 if name == "bias" else float(np.prod(leaf.shape[:-1])) ** -0.5)
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _flax_apply(jmodel, params, x, a):
    with jax.default_matmul_precision("highest"):
        out = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(a))
    return np.asarray(out)


@pytest.mark.parametrize("num_gcp,mode", [(0, "reflect"), (2, "replicate")])
def test_afgsanet_fp32_matches_jax(num_gcp, mode):
    x, a = _inputs(num_gcp)
    jmodel = JAFGSANet(**SMALL, num_gcp=num_gcp, padding_mode=mode)
    params = _flax_params(num_gcp)
    names = {k for k in params if "TransformerBlock" in k}
    remat = {f"CheckpointTransformerBlock_{j}" for j in range(num_gcp)}
    assert remat <= names and len(names) == 2
    want = _flax_apply(jmodel, params, x, a)

    model = AFGSANet(**SMALL, num_gcp=num_gcp, padding_mode=mode)
    model.load_state_dict(afgsa_state_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_block_route_bf16_close_to_jax_fp32():
    """The bf16 block route of the whole model (plain chain on the CPU)
    stays near the float32 JAX model: bf16 activations through two blocks,
    5e-2 relative to the largest output."""
    x, a = _inputs(3, b=1)
    jmodel = JAFGSANet(**SMALL, num_gcp=0, padding_mode="replicate")
    params = _flax_params(0)
    want = _flax_apply(jmodel, params, x, a)
    model = AFGSANet(**SMALL, num_gcp=0, padding_mode="replicate", use_kernels=True,
                     use_block_kernel=True, dtype=torch.bfloat16)
    model.load_state_dict(afgsa_state_from_flax(params))
    assert model.block_route(1, 32, 32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_state_from_flax_rejects_unknown_names():
    with pytest.raises(KeyError):
        afgsa_state_from_flax({"Dense_0": {"kernel": np.zeros((2, 2))}})


def test_params_npz_roundtrip(tmp_path):
    params = _flax_params(2)
    flat = {
        "/".join(str(k.key) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    np.savez(tmp_path / "p.npz", **flat)
    tree = load_params_npz(str(tmp_path / "p.npz"))
    a_sd, b_sd = afgsa_state_from_flax(tree), afgsa_state_from_flax(params)
    assert a_sd.keys() == b_sd.keys()
    assert all(torch.equal(a_sd[k], b_sd[k]) for k in a_sd)


def test_prod_param_count():
    model = AFGSANet(**afgsa_prod_kwargs())
    assert count_params(model) == 9_282_691


def test_prod_kwargs_match_config():
    cfg = ConfigRegistry.create_config(compose("prod", resolve_interpolations=False))
    assert afgsa_prod_kwargs() == afgsa_kwargs_from_config(cfg)


def test_film_and_fold_qkv_are_not_ported():
    """Both were once unported; both build and run now. FiLM builds, runs
    and takes the literal route whatever `use_block_kernel` says
    (tests/test_torch_port_film.py holds it against the JAX package);
    fold_qkv builds under its gate (tests/test_torch_port_fold_qkv.py)."""
    film = AFGSANet(**SMALL, use_film=True, use_kernels=True, use_block_kernel=True)
    assert not film.block_route(2, 32, 32)
    assert all(blk.attention.use_film and not hasattr(blk.attention, "fuse")
               for blk in film.blocks)
    x, a = (torch.from_numpy(t) for t in _inputs(7))
    out = film(x, a)
    assert out.shape == (2, 32, 32, 3) and torch.isfinite(out).all()
    out.square().mean().backward()
    assert all(p.grad is not None for p in film.parameters())
    assert AFGSANet(**SMALL, fold_qkv=True).blocks[0].attention.folded is False  # 16 channels
    assert AFGSANet(**dict(SMALL, base_ch=128), fold_qkv=True,
                    use_kernels=True).blocks[0].attention.folded

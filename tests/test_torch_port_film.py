"""PyTorch port: FiLM conditioning of the AFGSA generator against the JAX package.

- `FiLM` alone (spatial, the setting AFGSA uses) on seeded numpy inputs,
  its parameters carried across by hand: float32 sums in another order,
  tolerance 1e-5 relative to the largest output.
- A 2-block AFGSANet (base_ch 32, enc_ch 16, 4 heads, 32²) with
  `use_film=True`: the flax params (shapes from `init`, seeded values)
  carried across by `params.afgsa_state_from_flax`, which maps each block's
  `attention/FiLM_0/Conv_{0,1}`. The port runs with `use_kernels=True`
  (on the CPU the dispatchers take the plain versions; in grad mode the
  literal route goes through `BlockHaloAttentionFn`, K1/K4's plain pair)
  and `use_block_kernel=True`, which FiLM must refuse. Forward and every
  parameter gradient of a sum of squares, JAX at HIGHEST precision: the
  output 1e-4 relative to its largest magnitude (the tolerance of
  tests/test_torch_port_afgsa.py for the same depth), each gradient 1e-3
  relative to its largest magnitude (sums over every pixel in another
  order, through two blocks and the decoder).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.afgsa import FiLM as JFiLM  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet, FiLM  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import afgsa_state_from_flax  # noqa: E402

SMALL = dict(base_ch=32, enc_ch=16, num_sa=2, num_heads=4, num_gcp=1,
             padding_mode="replicate")


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def _inputs(seed, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (b, h, w, 3)).astype(np.float32)
    a = rng.uniform(-1.0, 1.0, (b, h, w, 7)).astype(np.float32)
    return x, a


def test_film_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    cond = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    jfilm = JFiLM(hidden=16, use_spatial=True)
    shapes = jax.eval_shape(jfilm.init, jax.random.PRNGKey(0), x, cond)["params"]
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32), shapes)
    with jax.default_matmul_precision("highest"):
        want = jfilm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond))

    film = FiLM(12, 5, hidden=16)
    state = {}
    for i in (0, 1):
        conv = params[f"Conv_{i}"]
        state[f"conv{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(conv["kernel"], (3, 2, 0, 1))))
        state[f"conv{i}.bias"] = torch.from_numpy(conv["bias"])
    film.load_state_dict(state)
    got = film(torch.from_numpy(x), torch.from_numpy(cond))
    _close(got.detach(), want, 1e-5)


@functools.lru_cache(maxsize=None)
def _flax_params() -> dict:
    jmodel = JAFGSANet(**SMALL, use_film=True)
    x, a = _inputs(0, b=1, h=8, w=8)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, a)["params"]
    rng = np.random.default_rng(21)

    def fill(path, leaf):
        name = str(path[-1].key)
        scale = 1.0 if name.startswith("rel_") else (
            0.1 if name == "bias" else float(np.prod(leaf.shape[:-1])) ** -0.5)
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(**kw) -> AFGSANet:
    model = AFGSANet(**SMALL, use_film=True, **kw)
    model.load_state_dict(afgsa_state_from_flax(_flax_params()))
    return model


def test_film_state_names_map_from_flax():
    params = _flax_params()
    assert set(params["TransformerBlock_0"]["attention"]["FiLM_0"]) == {"Conv_0", "Conv_1"}
    state = afgsa_state_from_flax(params)
    model = AFGSANet(**SMALL, use_film=True)
    assert state.keys() == model.state_dict().keys()
    assert "blocks.1.attention.film.conv1.weight" in state
    assert not any(".fuse." in k for k in state)


def test_film_afgsanet_forward_and_grads_match_jax():
    x, a = _inputs(5)
    jmodel = JAFGSANet(**SMALL, use_film=True)
    params = _flax_params()

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(a))
        return jnp.sum(jnp.square(out)), out

    with jax.default_matmul_precision("highest"):
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_grads = afgsa_state_from_flax(jax.tree.map(np.asarray, jgrads))

    model = _port_model(use_kernels=True, use_block_kernel=True)
    assert not model.block_route(2, 32, 32), "FiLM must refuse the whole-block route"
    out = model(torch.from_numpy(x), torch.from_numpy(a))
    _close(out.detach(), want, 1e-4, "output")
    out.square().sum().backward()
    for name, p in model.named_parameters():
        _close(p.grad, want_grads[name].numpy(), 1e-3, name)


def test_film_block_switch_is_a_no_op():
    """`use_block_kernel` changes nothing under FiLM (the JAX rule): the
    same literal route, the same bits, with and without it, in bf16."""
    x, a = (torch.from_numpy(t) for t in _inputs(6))
    outs = []
    for use_block_kernel in (False, True):
        model = _port_model(use_kernels=True, use_block_kernel=use_block_kernel,
                            dtype=torch.bfloat16)
        assert model.use_block_kernel is False
        with torch.no_grad():
            outs.append(model(x, a))
    assert torch.equal(outs[0], outs[1])

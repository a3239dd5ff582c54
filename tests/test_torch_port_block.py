"""PyTorch port: the TransformerBlock forward against the JAX package.

Two checks on the CPU:
- Algorithm, float32: the port's literal TransformerBlock and its plain
  block chain (`transformer_block_torch`, the CUDA kernels' reference)
  against the JAX literal TransformerBlock (`use_block_kernel=False`,
  `use_pallas=False`) at HIGHEST matmul precision. Only float32 summation
  order differs: tolerance 1e-5 relative to the largest output.
- Kernel semantics, bf16: `transformer_block_torch` against the TPU
  megakernel `transformer_block_mega_padded(..., interpret=True)`,
  unpadded with `unpad_w_halo`, in all three padding modes, at the golden
  tolerances of tests/test_block_mega.py (max relative 3e-2, relative rms
  4e-3): bf16 roundings at the same points, but XLA-on-CPU and torch sum
  in different orders, and a flipped bf16 rounding travels through the
  softmax and both convs.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.models.afgsa import (  # noqa: E402
    TransformerBlock as JTransformerBlock,
)
from pixel_heal_thyself_tpu.ops.block_mega import (  # noqa: E402
    pad_w_halo,
    transformer_block_mega_padded,
    unpad_w_halo,
)
from pixel_heal_thyself_tpu_torch.models.afgsa import TransformerBlock  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.block_cuda import (  # noqa: E402
    transformer_block_fwd,
    transformer_block_torch,
)
from pixel_heal_thyself_tpu_torch.params import _block  # noqa: E402

BS, HALO = 8, 3


def _flax_block_params(ch, heads, mode, x, a):
    jblock = JTransformerBlock(ch=ch, block_size=BS, halo_size=HALO, num_heads=heads,
                               padding_mode=mode)
    params = jblock.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(a))["params"]
    return jblock, jax.tree.map(np.asarray, params)


def _port_block(ch, heads, mode, params, dtype=torch.float32):
    block = TransformerBlock(ch, block_size=BS, halo_size=HALO, num_heads=heads,
                             padding_mode=mode, dtype=dtype)
    state: dict = {}
    _block(state, "", params)
    block.load_state_dict(state)
    return block


@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_block_fp32_matches_jax_literal(mode):
    ch, heads = 16, 2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 24, ch)).astype(np.float32)
    a = rng.standard_normal((2, 16, 24, ch)).astype(np.float32)
    jblock, params = _flax_block_params(ch, heads, mode, x, a)
    with jax.default_matmul_precision("highest"):
        want, _ = jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(a))
    want = np.asarray(want)
    tol = 1e-5 * np.abs(want).max()

    block = _port_block(ch, heads, mode, params)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    with torch.no_grad():
        literal, _ = block(xt, at)
        chain = transformer_block_torch(
            xt, at, **block.kernel_weights(), block_size=BS, halo_size=HALO,
            num_heads=heads, padding_mode=mode,
        )
    np.testing.assert_allclose(literal.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(chain.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_block_bf16_matches_tpu_kernel_interpret(mode):
    b, h, w, c, heads = 1, 32, 32, 128, 4
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    a = rng.standard_normal((b, h, w, c)).astype(np.float32)
    _, params = _flax_block_params(c, heads, mode, x[:, :8, :8], a[:, :8, :8])
    att = params["attention"]
    bf = jnp.bfloat16
    jp = pad_w_halo(jnp.asarray(x, bf), HALO)
    ap = pad_w_halo(jnp.asarray(a, bf), HALO)
    out = transformer_block_mega_padded(
        jp, ap, att["ConvBlock_0"]["Conv_0"]["kernel"], att["ConvBlock_0"]["Conv_0"]["bias"],
        att["q_conv"]["kernel"], att["k_conv"]["kernel"], att["v_conv"]["kernel"],
        att["rel_h"], att["rel_w"],
        params["ConvBlock_0"]["Conv_0"]["kernel"], params["ConvBlock_0"]["Conv_0"]["bias"],
        params["ConvBlock_1"]["Conv_0"]["kernel"], params["ConvBlock_1"]["Conv_0"]["bias"],
        block_size=BS, halo_size=HALO, num_heads=heads, padding_mode=mode, interpret=True,
    )
    want = np.asarray(unpad_w_halo(out, w, HALO), np.float32)

    block = _port_block(c, heads, mode, params, dtype=torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    at = torch.from_numpy(a).bfloat16()
    with torch.no_grad():
        got, _ = block(xt, at, use_block_kernel=True)
        # the dispatcher runs the plain chain for CPU tensors
        disp = transformer_block_fwd(
            xt, at, **block.kernel_weights(), block_size=BS, halo_size=HALO,
            num_heads=heads, padding_mode=mode,
        )
    assert torch.equal(got, disp)
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 3e-2
    assert np.sqrt(((got - want) ** 2).mean()) / scale < 4e-3


def test_block_fwd_rejects_unsupported():
    x = torch.zeros(1, 16, 16, 16)  # float32: the block route is bf16 only
    w = {k: None for k in ("wcat", "bcat", "wq", "wk", "wv", "rel_h", "rel_w",
                           "w1", "b1", "w2", "b2")}
    with pytest.raises(ValueError, match="does not support"):
        transformer_block_fwd(x, x, **w, num_heads=2)

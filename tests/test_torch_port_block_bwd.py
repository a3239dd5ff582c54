"""PyTorch port: the TransformerBlock backward against the JAX package.

Two checks on the CPU, both through `TransformerBlockFn` (whose backward
on a CPU tensor is the plain `transformer_block_bwd_torch`, the reference
of the K4/K5/K6 chain on the card):
- Algorithm, float32: all 13 gradients against `jax.vjp` of the JAX
  literal TransformerBlock at HIGHEST matmul precision. Only float32
  summation order differs: 1e-5 relative to each gradient's largest
  magnitude (measured at most 8.2e-7).
- Kernel semantics, bf16: against `jax.vjp` of the TPU megakernel
  `transformer_block_mega_padded(..., interpret=True)` (its `_bwd_kernel`),
  image gradients unpadded with `unpad_w_halo`, in the prod padding mode
  here and the other two in tests/test_torch_port_block_bwd_modes.py
  (each mode costs ~9 s of JAX tracing), at b=1, 32×32, C=128, 4 heads (the smallest geometry the TPU gate
  admits), with the bounds of tests/test_block_mega.py:238-260: images max
  1e-1 and rms 8e-3 relative; weights rms 2.5e-2 and a total-mass
  fingerprint within 2e-2. The reason is the one that test gives: a bf16
  pre-activation within one ulp of zero lands on the other side of a ReLU
  and moves a full-size contribution; the TPU kernel also rounds dk/dv
  window sums and the conv input gradients per stripe in bf16, where the
  port sums in f32 and rounds once.
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
    BlockConfig,
    TransformerBlockFn,
)
from pixel_heal_thyself_tpu_torch.params import _block  # noqa: E402

BS, HALO = 8, 3


def _flax_params(ch, heads, mode, seed):
    jblock = JTransformerBlock(ch=ch, block_size=BS, halo_size=HALO, num_heads=heads,
                               padding_mode=mode)
    x = jnp.zeros((1, 8, 8, ch))
    params = jblock.init(jax.random.PRNGKey(seed), x, x)["params"]
    return jblock, jax.tree.map(np.asarray, params)


def _port_grads(params, ch, heads, mode, dtype, x, a, do):
    """Gradients through TransformerBlockFn: (dx, da, {state name: grad})."""
    block = TransformerBlock(ch, block_size=BS, halo_size=HALO, num_heads=heads,
                             padding_mode=mode, dtype=dtype)
    state: dict = {}
    _block(state, "", params)
    block.load_state_dict(state)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    at = torch.from_numpy(a).to(dtype).requires_grad_()
    # the dispatch chain is gated to bf16; on a CPU tensor both run the plain versions
    cfg = BlockConfig(BS, HALO, heads, mode, dtype == torch.bfloat16)
    out = TransformerBlockFn.apply(cfg, xt, at, *block.block_params())
    out.backward(torch.from_numpy(do).to(dtype))
    grads = {name: p.grad for name, p in block.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32 for g in grads.values())
    return xt.grad.float().numpy(), at.grad.float().numpy(), grads


def _state_grads(jgrads) -> dict:
    """A flax-shaped gradient tree → the port's state_dict names/layouts."""
    state: dict = {}
    _block(state, "", jax.tree.map(np.asarray, jgrads))
    return {k: v.numpy() for k, v in state.items()}


@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_block_bwd_fp32_matches_jax_literal(mode):
    ch, heads = 16, 2
    rng = np.random.default_rng(2)
    x, a, do = (rng.standard_normal((2, 16, 24, ch)).astype(np.float32) for _ in range(3))
    jblock, params = _flax_params(ch, heads, mode, 3)

    @jax.jit
    def grads(p, x_, a_, do_):
        return jax.vjp(lambda *args: jblock.apply({"params": args[0]}, *args[1:])[0],
                       p, x_, a_)[1](do_)

    with jax.default_matmul_precision("highest"):
        jp, jx, ja = grads(params, *map(jnp.asarray, (x, a, do)))
    want = _state_grads(jp)
    dx, da, grads = _port_grads(params, ch, heads, mode, torch.float32, x, a, do)
    for name, got, ref in [("dx", dx, jx), ("da", da, ja)] + [
            (k, grads[k].numpy(), want[k]) for k in want]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def check_bf16_against_tpu_kernel_interpret(mode: str) -> None:
    """The bf16 kernel-semantics check (module docstring) in one mode."""
    b, h, w, c, heads = 1, 32, 32, 128, 4
    rng = np.random.default_rng(13)
    x, a, do = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(3))
    _, params = _flax_params(c, heads, mode, 5)
    att = params["attention"]
    bf = jnp.bfloat16
    flat = (
        att["ConvBlock_0"]["Conv_0"]["kernel"], att["ConvBlock_0"]["Conv_0"]["bias"],
        att["q_conv"]["kernel"], att["k_conv"]["kernel"], att["v_conv"]["kernel"],
        att["rel_h"], att["rel_w"],
        params["ConvBlock_0"]["Conv_0"]["kernel"], params["ConvBlock_0"]["Conv_0"]["bias"],
        params["ConvBlock_1"]["Conv_0"]["kernel"], params["ConvBlock_1"]["Conv_0"]["bias"],
    )

    def f(xp, ap, *p):
        return transformer_block_mega_padded(
            xp, ap, *p, block_size=BS, halo_size=HALO, num_heads=heads,
            padding_mode=mode, interpret=True,
        )

    xp, ap = pad_w_halo(jnp.asarray(x, bf), HALO), pad_w_halo(jnp.asarray(a, bf), HALO)
    _, vjp = jax.vjp(f, xp, ap, *map(jnp.asarray, flat))
    jx, ja, *jw = vjp(pad_w_halo(jnp.asarray(do, bf), HALO))
    jtree = {
        "attention": {
            "ConvBlock_0": {"Conv_0": {"kernel": jw[0], "bias": jw[1]}},
            "q_conv": {"kernel": jw[2]}, "k_conv": {"kernel": jw[3]},
            "v_conv": {"kernel": jw[4]}, "rel_h": jw[5], "rel_w": jw[6],
        },
        "ConvBlock_0": {"Conv_0": {"kernel": jw[7], "bias": jw[8]}},
        "ConvBlock_1": {"Conv_0": {"kernel": jw[9], "bias": jw[10]}},
    }
    want = _state_grads(jtree)
    dx, da, grads = _port_grads(params, c, heads, mode, torch.bfloat16, x, a, do)

    for name, got, ref in (("dx", dx, jx), ("da", da, ja)):
        ref = np.asarray(unpad_w_halo(ref, w, HALO), np.float32)
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() / scale < 1e-1, name
        assert np.sqrt(((got - ref) ** 2).mean()) / scale < 8e-3, name
    for name, ref in want.items():
        got = grads[name].numpy()
        scale = np.abs(ref).max() + 1e-12
        rms = np.sqrt(((got - ref) ** 2).mean()) / scale
        assert rms < 2.5e-2, f"{name}[{mode}]: rel rms {rms:.3e}"
        fdev = abs(np.abs(got).sum() - np.abs(ref).sum()) / (np.abs(ref).sum() + 1e-12)
        assert fdev < 2e-2, f"{name}[{mode}]: fingerprint dev {fdev:.3e}"


def test_block_bwd_bf16_matches_tpu_kernel_interpret():
    check_bf16_against_tpu_kernel_interpret("replicate")

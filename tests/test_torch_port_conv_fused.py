"""PyTorch port: the fused causal conv1d + SiLU (`ops/conv_fused.py`, the
plain versions of the kernels K9/K10) against the TPU kernel
`conv_pallas.fused_causal_conv1d_silu`, run as tests/test_mamba.py runs it
on the CPU: under `pltpu.force_tpu_interpret_mode()` with `interpret=True`.

Inputs and the output gradient come from seeded numpy; the port's forward
and backward run through `FusedConvSiluFn` (the dispatchers, which take
the plain versions for CPU tensors). Window offset 128, width 256, k 4,
zxbcdt [2, l, 512]; l 64 is one TPU row tile, l 256 four of 64 (the JAX
`_pick_l_tile` monkeypatched, as test_mamba.py:192-193 does), so the
causal context crosses tiles. Tolerances:
- float32: the JAX package's own bounds of the kernel against the XLA
  chain (tests/test_mamba.py:210, :220): forward atol 2e-6, rtol 1e-5;
  gradients atol 1e-4, rtol 1e-4;
- bf16: y and the zxbcdt gradient round once from f32 values that agree to
  f32 rounding, so each value is the JAX value or its bf16 neighbour:
  within one bf16 ulp, |got − want| ≤ 2**-7·|want| (+ 1e-5 for values
  next to zero); the tap and bias gradients are f32 sums of the same f32
  products in another order: rtol 1e-4 with atol 1e-4 of the largest.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pixel_heal_thyself_tpu.ops import conv_pallas  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import conv_fused  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.conv import causal_depthwise_conv1d  # noqa: E402

OFF, WIDTH, CTOT, K = 128, 256, 512, 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(l, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, l, CTOT)).astype(np.float32)
    w = (rng.standard_normal((K, WIDTH)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((WIDTH,)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, l, WIDTH)).astype(np.float32)
    return z, w, b, dy


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l", [64, 256])
def test_forward_and_grads_match_tpu_kernel_interpret(l, dtype, monkeypatch):
    if l == 256:  # four row tiles: the context crosses tile boundaries
        monkeypatch.setattr(conv_pallas, "_pick_l_tile", lambda _l: 64)
    jd, td = DTYPES[dtype]
    z, w, b, dy = _data(l)
    zj = jnp.asarray(z).astype(jd)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda a, c, d: conv_pallas.fused_causal_conv1d_silu(a, c, d, OFF, WIDTH, True),
            zj, jnp.asarray(w), jnp.asarray(b),
        )
        want_grads = vjp(jnp.asarray(dy).astype(jd))

    zt = torch.from_numpy(_np(zj)).to(td).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    got = conv_fused.FusedConvSiluFn.apply(zt, wt, bt, OFF, WIDTH, True)
    assert got.dtype == td and got.shape == (2, l, WIDTH)
    got.backward(torch.from_numpy(_np(jnp.asarray(dy).astype(jd))).to(td))
    assert zt.grad.dtype == td and wt.grad.dtype == torch.float32
    # the gradient of zxbcdt outside the window is zero
    assert not zt.grad[..., :OFF].any() and not zt.grad[..., OFF + WIDTH:].any()

    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=1e-5)
        for g, r in zip((zt.grad, wt.grad, bt.grad), want_grads, strict=True):
            np.testing.assert_allclose(_np(g), _np(r), atol=1e-4, rtol=1e-4)
        return
    for g, r in ((got, want), (zt.grad, want_grads[0])):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-5, rtol=2**-7)
    for g, r in zip((wt.grad, bt.grad), want_grads[1:], strict=True):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-4 * np.abs(_np(r)).max(), rtol=1e-4)


def test_gate_matches_jax():
    for l in (8, 64, 96, 100, 256, 16384, 16385):
        assert conv_fused.pick_l_tile(l) == conv_pallas._pick_l_tile(l)
        for offset in (0, 64, 128, 1024):
            for width in (128, 160, 256, 1152):
                for k in (2, 4, 9, 10):
                    for l_tile in (conv_fused.pick_l_tile(l), 12, 64):
                        args = (l, offset, width, k, l_tile)
                        want = conv_pallas.supports_shapes(*args)
                        assert conv_fused.supports_shapes(*args) == want, args
    # the prod Mamba2 layer (d_inner 1024, conv_dim 1152, 128² tokens) takes it
    assert conv_fused.supports_shapes(16384, 1024, 1152, 4, conv_fused.pick_l_tile(16384))


def test_plain_fused_conv_is_the_literal_chain_in_float32():
    """In float32 every rounding of the literal chain (`causal_depthwise_
    conv1d` + SiLU in x's dtype) is the identity: the two agree to f32
    rounding (the SiLU's formulas differ)."""
    z, w, b, _ = _data(96, seed=1)
    zt, wt, bt = map(torch.from_numpy, (z, w, b))
    got = conv_fused.fused_causal_conv1d_silu_torch(zt, wt, bt, OFF, WIDTH)
    want = torch.nn.functional.silu(causal_depthwise_conv1d(zt[..., OFF:OFF + WIDTH], wt, bt))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_dispatchers_refuse_autograd():
    z, w, b, dy = (torch.from_numpy(a) for a in _data(64, seed=2))
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        conv_fused.fused_causal_conv1d_silu(z, w, b, OFF, WIDTH)
    with pytest.raises(RuntimeError, match="not differentiable"):
        conv_fused.fused_causal_conv1d_silu_bwd(z, w, b, dy, OFF, WIDTH)
    with torch.no_grad():
        y = conv_fused.fused_causal_conv1d_silu(z, w, b, OFF, WIDTH)
        dx, dw, db = conv_fused.fused_causal_conv1d_silu_bwd(z, w, b, dy, OFF, WIDTH)
    assert y.shape == dx.shape == (2, 64, WIDTH) and dw.shape == (K, WIDTH)
    assert db.shape == (WIDTH,)

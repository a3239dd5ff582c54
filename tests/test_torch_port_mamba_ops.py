"""PyTorch port: the Mamba2 ops against the JAX package, on the CPU.

Inputs come from seeded numpy and go to both packages. Tolerances,
relative to the reference output's largest magnitude:
- `causal_depthwise_conv1d`, `ssd_naive`, `ssd_chunked` in float32: 1e-5,
  f32 sums in another order;
- `fused_mamba_chain_torch` (the plain version of the K7 kernel) against
  the TPU kernel `fused_mamba_chain` run in interpret mode, at
  tests/test_ssd_mega.py's CONFIGS: 1e-4, f32 sums in another order
  against that file's own 2e-4 bound of the kernel vs the XLA chain.
K7's own bf16 bounds (tests/test_torch_port_cuda.py on the card, and
`chip_smoke.py` at the prod shape) must fail the plain chain with xBC and
y rounded to bf16, which the TPU kernel never does; a test here holds that
at the card tests' shapes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.ops import ssd as jssd  # noqa: E402
from pixel_heal_thyself_tpu.ops import ssd_mega as jmega  # noqa: E402
from pixel_heal_thyself_tpu.ops.conv import causal_depthwise_conv1d as jconv  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import ssd, ssd_mega  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.conv import causal_depthwise_conv1d  # noqa: E402

# (b, l, d_inner, d_state, headdim, chunk): tests/test_ssd_mega.py CONFIGS
CONFIGS = [
    (2, 256, 128, 64, 64, 64),
    (1, 128, 128, 32, 32, 32),
    (2, 192, 256, 64, 64, 64),
]
# the shapes and bf16 rms bound of tests/test_torch_port_cuda.py's
# test_fused_mamba_chain_kernel
KERNEL_CONFIGS = CONFIGS + [
    (2, 1024, 128, 16, 32, 128), (1, 512, 256, 8, 128, 128), (1, 256, 128, 32, 8, 16),
]
KERNEL_BF16_RMS = 1e-4
REPO = Path(__file__).resolve().parent.parent


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@pytest.mark.parametrize("k,bias", [(4, True), (4, False), (2, True)])
def test_causal_depthwise_conv1d_matches_jax(k, bias):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 37, 24)).astype(np.float32)
    w = rng.standard_normal((k, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32) if bias else None
    want = jconv(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = causal_depthwise_conv1d(_t(x), _t(w), None if b is None else _t(b))
    _close(got, want, 1e-5)


def _ssd_inputs(seed, b=2, l=96, h=4, p=8, g=1, n=16):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, l, h, p)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32),
        A=-rng.uniform(0.5, 4.0, h).astype(np.float32),
        B=rng.standard_normal((b, l, g, n)).astype(np.float32),
        C=rng.standard_normal((b, l, g, n)).astype(np.float32),
        D=rng.standard_normal(h).astype(np.float32),
    )


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_naive_matches_jax(g):
    inp = _ssd_inputs(0, g=g)
    want = jssd.ssd_naive(**{k: jnp.asarray(v) for k, v in inp.items()})
    got = ssd.ssd_naive(**{k: _t(v) for k, v in inp.items()})
    _close(got, want, 1e-5)


@pytest.mark.parametrize("chunk,l,g", [(32, 96, 1), (32, 80, 1), (16, 64, 2), (128, 96, 1)])
def test_ssd_chunked_matches_jax(chunk, l, g):
    """Chunk multiples, a ragged tail (padded), grouped B/C, one chunk."""
    inp = _ssd_inputs(1, l=l, g=g)
    with jax.default_matmul_precision("highest"):
        want = jssd.ssd_chunked(**{k: jnp.asarray(v) for k, v in inp.items()}, chunk=chunk)
    got = ssd.ssd_chunked(**{k: _t(v) for k, v in inp.items()}, chunk=chunk)
    _close(got, want, 1e-5)
    _close(got, ssd.ssd_naive(**{k: _t(v) for k, v in inp.items()}), 1e-5)


def test_ssd_chunked_bf16_rounds_where_jax_does():
    inp = _ssd_inputs(2, l=64)
    bf = jnp.bfloat16
    want = jssd.ssd_chunked(**{k: jnp.asarray(v).astype(bf) for k, v in inp.items()}, chunk=32)
    got = ssd.ssd_chunked(**{k: _t(v).bfloat16() for k, v in inp.items()}, chunk=32)
    assert got.dtype == torch.bfloat16
    # bf16 elementwise steps round at the same points; a rounding flip moves
    # one value by an ulp (2**-8 relative), carried through the scan
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 2**-6)


def _chain_inputs(seed, b, l, d_inner, d_state, headdim, k=4):
    """tests/test_ssd_mega.py `_make_inputs`, as numpy."""
    rng = np.random.default_rng(seed)
    h = d_inner // headdim
    dc = d_inner + 2 * d_state
    W = 2 * d_inner + 2 * d_state + h
    zx = rng.standard_normal((b, l, W)).astype(np.float32) * 0.5
    conv_w = (rng.standard_normal((k, dc)) * 0.2).astype(np.float32)
    conv_b = (rng.standard_normal(dc) * 0.1).astype(np.float32)
    dt_bias = rng.uniform(-4.0, -1.0, h).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.5, h)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    norm_w = (1.0 + 0.1 * rng.standard_normal(d_inner)).astype(np.float32)
    return zx, conv_w, conv_b, dt_bias, A, D, norm_w


@pytest.mark.parametrize("cfg", CONFIGS)
def test_fused_chain_matches_tpu_kernel_interpret(cfg):
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(0, b, l, d_inner, d_state, headdim)
    want = jmega.fused_mamba_chain(*map(jnp.asarray, args), d_inner, d_state, headdim,
                                   chunk, True)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    got = ssd_mega.fused_mamba_chain_torch(*map(_t, args), **dims)
    _close(got, want, 1e-4)
    # on CPU tensors the dispatcher runs the plain version
    assert torch.equal(ssd_mega.fused_mamba_chain(*map(_t, args), **dims), got)


def test_fused_chain_bf16_output_rounds_once():
    b, l, d_inner, d_state, headdim, chunk = CONFIGS[1]
    args = list(map(_t, _chain_inputs(1, b, l, d_inner, d_state, headdim)))
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    zx16 = args[0].bfloat16()
    got = ssd_mega.fused_mamba_chain_torch(zx16, *args[1:], **dims)
    assert got.dtype == torch.bfloat16
    want = ssd_mega.fused_mamba_chain_torch(zx16.float(), *args[1:], **dims)
    assert torch.equal(got, want.bfloat16())


def test_supports_shapes_is_the_jax_gate():
    for l in (64, 100, 128, 1024):
        for d_inner in (128, 192, 256):
            for d_state in (8, 12, 64):
                for headdim in (16, 24, 64):
                    for d_conv, chunk in ((4, 64), (10, 128), (4, 12)):
                        args = (l, d_inner, 1, d_state, headdim, d_conv, chunk)
                        assert ssd_mega.supports_shapes(*args) == jmega.supports_shapes(*args)
    assert not ssd_mega.supports_shapes(1024, 128, 2, 16, 32, 4, 128)


def test_fused_chain_dispatcher_refuses_autograd():
    b, l, d_inner, d_state, headdim, chunk = CONFIGS[1]
    args = list(map(_t, _chain_inputs(2, b, l, d_inner, d_state, headdim)))
    args[1].requires_grad_(True)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    with pytest.raises(RuntimeError, match="not differentiable"):
        ssd_mega.fused_mamba_chain(*args, **dims)
    with torch.no_grad():
        ssd_mega.fused_mamba_chain(*args, **dims)


@pytest.mark.parametrize("cfg", KERNEL_CONFIGS)
def test_kernel_bf16_bounds_catch_bf16_intermediates(cfg):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    b, l, d_inner, d_state, headdim, chunk = cfg
    args = list(map(_t, _chain_inputs(3, b, l, d_inner, d_state, headdim)))
    args[0] = args[0].bfloat16()
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    ref = ssd_mega.fused_mamba_chain_torch(*args, **dims).float()
    got = chip_smoke.bf16_intermediates_chain(*args, **dims).float()
    rms = (got - ref).pow(2).mean().sqrt().item() / ref.abs().max().item()
    assert rms > max(KERNEL_BF16_RMS, chip_smoke.MAMBA_TOL["bf16"][1]), rms

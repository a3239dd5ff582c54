"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc (Hopper, sm_90a) and no JAX; skipped on a
CPU-only machine. `tests/conftest.py` imports jax, so on the card run:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Each kernel and its plain version get the same inputs on the same card in
the working dtype, with TF32 off so the float32 references are true
float32. Tolerances (relative to the reference's largest magnitude):
- fp32 attention: 1e-5 — both accumulate in f32, only the summation order
  differs;
- bf16 kernels: max 2**-7 (two bf16 ulps: an f32 sum that lands next to a
  rounding boundary may round the other way, and the attention then feeds
  that flip through the bf16 probabilities), rms 2e-3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
from pixel_heal_thyself_tpu_torch.ops.attention import block_halo_attention_torch
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import block_halo_attention_cuda
from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
    conv3x3_cuda,
    conv3x3_torch,
    pointwise_gemm_cuda,
    pointwise_gemm_torch,
    transformer_block_fwd,
    transformer_block_torch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev, dtype, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).to(
        device=dev, dtype=dtype,
    )


def _assert_close(got, ref, max_rel, rms_rel):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    scale = ref.abs().max().item()
    err = (got - ref).abs()
    assert err.max().item() / scale <= max_rel, err.max().item() / scale
    rms = err.pow(2).mean().sqrt().item() / scale
    assert rms <= rms_rel, rms


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("halo,heads,residual", [(3, 4, False), (1, 2, True), (4, 4, False)])
def test_attention_kernel(dev, dtype, halo, heads, residual):
    rng = np.random.default_rng(0)
    b, h, w, c, bs = 2, 32, 48, 128, 8
    q, k, v = (_rand(rng, (b, h, w, c), dev, dtype) for _ in range(3))
    window = bs + 2 * halo
    rel_h = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    rel_w = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    res = _rand(rng, (b, h, w, c), dev, dtype) if residual else None
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads, residual=res)
    got = block_halo_attention_cuda(q, k, v, rel_h, rel_w, **kw)
    ref = block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _assert_close(got, ref, 1e-5, 1e-6)
    else:
        _assert_close(got, ref, 2**-7, 2e-3)


@pytest.mark.parametrize("m,k1,k2,n", [(4096, 256, 256, 256), (1000, 40, 0, 24), (777, 12, 20, 136)])
def test_pointwise_gemm_kernel(dev, m, k1, k2, n):
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    a1 = _rand(rng, (m, k1), dev, bf)
    w1 = _rand(rng, (k1, n), dev, bf, k1**-0.5)
    a2 = _rand(rng, (m, k2), dev, bf) if k2 else None
    w2 = _rand(rng, (k2, n), dev, bf, k2**-0.5) if k2 else None
    bias = _rand(rng, (n,), dev, bf, 0.1)
    for relu in (False, True):
        got = pointwise_gemm_cuda(a1, w1, a2, w2, bias, relu)
        ref = pointwise_gemm_torch(a1, w1, a2, w2, bias, relu)
        torch.cuda.synchronize()
        _assert_close(got, ref, 2**-7, 2e-3)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64, 64), (1, 9, 7, 12, 20)])
def test_conv3x3_kernel(dev, mode, shape):
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    b, h, w, c, n = shape
    x = _rand(rng, (b, h, w, c), dev, bf)
    wt = _rand(rng, (9 * c, n), dev, bf, (9 * c) ** -0.5)
    bias = _rand(rng, (n,), dev, bf, 0.1)
    res = _rand(rng, (b, h, w, n), dev, bf)
    for residual in (None, res):
        got = conv3x3_cuda(x, wt, bias, mode, relu=True, residual=residual)
        ref = conv3x3_torch(x, wt, bias, mode, relu=True, residual=residual)
        torch.cuda.synchronize()
        _assert_close(got, ref, 2**-7, 2e-3)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
def test_transformer_block_kernels(dev, mode):
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    b, h, w, c, heads, bs, halo = 2, 32, 32, 128, 4, 8, 3
    window = bs + 2 * halo
    x = _rand(rng, (b, h, w, c), dev, bf)
    a = _rand(rng, (b, h, w, c), dev, bf)
    wts = dict(
        wcat=_rand(rng, (2 * c, c), dev, bf, (2 * c) ** -0.5),
        bcat=_rand(rng, (c,), dev, bf, 0.1),
        wq=_rand(rng, (c, c), dev, bf, c**-0.5),
        wk=_rand(rng, (c, c), dev, bf, c**-0.5),
        wv=_rand(rng, (c, c), dev, bf, c**-0.5),
        rel_h=_rand(rng, (window, c // heads // 2), dev, torch.float32),
        rel_w=_rand(rng, (window, c // heads // 2), dev, torch.float32),
        w1=_rand(rng, (9 * c, c), dev, bf, (9 * c) ** -0.5),
        b1=_rand(rng, (c,), dev, bf, 0.1),
        w2=_rand(rng, (9 * c, c), dev, bf, (9 * c) ** -0.5),
        b2=_rand(rng, (c,), dev, bf, 0.1),
    )
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads, padding_mode=mode)
    got = transformer_block_fwd(x, a, **wts, **kw)
    ref = transformer_block_torch(x, a, **wts, **kw)
    torch.cuda.synchronize()
    # a bf16 flip in n_aux/q/k moves the probabilities and both convs carry
    # it on; the single-block golden bounds of tests/test_block_mega.py
    _assert_close(got, ref, 3e-2, 4e-3)


@pytest.mark.parametrize("dtype,block_route", [(torch.float32, False), (torch.bfloat16, True)])
def test_afgsanet_kernel_routes(dev, dtype, block_route):
    """The model on the card through the kernels (the literal route in
    fp32: K1 between library convs; the block route in bf16: K2/K1/K3)
    against the same weights through the plain versions."""
    kw = dict(base_ch=64, enc_ch=32, num_sa=2, num_heads=4, num_gcp=0,
              padding_mode="reflect", use_block_kernel=True, dtype=dtype, device=dev)
    g = torch.Generator().manual_seed(0)
    model = AFGSANet(**kw, use_kernels=True, generator=g).eval()
    plain = AFGSANet(**kw, use_kernels=False).eval()
    plain.load_state_dict(model.state_dict())
    assert model.block_route(2, 32, 48) is block_route
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 32, 48, 3), dev, torch.float32).abs()
    a = _rand(rng, (2, 32, 48, 7), dev, torch.float32)
    with torch.inference_mode():
        got, ref = model(x, a), plain(x, a)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _assert_close(got, ref, 1e-5, 1e-6)
    else:
        _assert_close(got, ref, 3e-2, 4e-3)

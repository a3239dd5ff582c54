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
  that flip through the bf16 probabilities), rms 2e-3;
- weight gradients (K6, f32 outputs of bf16 products, which are exact in
  f32): 1e-5 max, 1e-6 rms — only the f32 summation order differs;
- whole-block gradients: the bounds of tests/test_block_mega.py:238-260
  (images max 1e-1, rms 8e-3; weights rms 2.5e-2, total-mass fingerprint
  2e-2), because a pre-activation within one bf16 ulp of zero can land on
  the other side of a ReLU and move a full-size contribution;
- the fused Mamba2 interior (K7): every intermediate in f32 in both, one
  rounding at the output: fp32 1e-4 max, 1e-5 rms (summation order); bf16
  max 8e-3 (two bf16 ulps), rms 1e-4: at these small shapes one flip of
  the largest output moves the rms by up to 2**-7 / sqrt(16,384) = 6e-5,
  while the plain chain with xBC and y rounded to bf16 (which the TPU
  kernel never does) fails 1e-4 at every one of them
  (tests/test_torch_port_mamba_ops.py); chip_smoke.py holds the prod shape
  to 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
from pixel_heal_thyself_tpu_torch.ops.attention import (
    BlockHaloAttentionFn,
    block_halo_attention_bwd_torch,
    block_halo_attention_torch,
)
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (
    block_halo_attention_bwd_cuda,
    block_halo_attention_cuda,
)
from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
    PARAM_NAMES,
    BlockConfig,
    TransformerBlockFn,
    conv3x3_cuda,
    conv3x3_dgrad_cuda,
    conv3x3_dgrad_torch,
    conv3x3_torch,
    kernel_layout,
    pointwise_gemm_cuda,
    pointwise_gemm_torch,
    transformer_block_bwd,
    transformer_block_bwd_torch,
    transformer_block_fwd,
    transformer_block_torch,
    weight_grad_cuda,
    weight_grad_torch,
)

from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet
from pixel_heal_thyself_tpu_torch.ops.ssd_mega import fused_mamba_chain, fused_mamba_chain_torch
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_cuda

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


def _block_weights(rng, dev, c, heads, window, bf=torch.bfloat16):
    return dict(
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


def _assert_grad_close(name, got, ref, image: bool):
    """The whole-block gradient bounds (module docstring)."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), name
    scale = ref.abs().max().item() + 1e-12
    err = got - ref
    rms = err.pow(2).mean().sqrt().item() / scale
    if image:
        assert err.abs().max().item() / scale < 1e-1, name
        assert rms < 8e-3, (name, rms)
    else:
        assert rms < 2.5e-2, (name, rms)
        fdev = abs(got.abs().sum().item() - ref.abs().sum().item()) / (ref.abs().sum().item() + 1e-12)
        assert fdev < 2e-2, (name, fdev)


@pytest.mark.parametrize("dtype,halo", [(torch.bfloat16, 7), (torch.bfloat16, 8),
                                        (torch.float32, 5), (torch.float32, 8)])
def test_attention_kernel_key_chunked(dev, dtype, halo):
    """Windows whose one-stage plan exceeds 227 KB take the key-chunked
    two-pass K1 (head_ch 64)."""
    rng = np.random.default_rng(5)
    b, h, w, c, bs, heads = 1, 32, 32, 256, 8, 4
    q, k, v = (_rand(rng, (b, h, w, c), dev, dtype) for _ in range(3))
    window = bs + 2 * halo
    rel_h = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    rel_w = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    res = _rand(rng, (b, h, w, c), dev, dtype)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads, residual=res)
    got = block_halo_attention_cuda(q, k, v, rel_h, rel_w, **kw)
    ref = block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _assert_close(got, ref, 1e-5, 1e-6)
    else:
        _assert_close(got, ref, 2**-7, 2e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("halo,heads,c", [(3, 4, 128), (1, 2, 64), (4, 4, 128), (8, 4, 256)])
def test_attention_bwd_kernel(dev, dtype, halo, heads, c):
    """K4 against the plain backward: (dq, dk, dv) at the bounds of the
    forward, the f32 rel-bias gradients at the same bounds (their sums
    differ in order and, in bf16, by flipped dl roundings)."""
    rng = np.random.default_rng(6)
    b, h, w, bs = 2, 32, 48, 8
    q, k, v, do = (_rand(rng, (b, h, w, c), dev, dtype) for _ in range(4))
    window = bs + 2 * halo
    rel_h = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    rel_w = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads)
    got = block_halo_attention_bwd_cuda(q, k, v, rel_h, rel_w, do, **kw)
    ref = block_halo_attention_bwd_torch(q, k, v, rel_h, rel_w, do, **kw)
    again = block_halo_attention_bwd_cuda(q, k, v, rel_h, rel_w, do, **kw)
    torch.cuda.synchronize()
    tol = (1e-5, 1e-6) if dtype == torch.float32 else (2**-7, 2e-3)
    for g, r, a in zip(got, ref, again):
        _assert_close(g, r, *tol)
        assert torch.equal(g, a)  # deterministic: no float atomics


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64, 64), (1, 9, 7, 12, 20), (1, 2, 2, 8, 8)])
def test_conv3x3_dgrad_kernel(dev, mode, shape):
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    b, h, w, c, n = shape
    dy = _rand(rng, (b, h, w, n), dev, bf)
    gate = _rand(rng, (b, h, w, n), dev, bf)
    wt = _rand(rng, (9 * c, n), dev, bf, (9 * c) ** -0.5)
    res = _rand(rng, (b, h, w, c), dev, bf)
    for g, r in ((None, None), (gate, res)):
        got = conv3x3_dgrad_cuda(dy, g, wt, mode, residual=r)
        ref = conv3x3_dgrad_torch(dy, g, wt, mode, residual=r)
        torch.cuda.synchronize()
        _assert_close(got, ref, 2**-7, 2e-3)


@pytest.mark.parametrize("taps,mode", [(9, "zeros"), (9, "reflect"), (9, "replicate"), (1, "zeros")])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64, 64), (1, 9, 7, 12, 20)])
def test_weight_grad_kernel(dev, taps, mode, shape):
    rng = np.random.default_rng(8)
    bf = torch.bfloat16
    b, h, w, c, n = shape
    x = _rand(rng, (b, h, w, c), dev, bf)
    x2 = _rand(rng, (b, h, w, c + 8), dev, bf) if taps == 1 else None
    dy = _rand(rng, (b, h, w, n), dev, bf)
    gate = _rand(rng, (b, h, w, n), dev, bf)
    kw = dict(taps=taps, padding_mode=mode, colsum=True)
    dw, db = weight_grad_cuda(x, dy, gate, x2, **kw)
    rdw, rdb = weight_grad_torch(x, dy, gate, x2, **kw)
    dw2, db2 = weight_grad_cuda(x, dy, gate, x2, **kw)
    torch.cuda.synchronize()
    _assert_close(dw, rdw, 1e-5, 1e-6)
    _assert_close(db, rdb, 1e-5, 1e-6)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


def test_pointwise_gemm_pre_residual_and_conv_pre_output(dev):
    rng = np.random.default_rng(9)
    bf = torch.bfloat16
    a1, a2, res = (_rand(rng, (777, 136), dev, bf) for _ in range(3))
    w1 = _rand(rng, (136, 136), dev, bf, 136**-0.5)
    w2 = _rand(rng, (136, 136), dev, bf, 136**-0.5)
    got = pointwise_gemm_cuda(a1, w1, a2, w2, pre_residual=res)
    ref = pointwise_gemm_torch(a1, w1, a2, w2, pre_residual=res)
    x = _rand(rng, (2, 16, 24, 64), dev, bf)
    wc = _rand(rng, (9 * 64, 64), dev, bf, (9 * 64) ** -0.5)
    bias = _rand(rng, (64,), dev, bf, 0.1)
    out, pre = conv3x3_cuda(x, wc, bias, "replicate", True, x, return_pre=True)
    rout, rpre = conv3x3_torch(x, wc, bias, "replicate", True, x, return_pre=True)
    torch.cuda.synchronize()
    _assert_close(got, ref, 2**-7, 2e-3)
    _assert_close(out, rout, 2**-7, 2e-3)
    _assert_close(pre, rpre, 2**-7, 2e-3)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
def test_transformer_block_bwd_kernels(dev, mode):
    """The backward chain K6/K5 → K6/K5 → K4 → K6/K2 against the plain
    backward on the same forward residuals."""
    rng = np.random.default_rng(10)
    bf = torch.bfloat16
    b, h, w, c, heads, bs, halo = 2, 32, 32, 128, 4, 8, 3
    x, a, do = (_rand(rng, (b, h, w, c), dev, bf) for _ in range(3))
    wts = _block_weights(rng, dev, c, heads, bs + 2 * halo)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads, padding_mode=mode)
    _, x1, f1, f2 = transformer_block_torch(x, a, **wts, **kw, emit=True)
    got = transformer_block_bwd(x, a, x1, f1, f2, do, **wts, **kw)
    ref = transformer_block_bwd_torch(x, a, x1, f1, f2, do, **wts, **kw)
    torch.cuda.synchronize()
    names = ("dx", "da") + PARAM_NAMES
    for name, g, r in zip(names, got, ref):
        _assert_grad_close(f"{name}[{mode}]", g, r, image=name in ("dx", "da"))


def test_attention_autograd_through_kernels(dev):
    """`.backward()` through BlockHaloAttentionFn on the card (K1 + K4)
    gives every input a gradient equal to autograd through the plain
    forward (fp32: 1e-5)."""
    rng = np.random.default_rng(11)
    b, h, w, c, heads, bs, halo = 2, 16, 24, 64, 2, 8, 3
    window = bs + 2 * halo
    leaves = [_rand(rng, (b, h, w, c), dev, torch.float32).requires_grad_() for _ in range(4)]
    rels = [_rand(rng, (window, c // heads // 2), dev, torch.float32).requires_grad_()
            for _ in range(2)]
    q, k, v, res = leaves
    do = _rand(rng, (b, h, w, c), dev, torch.float32)
    BlockHaloAttentionFn.apply(q, k, v, *rels, res, bs, halo, heads).backward(do)
    got = [t.grad for t in leaves + rels]
    for t in leaves + rels:
        t.grad = None
    block_halo_attention_torch(q, k, v, *rels, block_size=bs, halo_size=halo,
                               num_heads=heads, residual=res).backward(do)
    for g, t in zip(got, leaves + rels):
        assert g is not None
        _assert_close(g, t.grad, 1e-5, 1e-6)


def test_block_autograd_through_kernels(dev):
    """`.backward()` through TransformerBlockFn on the card gives x, a and
    every f32 parameter a gradient close to autograd through the plain
    bf16 forward (the whole-block gradient bounds)."""
    rng = np.random.default_rng(12)
    b, h, w, c, heads, bs, halo = 2, 32, 32, 128, 4, 8, 3
    window = bs + 2 * halo
    x, a = (_rand(rng, (b, h, w, c), dev, torch.bfloat16).requires_grad_() for _ in range(2))
    shapes = dict(wcat=(c, 2 * c, 1, 1), bcat=(c,), wq=(c, c, 1, 1), wk=(c, c, 1, 1),
                  wv=(c, c, 1, 1), rel_h=(window, c // heads // 2),
                  rel_w=(window, c // heads // 2), w1=(c, c, 3, 3), b1=(c,),
                  w2=(c, c, 3, 3), b2=(c,))
    params = [_rand(rng, shapes[n], dev, torch.float32,
                    1.0 if n.startswith("rel") else float(np.prod(shapes[n][1:])) ** -0.5
                    ).requires_grad_() for n in PARAM_NAMES]
    do = _rand(rng, (b, h, w, c), dev, torch.bfloat16)
    cfg = BlockConfig(bs, halo, heads, "replicate", True)
    TransformerBlockFn.apply(cfg, x, a, *params).backward(do)
    got = [t.grad for t in [x, a, *params]]
    assert all(g is not None for g in got)
    assert all(g.dtype == torch.float32 for g in got[2:])
    for t in [x, a, *params]:
        t.grad = None
    kw = kernel_layout(torch.bfloat16, *params)
    transformer_block_torch(x, a, **kw, block_size=bs, halo_size=halo, num_heads=heads,
                            padding_mode="replicate").backward(do)
    for name, g, t in zip(("x", "a") + PARAM_NAMES, got, [x, a, *params]):
        _assert_grad_close(name, g, t.grad, image=name in ("x", "a"))


def test_cuda_wrappers_refuse_autograd(dev):
    q = torch.zeros(1, 8, 8, 16, device=dev, requires_grad=True)
    rel = torch.zeros(14, 4, device=dev)
    with pytest.raises(RuntimeError, match="not differentiable"):
        block_halo_attention_cuda(q, q, q, rel, rel, block_size=8, halo_size=3, num_heads=2)
    with torch.no_grad():
        block_halo_attention_cuda(q, q, q, rel, rel, block_size=8, halo_size=3, num_heads=2)


def _chain_inputs(rng, dev, dtype, b, l, d_inner, d_state, headdim, k=4):
    """tests/test_ssd_mega.py `_make_inputs`, on the card."""
    h = d_inner // headdim
    dc = d_inner + 2 * d_state
    f32 = torch.float32
    return (
        _rand(rng, (b, l, 2 * d_inner + 2 * d_state + h), dev, dtype, 0.5),
        _rand(rng, (k, dc), dev, f32, 0.2), _rand(rng, (dc,), dev, f32, 0.1),
        torch.as_tensor(rng.uniform(-4.0, -1.0, h), dtype=f32, device=dev),
        torch.as_tensor(-np.exp(rng.uniform(0.0, 1.5, h)), dtype=f32, device=dev),
        _rand(rng, (h,), dev, f32), 1.0 + _rand(rng, (d_inner,), dev, f32, 0.1),
    )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cfg", [(2, 256, 128, 64, 64, 64), (1, 128, 128, 32, 32, 32),
                                 (2, 192, 256, 64, 64, 64), (2, 1024, 128, 16, 32, 128),
                                 (1, 512, 256, 8, 128, 128), (1, 256, 128, 32, 8, 16)])
def test_fused_mamba_chain_kernel(dev, dtype, cfg):
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(np.random.default_rng(0), dev, dtype, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    before = fused_mamba_chain_cuda.launches
    got = fused_mamba_chain(*args, **dims)
    assert fused_mamba_chain_cuda.launches == before + 1
    ref = fused_mamba_chain_torch(*args, **dims)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, l, d_inner)
    if dtype == torch.float32:
        _assert_close(got, ref, 1e-4, 1e-5)
    else:
        _assert_close(got, ref, 8e-3, 1e-4)


def test_fused_mamba_chain_kernel_refuses(dev):
    args = _chain_inputs(np.random.default_rng(1), dev, torch.float32, 1, 128, 128, 16, 32)
    dims = dict(d_inner=128, d_state=16, headdim=32, chunk=128)
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fused_mamba_chain_cuda(*args, **dims)
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported shape"):
            fused_mamba_chain_cuda(*args, **dict(dims, chunk=96))
        with pytest.raises(ValueError, match="CUDA"):
            fused_mamba_chain_cuda(*(t.cpu() for t in args), **dims)
        # a shape the gate admits whose chunk needs more than 227 KB of
        # shared memory: the C entry refuses it before it launches
        big = _chain_inputs(np.random.default_rng(1), dev, torch.float32, 1, 128, 128, 128, 64)
        before = fused_mamba_chain_cuda.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            fused_mamba_chain_cuda(*big, d_inner=128, d_state=128, headdim=64, chunk=128)
        assert fused_mamba_chain_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_denoiser_kernel_route(dev, dtype):
    """A small MambaDenoiserNet: the kernel route against the plain one."""
    kw = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16, headdim=32, expansion=4,
              num_gcp=0, padding_mode="replicate", use_megakernel=True, dtype=dtype)
    model = MambaDenoiserNet(**kw, use_kernels=True, device=dev,
                             generator=torch.Generator().manual_seed(0)).eval()
    plain = MambaDenoiserNet(**kw, use_kernels=False, device=dev).eval()
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 32, 32, 3), dev, torch.float32).abs()
    aux = _rand(rng, (2, 32, 32, 7), dev, torch.float32)
    before = fused_mamba_chain_cuda.launches
    with torch.no_grad():
        got, ref = model(x, aux), plain(x, aux)
    assert fused_mamba_chain_cuda.launches == before + 2
    if dtype == torch.float32:
        _assert_close(got, ref, 1e-4, 1e-5)
    else:
        _assert_close(got, ref, 3e-2, 4e-3)

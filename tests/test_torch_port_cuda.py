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
  to 1e-5. K7's emit variant: the same bounds for its output, and for the
  entering states (f32 sums rounded once to the input dtype);
- the fused Mamba2 backward (K8) against `fused_mamba_chain_bwd_torch` at
  the same saved states: every intermediate f32 in both, so fp32 differs
  in summation order only: dzx 1e-4 max, 1e-5 rms; the parameter
  gradients, f32 sums over every token, 1e-4 max in both dtypes (they
  never round), rms 1e-5 for the conv and norm weights, while dt_bias, A
  and D have one entry per head (2 to 16 here), so their rms is about
  their max (1e-4). bf16 dzx rounds once, at the output: K7's bf16 bounds
  (8e-3 max, 1e-4 rms);
- the fused causal conv1d + SiLU (K9 forward, K10 backward): kernel and
  plain version round each f32 product and sum at the same points in the
  same order, so y and dx agree to the bit but where an exp differs in its
  last bit: fp32 1e-5, bf16 one ulp (2**-7 of the largest magnitude, rms
  1e-4); the tap and bias gradients are f32 sums in another order: 1e-4;
- the chunked SSD scan (K11): both round at the TPU kernel's points (the
  carried state included) from f32 sums in another order: fp32 1e-4 max,
  1e-5 rms; bf16 K7's small-shape bounds (8e-3 max, 1e-4 rms);
- the fold_qkv op on the card against autograd through its plain version:
  fp32 attention 1e-5, gradients 1e-4 (the plain backward is autograd's,
  not K4's order).
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
from pixel_heal_thyself_tpu_torch.ops import attention_cuda
from pixel_heal_thyself_tpu_torch.ops.attention import (
    QKVBlockHaloAttentionFn,
    qkv_block_halo_attention_torch,
)
from pixel_heal_thyself_tpu_torch.ops.conv_cuda import (
    ROWS,
    conv_bwd_body,
    conv_fwd_body,
    fused_causal_conv1d_silu_bwd_cuda,
    fused_causal_conv1d_silu_cuda,
)
from pixel_heal_thyself_tpu_torch.ops.conv_fused import (
    FusedConvSiluFn,
    fused_causal_conv1d_silu,
    fused_causal_conv1d_silu_bwd,
    fused_causal_conv1d_silu_bwd_torch,
    fused_causal_conv1d_silu_torch,
)
from pixel_heal_thyself_tpu_torch.ops.ssd import ssd_pallas, ssd_pallas_torch
from pixel_heal_thyself_tpu_torch.ops.ssd_cuda import (
    ssd_pallas_cuda,
    ssd_scan_body,
    ssd_scan_tc_smem,
)
from pixel_heal_thyself_tpu_torch.ops.ssd_mega import (
    MambaChainConfig,
    MambaChainFn,
    fused_mamba_chain,
    fused_mamba_chain_bwd,
    fused_mamba_chain_bwd_torch,
    fused_mamba_chain_emit,
    fused_mamba_chain_torch,
)
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
    fused_mamba_chain_bwd_cuda,
    fused_mamba_chain_cuda,
    fused_mamba_chain_emit_cuda,
    ssd_chain_body,
    ssd_prologue_body,
    ssd_prologue_cuda,
    ssd_tc_smem,
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


# widths 8 divides take K2's Hopper body (a ragged K and N: 40, 24), the
# others the general WMMA body; prod width at a row count 128 does not
# divide, one operand (k = n·Wk) and two with the f32 residual (the
# backward's dx)
@pytest.mark.parametrize("m,k1,k2,n,pre", [
    (4096, 256, 256, 256, False), (1000, 40, 0, 24, False), (777, 12, 20, 136, False),
    (131_072 - 40, 256, 0, 256, False), (131_072 - 40, 256, 256, 256, True),
])
def test_pointwise_gemm_kernel(dev, m, k1, k2, n, pre):
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    a1 = _rand(rng, (m, k1), dev, bf)
    w1 = _rand(rng, (k1, n), dev, bf, k1**-0.5)
    a2 = _rand(rng, (m, k2), dev, bf) if k2 else None
    w2 = _rand(rng, (k2, n), dev, bf, k2**-0.5) if k2 else None
    bias = _rand(rng, (n,), dev, bf, 0.1)
    res = _rand(rng, (m, n), dev, bf) if pre else None
    body = "sm90" if k1 % 8 == 0 and k2 % 8 == 0 and n % 8 == 0 else "general"
    for relu in (False, True):
        before = dict(pointwise_gemm_cuda.body_launches)
        got = pointwise_gemm_cuda(a1, w1, a2, w2, bias, relu, pre_residual=res)
        again = pointwise_gemm_cuda(a1, w1, a2, w2, bias, relu, pre_residual=res)
        ref = pointwise_gemm_torch(a1, w1, a2, w2, bias, relu, pre_residual=res)
        torch.cuda.synchronize()
        _assert_close(got, ref, 2**-7, 2e-3)
        assert torch.equal(got, again)
        assert pointwise_gemm_cuda.body_launches[body] == before[body] + 2


# the widths 8 divides take the Hopper bodies of K3/K6 (the prod width, a
# tile-ragged frame: 130 pixels), the others the general WMMA bodies; frames
# 64 divides load the image operand by TMA (prod; 64 channels, 136 outputs),
# the others gather it by cp.async
CONV_SHAPES = [(2, 16, 24, 64, 64), (1, 9, 7, 12, 20), (1, 32, 128, 256, 256),
               (1, 10, 13, 64, 72), (2, 6, 64, 64, 136)]


@pytest.mark.parametrize("a_mn_major,b_tma,b_k_major", [
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (0, 1, 1),
])
def test_sm90_wgmma_tile(dev, a_mn_major, b_tma, b_k_major):
    """One warpgroup's 64×256×64 product through sm90_gemm.cuh's layouts
    (A K-major as K2's, K3's and K5's, or MN-major as K6's; B MN-major as
    K2's, K3's and K6's, or K-major as K5's; B stored by the threads or
    loaded by TMA as the kernels load it), exact products of small integers
    summed in f32."""
    from pixel_heal_thyself_tpu_torch import _build

    rng = np.random.default_rng(11)
    a = torch.as_tensor(rng.integers(-4, 5, (64, 64)), dtype=torch.bfloat16, device=dev)
    b = torch.as_tensor(rng.integers(-4, 5, (64, 256)), dtype=torch.bfloat16, device=dev)
    d = torch.empty(64, 256, dtype=torch.float32, device=dev)
    staged = b.t().contiguous() if b_k_major else b  # K-major: Bᵀ [256, 64]
    err = _build.lib().pht_sm90_probe(a.data_ptr(), staged.data_ptr(), d.data_ptr(), a_mn_major,
                                     b_tma, b_k_major, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pht_sm90_probe")
    torch.cuda.synchronize()
    assert torch.equal(d, a.float() @ b.float())


def test_sm90_smem_matches_planner(dev):
    from pixel_heal_thyself_tpu_torch import _build
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import sm90_smem

    assert _build.lib().pht_weight_grad_sm90_smem() == sm90_smem()
    assert _build.lib().pht_conv3x3_sm90_smem() == sm90_smem()


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_kernel(dev, mode, shape):
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    b, h, w, c, n = shape
    x = _rand(rng, (b, h, w, c), dev, bf)
    wt = _rand(rng, (9 * c, n), dev, bf, (9 * c) ** -0.5)
    bias = _rand(rng, (n,), dev, bf, 0.1)
    res = _rand(rng, (b, h, w, n), dev, bf)
    body = "sm90" if c % 8 == 0 and n % 8 == 0 else "general"
    for residual in (None, res):
        before = dict(conv3x3_cuda.body_launches)
        got = conv3x3_cuda(x, wt, bias, mode, relu=True, residual=residual)
        ref = conv3x3_torch(x, wt, bias, mode, relu=True, residual=residual)
        torch.cuda.synchronize()
        _assert_close(got, ref, 2**-7, 2e-3)
        assert conv3x3_cuda.body_launches[body] == before[body] + 1


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


# (block, halo, heads, C): every halo 1..8 at block 8 (halo ≤ 4 keeps the
# logits / probabilities in registers, halo ≥ 5 walks the key tiles in
# passes), head_ch 16/32/48/64, block 4; fp32 takes the float32 body
TC_CASES = [(8, 1, 2, 64), (8, 2, 4, 128), (8, 3, 4, 256), (8, 4, 2, 96), (8, 5, 4, 256),
            (8, 6, 2, 64), (8, 7, 4, 256), (8, 8, 4, 128), (4, 2, 2, 64), (4, 4, 2, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs,halo,heads,c", TC_CASES)
def test_attention_tc_bodies(dev, dtype, bs, halo, heads, c):
    """K1's and K4's bodies (the gate's: the tensor-core body in bf16, the
    float32 one in fp32) against the plain versions, and the general body
    on the same inputs, at the dtype's bounds; K4 equal to the bit across
    two calls; the body counters: each wrapper call counts one launch of
    the body the gate picked and none of the others."""
    rng = np.random.default_rng(bs * 10 + halo)
    b, h, w = 2, 4 * bs, 6 * bs
    q, k, v, do, res = (_rand(rng, (b, h, w, c), dev, dtype) for _ in range(5))
    window = bs + 2 * halo
    rel_h = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    rel_w = _rand(rng, (window, c // heads // 2), dev, torch.float32)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads)
    body = attention_cuda.attention_body(dtype, c, heads, bs, halo)
    assert body == ("tc" if dtype == torch.bfloat16 else "f32")
    fwd, bwd = block_halo_attention_cuda, block_halo_attention_bwd_cuda
    before = (fwd.launches, dict(fwd.body_launches), bwd.launches, dict(bwd.body_launches))
    got = fwd(q, k, v, rel_h, rel_w, **kw, residual=res)
    grads = bwd(q, k, v, rel_h, rel_w, do, **kw)
    again = bwd(q, k, v, rel_h, rel_w, do, **kw)
    assert fwd.launches == before[0] + 1 and bwd.launches == before[2] + 2
    for name in fwd.body_launches:
        added = int(name == body)
        assert fwd.body_launches[name] == before[1][name] + added, name
        assert bwd.body_launches[name] == before[3][name] + 2 * added, name
    general = attention_cuda.attention_body_launch("general", q, k, v, rel_h, rel_w, **kw,
                                                   residual=res)
    general_grads = attention_cuda.attention_body_launch("general", q, k, v, rel_h, rel_w, do,
                                                         **kw)
    ref = block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw, residual=res)
    ref_grads = block_halo_attention_bwd_torch(q, k, v, rel_h, rel_w, do, **kw)
    torch.cuda.synchronize()
    tol = (1e-5, 1e-6) if dtype == torch.float32 else (2**-7, 2e-3)
    _assert_close(got, ref, *tol)
    _assert_close(general, ref, *tol)
    for g, a, gg, r in zip(grads, again, general_grads, ref_grads, strict=True):
        _assert_close(g, r, *tol)
        _assert_close(gg, r, *tol)
        assert torch.equal(g, a)  # deterministic: no float atomics


def test_attention_tc_gate_and_smem(dev):
    """Shapes neither fast body takes (fp32 head_ch 6, bf16 head_ch 8) run
    the general body, counted so; the tensor-core and float32 entries
    refuse them; each fast body's shared memory is its plan's
    (`attention_tc_plan`, `attention_f32_plan`) at every block, halo and
    head_ch it takes."""
    from pixel_heal_thyself_tpu_torch import _build

    lib = _build.lib()
    for bs in (4, 8):
        for halo in range(1, bs + 1):
            for hd in (16, 32, 48, 64):
                plan = attention_cuda.attention_tc_plan(bs, halo, hd)
                assert lib.pht_attention_tc_smem(0, bs, halo, hd) == plan.smem_fwd
                assert lib.pht_attention_tc_smem(1, bs, halo, hd) == plan.smem_bwd
            plan = attention_cuda.attention_f32_plan(bs, halo, 64)
            assert lib.pht_attention_f32_smem(0, bs, halo) == plan.smem_fwd
            assert lib.pht_attention_f32_smem(1, bs, halo) == plan.smem_bwd
    rng = np.random.default_rng(9)
    for dtype, c, heads in ((torch.float32, 12, 2), (torch.bfloat16, 32, 4)):
        q, do = (_rand(rng, (1, 16, 16, c), dev, dtype) for _ in range(2))
        rel = _rand(rng, (14, c // heads // 2), dev, torch.float32)
        kw = dict(block_size=8, halo_size=3, num_heads=heads)
        gen = block_halo_attention_cuda.body_launches["general"]
        block_halo_attention_cuda(q, q, q, rel, rel, **kw)
        assert block_halo_attention_cuda.body_launches["general"] == gen + 1
        gen = block_halo_attention_bwd_cuda.body_launches["general"]
        block_halo_attention_bwd_cuda(q, q, q, rel, rel, do, **kw)
        assert block_halo_attention_bwd_cuda.body_launches["general"] == gen + 1
        for grad in (None, do):
            for body in ("tc", "f32"):
                with pytest.raises(RuntimeError, match=f"{body} body"):
                    attention_cuda.attention_body_launch(body, q, q, q, rel, rel, grad, **kw)


@pytest.mark.parametrize("mode", ["replicate", "reflect", "zeros"])
@pytest.mark.parametrize("halo", range(1, 9))
def test_attention_f32_bodies(dev, halo, mode):
    """K1's and K4's float32 body (one chunk of keys at halo ≤ 3, two or
    three chunks beyond) and the general body against the plain versions
    at every halo 1..8 (block 8, head_ch 64 and 16), within the fp32
    bounds; K4 equal to the bit across two calls; each call counted on the
    f32 body. Then a float32 TransformerBlock on the literal route in the
    padding mode (K1 and K4 between cuDNN convs) against the same block on
    the plain route, forward at the fp32 attention bounds and every gradient
    at 1e-4 / 1e-5 (f32 sums over every pixel in another order, as the
    weight gradients' bound); cuDNN deterministic, so that the convs add
    nothing of their own."""
    rng = np.random.default_rng(100 + 10 * halo + len(mode))
    bs, heads = 8, 4
    window = bs + 2 * halo
    fwd, bwd = block_halo_attention_cuda, block_halo_attention_bwd_cuda
    for c in (256, 64):
        q, k, v, do, res = (_rand(rng, (2, 24, 32, c), dev, torch.float32) for _ in range(5))
        rel_h = _rand(rng, (window, c // heads // 2), dev, torch.float32)
        rel_w = _rand(rng, (window, c // heads // 2), dev, torch.float32)
        kw = dict(block_size=bs, halo_size=halo, num_heads=heads)
        assert attention_cuda.attention_body(torch.float32, c, heads, bs, halo, q) == "f32"
        before = (dict(fwd.body_launches), dict(bwd.body_launches))
        got = fwd(q, k, v, rel_h, rel_w, **kw, residual=res)
        grads = bwd(q, k, v, rel_h, rel_w, do, **kw)
        again = bwd(q, k, v, rel_h, rel_w, do, **kw)
        assert fwd.body_launches["f32"] == before[0]["f32"] + 1
        assert bwd.body_launches["f32"] == before[1]["f32"] + 2
        general = attention_cuda.attention_body_launch("general", q, k, v, rel_h, rel_w, **kw,
                                                       residual=res)
        general_grads = attention_cuda.attention_body_launch("general", q, k, v, rel_h, rel_w,
                                                             do, **kw)
        ref = block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw, residual=res)
        ref_grads = block_halo_attention_bwd_torch(q, k, v, rel_h, rel_w, do, **kw)
        torch.cuda.synchronize()
        _assert_close(got, ref, 1e-5, 1e-6)
        _assert_close(general, ref, 1e-5, 1e-6)
        for g, a, gg, r in zip(grads, again, general_grads, ref_grads, strict=True):
            _assert_close(g, r, 1e-5, 1e-6)
            _assert_close(gg, r, 1e-5, 1e-6)
            assert torch.equal(g, a)  # deterministic: no float atomics

    from pixel_heal_thyself_tpu_torch.models.afgsa import TransformerBlock

    c = 64
    blocks = []
    for use_kernels in (True, False):
        blk = TransformerBlock(c, block_size=bs, halo_size=halo, num_heads=heads,
                               padding_mode=mode, use_kernels=use_kernels, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(halo))
        blocks.append(blk.to(dev))
    blocks[1].load_state_dict(blocks[0].state_dict())
    x, a, dy = (_rand(rng, (2, 24, 32, c), dev, torch.float32) for _ in range(3))
    outs, grads = [], []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for blk in blocks:
            xi, ai = x.clone().requires_grad_(), a.clone().requires_grad_()
            before = fwd.body_launches["f32"], bwd.body_launches["f32"]
            out, _ = blk(xi, ai)
            out.backward(dy)
            launched = (fwd.body_launches["f32"] - before[0], bwd.body_launches["f32"] - before[1])
            assert launched == ((1, 1) if blk.use_kernels else (0, 0)), launched
            outs.append(out.detach())
            grads.append([xi.grad, ai.grad] + [p.grad for p in blk.parameters()])
    finally:
        torch.backends.cudnn.deterministic = prev
    torch.cuda.synchronize()
    _assert_close(outs[0], outs[1], 1e-5, 1e-6)
    for g, r in zip(grads[0], grads[1], strict=True):
        assert g is not None and r is not None
        _assert_close(g, r, 1e-4, 1e-5)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("shape", [*CONV_SHAPES, (1, 2, 2, 8, 8)])
def test_conv3x3_dgrad_kernel(dev, mode, shape):
    """K5 (the prod width, frames 64 divides and does not, widths 8 does not
    divide) with and without the gate and the residual: the body that took
    the launch, and two calls equal to the bit."""
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    b, h, w, c, n = shape
    dy = _rand(rng, (b, h, w, n), dev, bf)
    gate = _rand(rng, (b, h, w, n), dev, bf)
    wt = _rand(rng, (9 * c, n), dev, bf, (9 * c) ** -0.5)
    res = _rand(rng, (b, h, w, c), dev, bf)
    body = "sm90" if c % 8 == 0 and n % 8 == 0 else "general"
    for g, r in ((None, None), (gate, None), (None, res), (gate, res)):
        before = dict(conv3x3_dgrad_cuda.body_launches)
        got = conv3x3_dgrad_cuda(dy, g, wt, mode, residual=r)
        again = conv3x3_dgrad_cuda(dy, g, wt, mode, residual=r)
        ref = conv3x3_dgrad_torch(dy, g, wt, mode, residual=r)
        torch.cuda.synchronize()
        _assert_close(got, ref, 2**-7, 2e-3)
        assert torch.equal(got, again)
        assert conv3x3_dgrad_cuda.body_launches[body] == before[body] + 2


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64, 64), (1, 32, 128, 256, 256), (1, 10, 13, 64, 72),
                                   (1, 3, 3, 8, 8), (1, 2, 2, 8, 8)])
def test_conv3x3_dgrad_fold_prepass(dev, mode, shape):
    """K5's fold pre-pass (WMMA; f32 sums of exact bf16 products) against
    `dgrad_fold_torch`, in the side buffer's layout."""
    from pixel_heal_thyself_tpu_torch import _build
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
        PAD_MODES,
        dgrad_fold_floats,
        dgrad_fold_torch,
    )

    rng = np.random.default_rng(13)
    bf = torch.bfloat16
    b, h, w, c, n = shape
    g = _rand(rng, (b, h, w, n), dev, bf)
    wt = _rand(rng, (9 * c, n), dev, bf, (9 * c) ** -0.5)
    fold = torch.full((dgrad_fold_floats(b, h, w, c, mode),), float("nan"), device=dev)
    err = _build.lib().pht_conv3x3_dgrad_fold(g.data_ptr(), wt.data_ptr(), fold.data_ptr(),
                                              b, h, w, n, c, PAD_MODES[mode],
                                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pht_conv3x3_dgrad_fold")
    ref = dgrad_fold_torch(g, wt, mode)
    torch.cuda.synchronize()
    _assert_close(fold, ref, 1e-5, 1e-6)


@pytest.mark.parametrize("taps,mode", [(9, "zeros"), (9, "reflect"), (9, "replicate"), (1, "zeros")])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_weight_grad_kernel(dev, taps, mode, shape):
    rng = np.random.default_rng(8)
    bf = torch.bfloat16
    b, h, w, c, n = shape
    x = _rand(rng, (b, h, w, c), dev, bf)
    x2 = _rand(rng, (b, h, w, c + 8), dev, bf) if taps == 1 else None
    dy = _rand(rng, (b, h, w, n), dev, bf)
    gate = _rand(rng, (b, h, w, n), dev, bf)
    kw = dict(taps=taps, padding_mode=mode, colsum=True)
    body = "sm90" if c % 8 == 0 and n % 8 == 0 else "general"
    before = dict(weight_grad_cuda.body_launches)
    dw, db = weight_grad_cuda(x, dy, gate, x2, **kw)
    rdw, rdb = weight_grad_torch(x, dy, gate, x2, **kw)
    dw2, db2 = weight_grad_cuda(x, dy, gate, x2, **kw)
    torch.cuda.synchronize()
    _assert_close(dw, rdw, 1e-5, 1e-6)
    _assert_close(db, rdb, 1e-5, 1e-6)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert weight_grad_cuda.body_launches[body] == before[body] + 2


@pytest.mark.parametrize("gate,colsum", [(False, True), (True, False)])
def test_weight_grad_two_operand_prod_width(dev, gate, colsum):
    """The one-tap two-operand K6 ([x; a]ᵀ·dz, C1 = C2 = 256) on the
    Hopper body, with and without the ReLU gate and db."""
    rng = np.random.default_rng(12)
    bf = torch.bfloat16
    b, h, w, c = 1, 32, 128, 256
    x, a, dz, g = (_rand(rng, (b, h, w, c), dev, bf) for _ in range(4))
    g = g if gate else None
    before = weight_grad_cuda.body_launches["sm90"]
    dw, db = weight_grad_cuda(x, dz, g, a, colsum=colsum)
    rdw, rdb = weight_grad_torch(x, dz, g, a, colsum=colsum)
    dw2, db2 = weight_grad_cuda(x, dz, g, a, colsum=colsum)
    torch.cuda.synchronize()
    assert weight_grad_cuda.body_launches["sm90"] == before + 2
    assert dw.shape == (2 * c, c)
    _assert_close(dw, rdw, 1e-5, 1e-6)
    assert torch.equal(dw, dw2)
    if colsum:
        _assert_close(db, rdb, 1e-5, 1e-6)
        assert torch.equal(db, db2)
    else:
        assert db is None and rdb is None


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


def test_tf32x3_fragment_product(dev):
    """tf32x3.cuh's fragment product (K7's and K8's tensor-core bodies) on one
    64×64×64 tile against an f64 product: the 3×TF32 split lands within
    2**-20 of the largest output, and one tf32 pass, which the split exists
    to avoid, does not. A fragment-layout mismatch gives wrong numbers here
    before it gives them in a kernel."""
    from pixel_heal_thyself_tpu_torch import _build

    rng = np.random.default_rng(11)
    a, b = rng.standard_normal((64, 64)), rng.standard_normal((64, 64))
    ref = a.astype(np.float32).astype(np.float64) @ b.astype(np.float32).astype(np.float64)
    errs = {}
    for passes in (3, 1):
        ta, tb = (torch.as_tensor(m, dtype=torch.float32, device=dev) for m in (a, b))
        d = torch.empty(64, 64, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_build.lib().pht_tf32x3_probe(ta.data_ptr(), tb.data_ptr(), d.data_ptr(),
                                                   passes, stream), "tf32x3 probe")
        torch.cuda.synchronize()
        errs[passes] = np.abs(d.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert errs[3] <= 2**-20, errs
    assert errs[1] > 2**-20, errs


@pytest.mark.parametrize("d_state,headdim,chunk", [
    (64, 64, 128), (16, 32, 128), (32, 32, 32), (48, 16, 96), (64, 64, 64), (8, 128, 128),
    (32, 8, 16), (128, 64, 128), (64, 128, 128), (64, 64, 48),
])
def test_ssd_chain_body_matches_library(dev, d_state, headdim, chunk):
    """The library's body choice and tensor-core shared memory are what
    `ssd_chain_body` and `ssd_tc_smem` state."""
    from pixel_heal_thyself_tpu_torch import _build

    lib = _build.lib()
    body = "tc" if lib.pht_ssd_chain_body(chunk, d_state, headdim) else "general"
    assert body == ssd_chain_body(d_state, headdim, chunk)
    for i, (name, size) in enumerate(ssd_tc_smem(d_state, headdim, chunk).items()):
        assert lib.pht_ssd_chain_tc_smem(chunk, d_state, headdim, i) == size, name


# the prod width at one sequence of 1,024 tokens takes the tensor-core body;
# so do the first four; d_state 8 and headdim 8 take the general body
MAMBA_CONFIGS = [(2, 256, 128, 64, 64, 64), (1, 128, 128, 32, 32, 32), (2, 192, 256, 64, 64, 64),
                 (2, 1024, 128, 16, 32, 128), (1, 512, 256, 8, 128, 128), (1, 256, 128, 32, 8, 16),
                 (1, 1024, 1024, 64, 64, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cfg", MAMBA_CONFIGS)
def test_fused_mamba_chain_kernel(dev, dtype, cfg):
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(np.random.default_rng(0), dev, dtype, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    before = fused_mamba_chain_cuda.launches
    body = ssd_chain_body(d_state, headdim, chunk)
    bodies = dict(fused_mamba_chain_cuda.body_launches)
    got = fused_mamba_chain(*args, **dims)
    assert fused_mamba_chain_cuda.launches == before + 1
    assert fused_mamba_chain_cuda.body_launches[body] == bodies[body] + 1
    assert torch.equal(got, fused_mamba_chain(*args, **dims))
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


MAMBA_BOUNDS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (8e-3, 1e-4)}
# conv_w, conv_b, dt_bias, A, D, norm_w
PARAM_GRAD_BOUNDS = ((1e-4, 1e-5), (1e-4, 1e-5), (1e-4, 1e-4), (1e-4, 1e-4), (1e-4, 1e-4),
                     (1e-4, 1e-5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cfg", MAMBA_CONFIGS)
def test_fused_mamba_chain_emit_kernel(dev, dtype, cfg):
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(np.random.default_rng(0), dev, dtype, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    before = fused_mamba_chain_emit_cuda.launches
    body = ssd_chain_body(d_state, headdim, chunk)
    bodies = dict(fused_mamba_chain_emit_cuda.body_launches)
    got, states = fused_mamba_chain_emit(*args, **dims)
    assert fused_mamba_chain_emit_cuda.launches == before + 1
    assert fused_mamba_chain_emit_cuda.body_launches[body] == bodies[body] + 1
    again, states_again = fused_mamba_chain_emit(*args, **dims)
    assert torch.equal(got, again) and torch.equal(states, states_again)
    ref, ref_states = fused_mamba_chain_torch(*args, **dims, emit=True)
    torch.cuda.synchronize()
    h = d_inner // headdim
    assert states.dtype == dtype and states.shape == (b, l // chunk, h, d_state, headdim)
    _assert_close(got, ref, *MAMBA_BOUNDS[dtype])
    _assert_close(states, ref_states, *MAMBA_BOUNDS[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cfg", MAMBA_CONFIGS)
def test_fused_mamba_chain_bwd_kernel(dev, dtype, cfg):
    b, l, d_inner, d_state, headdim, chunk = cfg
    rng = np.random.default_rng(1)
    args = _chain_inputs(rng, dev, dtype, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    _, states = fused_mamba_chain_torch(*args, **dims, emit=True)
    dy = _rand(rng, (b, l, d_inner), dev, dtype)
    before = fused_mamba_chain_bwd_cuda.launches
    body = ssd_chain_body(d_state, headdim, chunk)
    bodies = dict(fused_mamba_chain_bwd_cuda.body_launches)
    got = fused_mamba_chain_bwd(*args, states, dy, **dims)
    assert fused_mamba_chain_bwd_cuda.launches == before + 1
    assert fused_mamba_chain_bwd_cuda.body_launches[body] == bodies[body] + 1
    again = fused_mamba_chain_bwd(*args, states, dy, **dims)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = fused_mamba_chain_bwd_torch(*args, states, dy, **dims)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[0].shape == args[0].shape
    _assert_close(got[0], ref[0], *MAMBA_BOUNDS[dtype])
    for g, r, p, bound in zip(got[1:], ref[1:], args[1:], PARAM_GRAD_BOUNDS):
        assert g.dtype == p.dtype and g.shape == p.shape
        _assert_close(g, r, *bound)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_chain_fn_kernels_match_plain_pair(dev, dtype):
    """`MambaChainFn` through K7-emit and K8 against the plain pair."""
    b, l, d_inner, d_state, headdim, chunk = MAMBA_CONFIGS[0]
    rng = np.random.default_rng(2)
    base = _chain_inputs(rng, dev, dtype, b, l, d_inner, d_state, headdim)
    dy = _rand(rng, (b, l, d_inner), dev, dtype)
    grads = []
    for use_kernels in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in base]
        cfg = MambaChainConfig(d_inner, d_state, headdim, chunk, use_kernels)
        counts = fused_mamba_chain_emit_cuda.launches, fused_mamba_chain_bwd_cuda.launches
        MambaChainFn.apply(cfg, *leaves).backward(dy)
        launched = (fused_mamba_chain_emit_cuda.launches - counts[0],
                    fused_mamba_chain_bwd_cuda.launches - counts[1])
        assert launched == ((1, 1) if use_kernels else (0, 0))
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    _assert_close(grads[0][0], grads[1][0], *MAMBA_BOUNDS[dtype])
    for g, r, bound in zip(grads[0][1:], grads[1][1:], PARAM_GRAD_BOUNDS):
        _assert_close(g, r, *bound)


def test_fused_mamba_chain_bwd_kernel_refuses(dev):
    args = _chain_inputs(np.random.default_rng(3), dev, torch.float32, 1, 128, 128, 16, 32)
    dims = dict(d_inner=128, d_state=16, headdim=32, chunk=128)
    _, states = fused_mamba_chain_torch(*args, **dims, emit=True)
    dy = torch.zeros(1, 128, 128, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mamba_chain_bwd_cuda(*(t.cpu() for t in args), states.cpu(), dy.cpu(), **dims)
    with pytest.raises(ValueError, match="do not match"):
        fused_mamba_chain_bwd_cuda(*args, states[:, :, :1], dy, **dims)
    # a shape the gate admits whose chunk needs more than 227 KB of shared
    # memory: the C entry refuses it before it launches
    big = _chain_inputs(np.random.default_rng(3), dev, torch.float32, 1, 128, 128, 128, 64)
    big_dims = dict(d_inner=128, d_state=128, headdim=64, chunk=128)
    states = torch.zeros(1, 1, 2, 128, 64, device=dev)
    before = fused_mamba_chain_bwd_cuda.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_mamba_chain_bwd_cuda(*big, states, dy, **big_dims)
    assert fused_mamba_chain_bwd_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_denoiser_kernel_route_grads(dev, dtype):
    """A small MambaDenoiserNet in grad mode: the kernel route against the
    plain route, every layer through K7-emit and K8."""
    kw = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16, headdim=32, expansion=4,
              num_gcp=0, padding_mode="replicate", use_megakernel=True, dtype=dtype)
    model = MambaDenoiserNet(**kw, use_kernels=True, device=dev,
                             generator=torch.Generator().manual_seed(0))
    plain = MambaDenoiserNet(**kw, use_kernels=False, device=dev)
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 32, 32, 3), dev, torch.float32).abs()
    aux = _rand(rng, (2, 32, 32, 7), dev, torch.float32)
    counts = fused_mamba_chain_emit_cuda.launches, fused_mamba_chain_bwd_cuda.launches
    model(x, aux).square().mean().backward()
    assert (fused_mamba_chain_emit_cuda.launches, fused_mamba_chain_bwd_cuda.launches) == (
        counts[0] + 2, counts[1] + 2)
    plain(x, aux).square().mean().backward()
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        if q.grad is None:  # the aux encoder: no block consumes it
            assert p.grad is None, name
            continue
        if dtype == torch.float32:
            _assert_close(p.grad, q.grad, 1e-4, 1e-5)
        else:
            _assert_grad_close(name, p.grad, q.grad, image=False)


# (b, l, columns, offset, width, k): the prod window at a short l; l not a
# multiple of the CTA's ROWS; k from 1 to 9; an unaligned window
CONV_CASES = [(1, 1024, 2192, 1024, 1152, 4), (2, 300, 512, 128, 256, 4),
              (2, 77, 100, 10, 50, 3), (1, 5, 40, 0, 40, 1), (1, 600, 300, 17, 200, 9)]
CONV_BOUNDS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CONV_CASES)
def test_fused_conv_silu_kernels(dev, dtype, case):
    b, l, ctot, off, width, k = case
    rng = np.random.default_rng(5)
    z = _rand(rng, (b, l, ctot), dev, dtype)
    w = _rand(rng, (k, width), dev, torch.float32, 0.3)
    bias = _rand(rng, (width,), dev, torch.float32, 0.1)
    dy = _rand(rng, (b, l, width), dev, dtype)
    counts = fused_causal_conv1d_silu_cuda.launches, fused_causal_conv1d_silu_bwd_cuda.launches
    got = fused_causal_conv1d_silu(z, w, bias, off, width)
    got_bwd = fused_causal_conv1d_silu_bwd(z, w, bias, dy, off, width)
    assert (fused_causal_conv1d_silu_cuda.launches,
            fused_causal_conv1d_silu_bwd_cuda.launches) == (counts[0] + 1, counts[1] + 1)
    ref = fused_causal_conv1d_silu_torch(z, w, bias, off, width)
    ref_bwd = fused_causal_conv1d_silu_bwd_torch(z, w, bias, dy, off, width)
    torch.cuda.synchronize()
    assert got.dtype == got_bwd[0].dtype == dtype and got.shape == (b, l, width)
    _assert_close(got, ref, *CONV_BOUNDS[dtype])
    _assert_close(got_bwd[0], ref_bwd[0], *CONV_BOUNDS[dtype])
    for g, r in zip(got_bwd[1:], ref_bwd[1:]):
        assert g.dtype == torch.float32
        _assert_close(g, r, 1e-4, 1e-4)


def test_fused_conv_silu_fn_and_refusals(dev):
    rng = np.random.default_rng(6)
    z = _rand(rng, (2, 256, 512), dev, torch.bfloat16).requires_grad_(True)
    w = _rand(rng, (4, 256), dev, torch.float32, 0.3).requires_grad_(True)
    bias = _rand(rng, (256,), dev, torch.float32, 0.1).requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fused_causal_conv1d_silu_cuda(z, w, bias, 128, 256)
    FusedConvSiluFn.apply(z, w, bias, 128, 256, True).float().square().sum().backward()
    grads = [t.grad.clone() for t in (z, w, bias)]
    for t in (z, w, bias):
        t.grad = None
    FusedConvSiluFn.apply(z, w, bias, 128, 256, False).float().square().sum().backward()
    assert not grads[0][..., :128].any() and not grads[0][..., 384:].any()
    # dy = 2y differs by the flips of y: the gradients agree to a few ulps
    _assert_close(grads[0], z.grad, 2**-6, 1e-3)
    for g, t in zip(grads[1:], (w, bias)):
        _assert_close(g, t.grad, 1e-3, 1e-4)
    with torch.no_grad():
        with pytest.raises(ValueError, match="window"):
            fused_causal_conv1d_silu_cuda(z, w, bias, 300, 256)
        with pytest.raises(ValueError, match="CUDA"):
            fused_causal_conv1d_silu_cuda(z.cpu(), w.cpu(), bias.cpu(), 128, 256)


# (b, l, heads, headdim, d_state, chunk): the prod head shape in one chunk
# (a single-chunk sequence), several chunks, narrow heads
SCAN_CASES = [(1, 128, 16, 64, 64, 128), (2, 512, 4, 32, 16, 64), (2, 96, 2, 8, 8, 32),
              (1, 1024, 8, 64, 64, 128)]
SCAN_BOUNDS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (8e-3, 1e-4)}


def _scan_inputs(rng, dev, dtype, b, l, h, p, n, a_dtype=torch.float32):
    """Mamba-like SSD inputs: dt log-uniform on [0.001, 0.1], A in -[1, 16]."""
    return (
        _rand(rng, (b, l, h, p), dev, dtype),
        torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, l, h))),
                        dtype=torch.float32).to(device=dev, dtype=dtype),
        torch.as_tensor(-rng.uniform(1, 16, h), dtype=torch.float32).to(device=dev, dtype=a_dtype),
        _rand(rng, (b, l, 1, n), dev, dtype), _rand(rng, (b, l, 1, n), dev, dtype),
        _rand(rng, (h,), dev, torch.float32),
    )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_pallas_kernel(dev, dtype, case):
    b, l, h, p, n, chunk = case
    rng = np.random.default_rng(7)
    # A in bf16 with bf16 dt: dt·A formed in bf16 (the round_dA path)
    for a_dtype in (torch.float32, dtype):
        args = _scan_inputs(rng, dev, dtype, b, l, h, p, n, a_dtype)
        for with_d in (True, False):
            a = args if with_d else args[:5]
            before = ssd_pallas_cuda.launches
            got = ssd_pallas(*a, chunk=chunk)
            assert ssd_pallas_cuda.launches == before + 1
            ref = ssd_pallas_torch(*a, chunk=chunk)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (b, l, h, p)
            _assert_close(got, ref, *SCAN_BOUNDS[dtype])


def test_ssd_pallas_kernel_refuses(dev):
    rng = np.random.default_rng(8)
    args = list(_scan_inputs(rng, dev, torch.float32, 1, 128, 2, 8, 8))
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported shapes"):
            ssd_pallas_cuda(*args, chunk=96)
        with pytest.raises(ValueError, match="CUDA"):
            ssd_pallas_cuda(*(t.cpu() for t in args), chunk=64)
        before = ssd_pallas_cuda.launches
        fallback = ssd_pallas(*args, chunk=96)  # l % chunk: ssd_chunked, as the JAX function
        assert ssd_pallas_cuda.launches == before and fallback.shape == args[0].shape
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        ssd_pallas_cuda(*args, chunk=64)


def test_ssd_scan_body_matches_library(dev):
    """K11's body gate in Python (`ssd_scan_body`) and in C
    (`pht_ssd_scan_body`) agree, and so do the tensor-core kernels' shared
    memory sizes (`pht_ssd_scan_tc_smem`)."""
    from pixel_heal_thyself_tpu_torch import _build

    lib = _build.lib()
    for dtype in (torch.bfloat16, torch.float32):
        for q in (8, 16, 32, 48, 64, 128, 144, 256):
            for n in (8, 16, 32, 48, 64, 80, 128):
                for p in (8, 16, 32, 64, 96, 128):
                    c = "tc" if lib.pht_ssd_scan_body(q, n, p, int(dtype == torch.bfloat16)) \
                        else "general"
                    assert ssd_scan_body(dtype, n, p, q) == c, (dtype, q, n, p)
                    if c == "tc":
                        sizes = ssd_scan_tc_smem(n, p, q)
                        assert (sizes["state"], sizes["output"]) == (
                            lib.pht_ssd_scan_tc_smem(0, q, n, p),
                            lib.pht_ssd_scan_tc_smem(1, q, n, p))


# (b, l, heads, headdim, d_state, chunk): the prod shape; several chunks at
# narrow heads; chunk 16 and 48; d_state above the chunk
SCAN_TC_CASES = [(8, 16384, 16, 64, 64, 128), (2, 512, 4, 32, 16, 64), (1, 256, 3, 16, 48, 16),
                 (2, 480, 5, 48, 32, 48), (1, 256, 2, 64, 64, 32)]


@pytest.mark.parametrize("case", SCAN_TC_CASES)
def test_ssd_pallas_tc_body(dev, case):
    """K11's tensor-core body (bf16) against the plain version at SCAN_BOUNDS
    (chip_smoke holds the prod shape to SSD_SCAN_TOL); two calls equal to
    the bit; the same shape in fp32 takes the general body."""
    b, l, h, p, n, chunk = case
    rng = np.random.default_rng(11)
    args = _scan_inputs(rng, dev, torch.bfloat16, b, l, h, p, n)
    bodies = dict(ssd_pallas_cuda.body_launches)
    got = ssd_pallas(*args, chunk=chunk)
    again = ssd_pallas(*args, chunk=chunk)
    assert ssd_pallas_cuda.body_launches["tc"] == bodies["tc"] + 2
    ref = ssd_pallas_torch(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, ref, *SCAN_BOUNDS[torch.bfloat16])
    if l <= 4096:
        a32 = tuple(t.float() if t.dim() > 1 else t for t in args)
        bodies = dict(ssd_pallas_cuda.body_launches)
        got = ssd_pallas(*a32, chunk=chunk)
        assert ssd_pallas_cuda.body_launches["general"] == bodies["general"] + 1
        _assert_close(got, ssd_pallas_torch(*a32, chunk=chunk), *SCAN_BOUNDS[torch.float32])


def test_conv_bwd_body_matches_library(dev):
    """K10's body gate in Python (`conv_bwd_body`) and in C
    (`pht_conv_silu_bwd_body`) agree."""
    from pixel_heal_thyself_tpu_torch import _build

    lib = _build.lib()
    for dtype in (torch.bfloat16, torch.float32):
        for cols in (40, 100, 512, 2192, 2196):
            for off in (0, 4, 8, 10, 17, 1024):
                for width in (4, 8, 50, 200, 256, 1152):
                    c = lib.pht_conv_silu_bwd_body(cols, off, width,
                                                   int(dtype == torch.bfloat16))
                    assert conv_bwd_body(dtype, cols, off, width) == ("vec" if c else "general")


# (b, l, columns, offset, width, k, body in bf16, body in fp32): the prod
# window; l not a multiple of the CTA's rows; an offset or a width that is
# a multiple of 4 elements only; fewer rows than the ring
CONV_BODY_CASES = [(8, 16384, 2192, 1024, 1152, 4, "vec", "vec"),
                   (2, 300, 512, 128, 256, 4, "vec", "vec"),
                   (2, 260, 516, 4, 256, 4, "general", "vec"),
                   (1, 100, 512, 128, 252, 3, "general", "vec"),
                   (1, 5, 40, 0, 40, 2, "vec", "vec")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CONV_BODY_CASES)
def test_conv_bwd_bodies(dev, dtype, case):
    """K10 takes its vec body where the window is 16-byte aligned and its
    general body elsewhere (`body_launches`); either body's dx equals the
    plain version's to the bit (both round each product and sum in the same
    order); dw and db are f32 sums in another order (1e-4)."""
    b, l, cols, off, width, k, body16, body32 = case
    body = body16 if dtype == torch.bfloat16 else body32
    rng = np.random.default_rng(12)
    z = _rand(rng, (b, l, cols), dev, dtype, 0.5)
    w = _rand(rng, (k, width), dev, torch.float32, 0.2)
    bias = _rand(rng, (width,), dev, torch.float32, 0.1)
    dy = _rand(rng, (b, l, width), dev, dtype)
    before = dict(fused_causal_conv1d_silu_bwd_cuda.body_launches)
    got = fused_causal_conv1d_silu_bwd_cuda(z, w, bias, dy, off, width)
    again = fused_causal_conv1d_silu_bwd_cuda(z, w, bias, dy, off, width)
    assert fused_causal_conv1d_silu_bwd_cuda.body_launches[body] == before[body] + 2
    ref = fused_causal_conv1d_silu_bwd_torch(z, w, bias, dy, off, width)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _assert_close(g, r, 1e-4, 1e-4)


def test_conv_fwd_body_matches_library(dev):
    """K9's body gate in Python (`conv_fwd_body`) and in C
    (`pht_conv_silu_fwd_body`) agree."""
    from pixel_heal_thyself_tpu_torch import _build

    lib = _build.lib()
    for dtype in (torch.bfloat16, torch.float32):
        for cols in (40, 100, 512, 2192, 2196):
            for off in (0, 4, 8, 10, 17, 1024):
                for width in (4, 8, 50, 200, 256, 1152):
                    c = lib.pht_conv_silu_fwd_body(cols, off, width,
                                                   int(dtype == torch.bfloat16))
                    assert conv_fwd_body(dtype, cols, off, width) == ("vec" if c else "general")


# (b, l, columns, offset, width, k, body in bf16, body in fp32): the prod
# window; l not a multiple of the CTA's ROWS; fewer rows than taps; k 9 and
# k 1; an offset or a width that is a multiple of 4 elements only
CONV_FWD_BODY_CASES = [(8, 16384, 2192, 1024, 1152, 4, "vec", "vec"),
                       (2, ROWS + 44, 512, 128, 256, 4, "vec", "vec"),
                       (1, 3, 512, 128, 256, 4, "vec", "vec"),
                       (1, 600, 1024, 0, 1024, 9, "vec", "vec"),
                       (1, 77, 64, 8, 32, 1, "vec", "vec"),
                       (2, 260, 516, 4, 256, 4, "general", "vec"),
                       (1, 100, 512, 128, 252, 3, "general", "vec")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CONV_FWD_BODY_CASES)
def test_conv_fwd_bodies(dev, dtype, case):
    """K9 takes its vec body where the window is 16-byte aligned and its
    general body elsewhere (`body_launches`); either body's y equals the
    plain version's to the bit (both round each product and sum in the same
    order), and two calls give the same bits."""
    b, l, cols, off, width, k, body16, body32 = case
    body = body16 if dtype == torch.bfloat16 else body32
    rng = np.random.default_rng(13)
    z = _rand(rng, (b, l, cols), dev, dtype, 0.5)
    w = _rand(rng, (k, width), dev, torch.float32, 0.2)
    bias = _rand(rng, (width,), dev, torch.float32, 0.1)
    before = dict(fused_causal_conv1d_silu_cuda.body_launches)
    got = fused_causal_conv1d_silu_cuda(z, w, bias, off, width)
    again = fused_causal_conv1d_silu_cuda(z, w, bias, off, width)
    assert fused_causal_conv1d_silu_cuda.body_launches[body] == before[body] + 2
    ref = fused_causal_conv1d_silu_torch(z, w, bias, off, width)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, ref)


def test_ssd_prologue_body_matches_library(dev):
    """The prologue's body gate in Python (`ssd_prologue_body`) and in C
    (`pht_ssd_prologue_body`) agree."""
    from pixel_heal_thyself_tpu_torch import _build

    lib = _build.lib()
    for dtype in (torch.bfloat16, torch.float32):
        for cols in (164, 292, 296, 2190, 2192, 2196):
            for di in (64, 128, 1020, 1024):
                for dc in (96, 160, 1148, 1152):
                    c = lib.pht_ssd_prologue_body(cols, di, dc, int(dtype == torch.bfloat16))
                    assert ssd_prologue_body(dtype, cols, di, dc) == ("vec" if c else "general")


# (b, l, d_inner, d_state, headdim, chunk, k): the prod shape; k 3 at chunk
# 64 with a d_state that is no multiple of 16; 256 heads (the dt/cum CTA
# walks its rows in tiles); k 1 and k 9
PROLOGUE_CASES = [(8, 16384, 1024, 64, 64, 128, 4), (2, 384, 256, 24, 32, 64, 3),
                  (1, 256, 2048, 16, 8, 32, 2), (1, 256, 128, 16, 16, 64, 1),
                  (1, 512, 128, 32, 16, 128, 9)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", PROLOGUE_CASES)
def test_ssd_prologue_bodies(dev, dtype, case):
    """K7's prologue on its vec body gives the general body's xbc, dt and
    cum to the bit; K7, its emit variant and K8 launch it on the body
    `ssd_prologue_body` names (`prologue_body_launches`)."""
    b, l, d_inner, d_state, headdim, chunk, k = case
    rng = np.random.default_rng(14)
    args = _chain_inputs(rng, dev, dtype, b, l, d_inner, d_state, headdim, k)
    pro = (*args[:4], args[4])  # zxbcdt, conv_w, conv_b, dt_bias, A
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    assert ssd_prologue_body(dtype, args[0].shape[-1], d_inner, d_inner + 2 * d_state) == "vec"
    vec = ssd_prologue_cuda(*pro, **dims, body="vec")
    general = ssd_prologue_cuda(*pro, **dims, body="general")
    torch.cuda.synchronize()
    for name, v, g in zip(("xbc", "dt", "cum"), vec, general):
        assert torch.equal(v, g), name
    if l > 4096:
        return
    _, states = fused_mamba_chain_torch(*args, **dims, emit=True)
    dy = _rand(rng, (b, l, d_inner), dev, dtype)
    for fn, call in ((fused_mamba_chain_cuda, lambda: fused_mamba_chain_cuda(*args, **dims)),
                     (fused_mamba_chain_emit_cuda,
                      lambda: fused_mamba_chain_emit_cuda(*args, **dims)),
                     (fused_mamba_chain_bwd_cuda,
                      lambda: fused_mamba_chain_bwd_cuda(*args, states, dy, **dims))):
        before = dict(fn.prologue_body_launches)
        call()
        assert fn.prologue_body_launches == dict(before, vec=before["vec"] + 1)


def test_ssd_prologue_refuses(dev):
    """The C entry refuses the vec body for a window off the 16-byte rule
    (bf16 zxbcdt rows of 292 columns) before it launches; the general body
    takes it."""
    args = _chain_inputs(np.random.default_rng(15), dev, torch.bfloat16, 1, 128, 128, 16, 32)
    dims = dict(d_inner=128, d_state=16, headdim=32, chunk=64)
    assert ssd_prologue_body(torch.bfloat16, args[0].shape[-1], 128, 160) == "general"
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_prologue_cuda(*args[:5], **dims, body="vec")
    before = dict(fused_mamba_chain_cuda.prologue_body_launches)
    fused_mamba_chain_cuda(*args, **dims)
    assert fused_mamba_chain_cuda.prologue_body_launches == dict(
        before, general=before["general"] + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_literal_fused_conv_route(dev, dtype):
    """A small MambaDenoiserNet on the literal route with the fused conv
    (d_state 64 → conv_dim 256): the kernel route against the plain route,
    every layer through K9 forward and K10 backward."""
    kw = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=64, headdim=32, expansion=4,
              num_gcp=0, padding_mode="replicate", use_pallas=True, dtype=dtype)
    model = MambaDenoiserNet(**kw, use_kernels=True, device=dev,
                             generator=torch.Generator().manual_seed(0))
    plain = MambaDenoiserNet(**kw, use_kernels=False, device=dev)
    plain.load_state_dict(model.state_dict())
    assert all(blk.mamba.fused_conv_route(32 * 32) for blk in model.blocks)
    rng = np.random.default_rng(9)
    x = _rand(rng, (2, 32, 32, 3), dev, torch.float32).abs()
    aux = _rand(rng, (2, 32, 32, 7), dev, torch.float32)
    counts = fused_causal_conv1d_silu_cuda.launches, fused_causal_conv1d_silu_bwd_cuda.launches
    model(x, aux).square().mean().backward()
    assert (fused_causal_conv1d_silu_cuda.launches,
            fused_causal_conv1d_silu_bwd_cuda.launches) == (counts[0] + 2, counts[1] + 2)
    plain(x, aux).square().mean().backward()
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        if q.grad is None:
            assert p.grad is None, name
            continue
        if dtype == torch.float32:
            _assert_close(p.grad, q.grad, 1e-4, 1e-5)
        else:
            _assert_grad_close(name, p.grad, q.grad, image=False)


def test_fold_qkv_fn_on_the_card(dev):
    rng = np.random.default_rng(10)
    b, h, w, c, heads = 2, 32, 32, 128, 4
    args = [_rand(rng, (b, h, w, c), dev, torch.float32) for _ in range(2)]
    args += [_rand(rng, (c, c), dev, torch.float32, 0.05) for _ in range(3)]
    args += [_rand(rng, (14, c // heads // 2), dev, torch.float32) for _ in range(2)]
    res = _rand(rng, (b, h, w, c), dev, torch.float32)
    do = _rand(rng, (b, h, w, c), dev, torch.float32)
    outs, grads = [], []
    counts = (attention_cuda.block_halo_attention_cuda.launches,
              attention_cuda.block_halo_attention_bwd_cuda.launches)
    for kernel in (True, False):
        ta = [a.clone().requires_grad_(True) for a in args + [res]]
        if kernel:
            out = QKVBlockHaloAttentionFn.apply(*ta, 8, 3, heads)
        else:
            out = qkv_block_halo_attention_torch(*ta[:7], block_size=8, halo_size=3,
                                                 num_heads=heads, residual=ta[7])
        out.backward(do)
        outs.append(out.detach())
        grads.append([t.grad for t in ta])
    assert (attention_cuda.block_halo_attention_cuda.launches,
            attention_cuda.block_halo_attention_bwd_cuda.launches) == (counts[0] + 1,
                                                                       counts[1] + 1)
    _assert_close(outs[0], outs[1], 1e-5, 1e-6)
    for g, r in zip(*grads):
        _assert_close(g, r, 1e-4, 1e-5)


def _tiny_store(root):
    from pixel_heal_thyself_tpu_torch.data.store import PatchStoreConstructor
    from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset

    generate_dataset(root / "images", height=64, width=64, seed=2)
    PatchStoreConstructor(str(root / "images"), str(root / "patches"), 16, 8, 5, 0.5,
                          num_workers=2).construct_store()
    return root / "patches" / "train"


def test_loaders_on_the_card_match_the_cpu(dev, tmp_path):
    """DeviceLoader's gather on the card and PrefetchLoader's pinned
    copies give the CPU loader's batches, byte for byte, over 2 epochs."""
    from pixel_heal_thyself_tpu_torch.data.dataset import DeviceLoader, PatchDataset, PrefetchLoader

    ds = PatchDataset(_tiny_store(tmp_path))
    kw = dict(batch_size=3, shuffle=True, seed=11)
    cpu = PrefetchLoader(ds, device="cpu", **kw)
    on_card = [DeviceLoader(ds, device=dev, **kw), PrefetchLoader(ds, device=dev, workers=2, **kw)]
    for _ in range(2):
        want = list(cpu)
        for loader in on_card:
            got = list(loader)
            assert len(got) == len(want)
            for gb, wb in zip(got, want):
                for key, val in wb.items():
                    assert gb[key].device.type == "cuda"
                    assert torch.equal(gb[key].cpu(), val), key


@pytest.mark.parametrize("model", ["afgsa", "mamba"])
def test_tiny_trainer_on_the_card_runs_its_kernels(dev, tmp_path, monkeypatch, model):
    """`train.main` on the card at a tiny bf16 config: every train step
    launches the generator's training kernels (AFGSA K1–K6, Mamba K7-emit
    and K8), validation its forward kernels, and the run writes its
    artifacts."""
    from pixel_heal_thyself_tpu_torch import train
    from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_bwd_cuda
    from pixel_heal_thyself_tpu_torch.training import trainer as trainer_mod

    kernels = {
        "afgsa": {"train": (block_halo_attention_cuda, pointwise_gemm_cuda, conv3x3_cuda,
                            block_halo_attention_bwd_cuda, conv3x3_dgrad_cuda, weight_grad_cuda),
                  "eval": (block_halo_attention_cuda, pointwise_gemm_cuda, conv3x3_cuda)},
        "mamba": {"train": (fused_mamba_chain_emit_cuda, fused_mamba_chain_bwd_cuda),
                  "eval": (fused_mamba_chain_cuda,)},
    }[model]
    calls = {"train": [], "eval": []}

    def counting(kind, make):
        def wrapped_make(*args, **kwargs):
            fn = make(*args, **kwargs)

            def run(*a, **k):
                before = [w.launches for w in kernels[kind]]
                out = fn(*a, **k)
                calls[kind].append([w.launches - b for w, b in zip(kernels[kind], before)])
                return out

            run.__dict__.update(fn.__dict__)
            return run
        return wrapped_make

    monkeypatch.setattr(trainer_mod, "make_train_step", counting("train", trainer_mod.make_train_step))
    monkeypatch.setattr(trainer_mod, "make_eval_step", counting("eval", trainer_mod.make_eval_step))
    monkeypatch.chdir(tmp_path)
    reset_run_dirs_cache()
    sizes = {"afgsa": ["model.feature_map_channels=64", "model.afgsa.self_attention.num_layers=1"],
             "mamba": ["model=mamba", "model.feature_map_channels=64", "model.mamba.num_layers=1",
                       "model.mamba.expansion=2", "model.mamba.headdim=16",
                       "model.mamba.d_state=16"]}[model]
    trainer = train.main(["-cn", "ci", "--device", "cuda", "trainer.epochs=1",
                          "trainer.precision=bf16", "data.patches.num_patches=6",
                          "data.images.synthetic_size=96", "run_num=0", *sizes])
    reset_run_dirs_cache()
    assert trainer.use_kernels and trainer.loader_kind == "device"
    assert calls["train"] and calls["eval"]
    for kind, per_call in calls.items():
        for i, launched in enumerate(per_call):
            assert all(n >= 1 for n in launched), f"{kind} call {i}: launches {launched}"
    run = tmp_path / "outputs" / "runs" / f"{model}_p32_n6_r1.0" / "run000"
    assert (run / "model_epoch1" / "state" / "checkpoint.pt").is_file()
    text = (run / "train_loss.txt").read_text()
    assert text.startswith("Epoch: 1 \tG loss: ")
    losses = [float(x) for x in text.split()[4::3]]  # "G loss: x", "D Loss: y"
    assert len(losses) == 2 and np.isfinite(losses).all()


# model, kwargs, the wrappers its serving forward launches
EXPORT_CASES = {
    "afgsa-block-bf16": (AFGSANet, dict(base_ch=64, enc_ch=32, num_sa=2, num_heads=4,
                                        use_block_kernel=True, dtype=torch.bfloat16)),
    "afgsa-literal-fp32": (AFGSANet, dict(base_ch=64, enc_ch=32, num_sa=2, num_heads=4)),
    "afgsa-film-bf16": (AFGSANet, dict(base_ch=64, enc_ch=32, num_sa=2, num_heads=4,
                                       use_film=True, dtype=torch.bfloat16)),
    "mamba-fused-bf16": (MambaDenoiserNet, dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16,
                                                headdim=32, expansion=4, use_megakernel=True,
                                                dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_exported_artifact_matches_live_model(dev, tmp_path, case):
    """A CUDA artifact (`serving.export_denoiser`) loaded back on the card
    gives the live model's output to the bit and launches the same
    kernels the same number of times (the `pht::` ops call the wrappers)."""
    from pixel_heal_thyself_tpu_torch.serving import export_denoiser, load_exported

    net, kw = EXPORT_CASES[case]
    model = net(**kw, num_gcp=0, padding_mode="replicate", use_kernels=True, device=dev,
                generator=torch.Generator().manual_seed(0)).eval()
    out = export_denoiser(model, tmp_path / "art", window=32, batch_tiles=2)
    apply_fn, manifest = load_exported(out, device=dev)
    assert manifest["kernel_ops"] and manifest["platforms"] == ["cuda"]
    rng = np.random.default_rng(5)
    x = _rand(rng, (2, 32, 32, 3), dev, torch.float32).abs()
    a = _rand(rng, (2, 32, 32, 7), dev, torch.float32)
    wrappers = (block_halo_attention_cuda, pointwise_gemm_cuda, conv3x3_cuda,
                fused_mamba_chain_cuda)

    def launched(fn):
        before = [w.launches for w in wrappers]
        with torch.inference_mode():
            y = fn(x, a)
        torch.cuda.synchronize()
        return y, [w.launches - b for w, b in zip(wrappers, before)]

    got, got_launches = launched(apply_fn)
    want, want_launches = launched(model)
    assert got_launches == want_launches and any(got_launches)
    assert torch.equal(got, want)

"""The host side of the Hopper bodies of K2, K3, K5 and K6, on the CPU: K6's
split planner, the shared memory of one CTA, the gates that pick a body,
and the per-body launch counters. (The kernels themselves run only on the
card: tests/test_torch_port_cuda.py; K5's fold algebra:
tests/test_torch_port_dgrad_plan.py.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
    MAX_SMEM,
    SM90_TILE,
    conv3x3,
    conv3x3_body,
    conv3x3_cuda,
    conv3x3_dgrad,
    conv3x3_dgrad_body,
    conv3x3_dgrad_cuda,
    pointwise_gemm,
    pointwise_gemm_body,
    pointwise_gemm_cuda,
    sm90_smem,
    weight_grad,
    weight_grad_body,
    weight_grad_cuda,
    wgrad_plan,
)
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
    fused_mamba_chain_bwd_cuda,
    fused_mamba_chain_cuda,
    fused_mamba_chain_emit_cuda,
)

H100_SMS = 132
PROD_PIXELS = 8 * 128 * 128
# the configs' training batches (batch × patch²) besides prod's 8 × 128²:
# dev 8 × 32², ci 2 × 32², stag 8 × 64²
CONFIG_PIXELS = [8 * 32 * 32, 2 * 32 * 32, 8 * 64 * 64]


@pytest.mark.parametrize("m,n", [(9 * 256, 256), (256, 256), (512, 256), (9 * 64, 64),
                                 (9 * 512, 512), (72, 8)])
@pytest.mark.parametrize("pixels", [PROD_PIXELS, *CONFIG_PIXELS, 4096, 1000, 130, 64, 1])
def test_wgrad_plan_covers_every_pixel_once(m, n, pixels):
    plan = wgrad_plan(m, n, pixels, H100_SMS)
    assert plan.body == "sm90"
    assert plan.row_tiles * plan.col_tiles * plan.splits <= H100_SMS  # one wave
    assert plan.pix_per_split % SM90_TILE[2] == 0
    # splits [s·per, min(P, (s+1)·per)) tile [0, P) with none empty
    starts = [s * plan.pix_per_split for s in range(plan.splits)]
    ends = [min(pixels, a + plan.pix_per_split) for a in starts]
    assert starts[0] == 0 and ends[-1] == pixels
    assert all(a < b for a, b in zip(starts, ends))
    assert all(b == a for a, b in zip(ends, starts[1:]))
    covered = np.zeros(pixels, dtype=np.int64)
    for a, b in zip(starts, ends):
        covered[a:b] += 1
    assert (covered == 1).all()
    assert plan.row_tiles == -(-m // 128) and plan.col_tiles == -(-n // 256)


@pytest.mark.parametrize("m,n,splits", [(9 * 256, 256, 7), (256, 256, 64), (512, 256, 33)])
def test_wgrad_plan_is_one_wave_at_prod(m, n, splits):
    """Prod widths: 9 taps (18 row tiles × 7 splits = 126 CTAs), one tap,
    one tap with the second operand; at most one CTA per SM."""
    plan = wgrad_plan(m, n, PROD_PIXELS, H100_SMS)
    assert plan.splits == splits
    assert plan.row_tiles * plan.col_tiles * plan.splits <= H100_SMS


@pytest.mark.parametrize("m", [9 * 64, 9 * 72, 72, 256 + 72])
def test_wgrad_plan_odd_row_tiles_fill_one_wave(m):
    """An odd count of row tiles (a partial last tile too): the grid fits one
    wave, and one 64-pixel stage less per split would not."""
    plan = wgrad_plan(m, 256, PROD_PIXELS, H100_SMS)
    tiles = plan.row_tiles * plan.col_tiles
    assert tiles * plan.splits <= H100_SMS
    assert tiles * -(-PROD_PIXELS // (plan.pix_per_split - SM90_TILE[2])) > H100_SMS


def test_wgrad_plan_general_body_keeps_its_rule():
    """The general body: 128 × 128 tiles, two CTAs per SM, 256+ pixels a split."""
    plan = wgrad_plan(9 * 12, 20, 63, H100_SMS, "general")
    assert (plan.row_tiles, plan.col_tiles, plan.splits) == (1, 1, 1)
    plan = wgrad_plan(9 * 256, 256, PROD_PIXELS, H100_SMS, "general")
    assert plan.row_tiles * plan.col_tiles * plan.splits <= 2 * H100_SMS
    assert plan.splits * plan.pix_per_split >= PROD_PIXELS


@pytest.mark.parametrize("taps", [1, 9])
def test_sm90_smem_fits_every_width(taps):
    """Every (C, N) multiple of 8 up to 512, with or without the gate (which
    a separate pass applies, so it adds no stage bytes): one CTA's ring,
    barriers and tables fit the H100's 232,448 bytes."""
    for c in range(8, 513, 8):
        for n in range(8, 513, 8):
            plan = wgrad_plan(taps * c, n, PROD_PIXELS, H100_SMS)
            assert plan.smem == sm90_smem() <= MAX_SMEM
    # 4 stages of 48 KB, 12 mbarriers, 4 KB of tables, 1 KB of alignment
    assert sm90_smem() == 4 * 48 * 1024 + 96 + 4096 + 1024


@pytest.mark.parametrize("c,n,body", [(256, 256, "sm90"), (64, 72, "sm90"), (8, 8, "sm90"),
                                      (12, 20, "general"), (64, 20, "general"),
                                      (12, 64, "general")])
def test_conv3x3_body_gate(c, n, body):
    x = torch.zeros(1, 2, 2, c, dtype=torch.bfloat16)
    w = torch.zeros(9 * c, n, dtype=torch.bfloat16)
    assert conv3x3_body(c, n, x, w, None) == body


@pytest.mark.parametrize("c1,c2,n,body", [(256, 0, 256, "sm90"), (256, 256, 256, "sm90"),
                                          (64, 72, 64, "sm90"), (12, 20, 20, "general"),
                                          (256, 12, 256, "general"), (256, 0, 20, "general")])
def test_weight_grad_body_gate(c1, c2, n, body):
    x = torch.zeros(1, 2, 2, c1, dtype=torch.bfloat16)
    assert weight_grad_body(c1, c2, n, x, None) == body


@pytest.mark.parametrize("k1,k2,n,body", [(256, 0, 256, "sm90"), (256, 256, 256, "sm90"),
                                          (40, 0, 24, "sm90"), (8, 8, 8, "sm90"),
                                          (12, 20, 136, "general"), (256, 12, 256, "general"),
                                          (256, 0, 20, "general")])
def test_pointwise_gemm_body_gate(k1, k2, n, body):
    a1 = torch.zeros(4, k1, dtype=torch.bfloat16)
    w1 = torch.zeros(k1, n, dtype=torch.bfloat16)
    assert pointwise_gemm_body(k1, k2, n, a1, w1, None) == body


@pytest.mark.parametrize("c,n,body", [(256, 256, "sm90"), (64, 72, "sm90"), (8, 8, "sm90"),
                                      (12, 20, "general"), (64, 20, "general"),
                                      (12, 64, "general")])
def test_conv3x3_dgrad_body_gate(c, n, body):
    dy = torch.zeros(1, 2, 2, n, dtype=torch.bfloat16)
    w = torch.zeros(9 * c, n, dtype=torch.bfloat16)
    assert conv3x3_dgrad_body(c, n, dy, None, w, None) == body


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_k2_k5_bodies_need_16_byte_aligned_operands(offset):
    """An operand `offset` bf16 values (2 × offset bytes) past an aligned
    start takes the general body; the aligned one the Hopper body."""
    base = torch.zeros(2 * 2 * 64 + 8, dtype=torch.bfloat16)
    moved = base[offset:offset + 2 * 2 * 64]
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    assert pointwise_gemm_body(64, 0, 64, moved.view(4, 64), w) == "general"
    assert pointwise_gemm_body(64, 0, 64, base[:256].view(4, 64), w) == "sm90"
    w9 = torch.zeros(9 * 64, 64, dtype=torch.bfloat16)
    assert conv3x3_dgrad_body(64, 64, moved.view(1, 2, 2, 64), None, w9) == "general"
    assert conv3x3_dgrad_body(64, 64, base[:256].view(1, 2, 2, 64), None, w9) == "sm90"


def test_bodies_need_16_byte_aligned_operands():
    base = torch.zeros(2 * 2 * 64 + 8, dtype=torch.bfloat16)
    x = base[1:1 + 2 * 2 * 64].view(1, 2, 2, 64)  # 2 bytes past an aligned start
    w = torch.zeros(9 * 64, 64, dtype=torch.bfloat16)
    assert conv3x3_body(64, 64, x, w) == "general"
    assert weight_grad_body(64, 0, 64, x) == "general"
    assert conv3x3_body(64, 64, base[:256].view(1, 2, 2, 64), w) == "sm90"


@pytest.mark.parametrize("fn", [conv3x3_cuda, weight_grad_cuda, pointwise_gemm_cuda,
                                conv3x3_dgrad_cuda, fused_mamba_chain_cuda,
                                fused_mamba_chain_emit_cuda, fused_mamba_chain_bwd_cuda])
def test_per_body_counters_exist(fn):
    """K2, K3, K5 and K6 count their Hopper ("sm90") and general bodies; K7,
    its emit variant and K8 their tensor-core ("tc") and general bodies."""
    mamba = fn in (fused_mamba_chain_cuda, fused_mamba_chain_emit_cuda, fused_mamba_chain_bwd_cuda)
    assert isinstance(fn.launches, int)
    assert set(fn.body_launches) == {"tc" if mamba else "sm90", "general"}
    assert all(isinstance(v, int) for v in fn.body_launches.values())


def test_cpu_dispatch_counts_no_launch():
    """On the CPU the dispatchers run the plain versions: no body counts."""
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    x = torch.as_tensor(rng.standard_normal((1, 4, 4, 8)), dtype=torch.float32).to(bf)
    w = torch.as_tensor(rng.standard_normal((72, 8)), dtype=torch.float32).to(bf)
    before = (dict(conv3x3_cuda.body_launches), dict(weight_grad_cuda.body_launches))
    out = conv3x3(x, w, None, "reflect")
    dw, db = weight_grad(x, out, out, taps=9, padding_mode="reflect", colsum=True)
    assert out.shape == (1, 4, 4, 8) and dw.shape == (72, 8) and db.shape == (8,)
    assert (dict(conv3x3_cuda.body_launches), dict(weight_grad_cuda.body_launches)) == before


def test_cpu_dispatch_of_k2_k5_counts_no_launch():
    """K2's and K5's dispatchers on the CPU run their plain versions: no
    launch and no body counts."""
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    a = torch.as_tensor(rng.standard_normal((2, 4, 4, 16)), dtype=torch.float32).to(bf)
    w1 = torch.as_tensor(rng.standard_normal((16, 8)), dtype=torch.float32).to(bf)
    w9 = torch.as_tensor(rng.standard_normal((72, 16)), dtype=torch.float32).to(bf)
    fns = (pointwise_gemm_cuda, conv3x3_dgrad_cuda)
    before = [(fn.launches, dict(fn.body_launches)) for fn in fns]
    out = pointwise_gemm(a, w1, a, w1, None, True, pre_residual=a[..., :8])
    din = conv3x3_dgrad(a, a, w9, "replicate", residual=out)
    assert out.shape == (2, 4, 4, 8) and din.shape == (2, 4, 4, 8)
    assert [(fn.launches, dict(fn.body_launches)) for fn in fns] == before


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::pointwise_gemm_kernel(CUtensorMap, CUtensorMap, "
     "CUtensorMap, CUtensorMap, pht::sm90::body::Params)", "K2 GEMM"),
    ("void (anonymous namespace)::gemm_bf16_kernel<false>(Params)", "K2 GEMM"),
    ("void (anonymous namespace)::conv3x3_kernel(CUtensorMap, CUtensorMap, "
     "pht::sm90::body::Params)", "K3 conv3x3"),
    ("void (anonymous namespace)::conv3x3_dgrad_sm90_kernel(CUtensorMap, CUtensorMap, "
     "pht::sm90::body::Params)", "K5 conv3x3 dgrad"),
    ("void (anonymous namespace)::conv3x3_dgrad_kernel(DgradParams)", "K5 conv3x3 dgrad"),
    ("void (anonymous namespace)::dgrad_fold_kernel(bf16 const*, bf16 const*, float*, int)",
     "K5 fold pre-pass"),
    ("void (anonymous namespace)::mask_kernel(uint4 const*, uint4 const*, uint4*, long)",
     "K5/K6 gate pass"),
    ("void (anonymous namespace)::wgrad_kernel(CUtensorMap, CUtensorMap, CUtensorMap, Params)",
     "K6 weight gradient"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS GEMM"),
])
def test_profile_groups_name_the_hopper_bodies(name, label):
    """The profile tools attribute each body's launches to its kernel (first
    match wins: K3's fragment must not take K5's launches, nor cuBLAS's
    K2's)."""
    from pixel_heal_thyself_tpu_torch.profile_serving import group

    assert group(name) == label

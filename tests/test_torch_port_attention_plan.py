"""PyTorch port: the plan of K1's and K4's tensor-core bodies, on the CPU.

The tensor-core bodies (`csrc/attention_tc.cuh`, `attention_fwd.cu`,
`attention_bwd.cu`) compute block-halo attention in another order than
the plain versions: per (window, head), the keys in tiles of 16 (padded
keys hold zero rows and a -inf logit), the logits or probabilities of a
warp's 16 query rows held in registers where the tile count allows it and
otherwise recomputed per pass with online row statistics; in the backward
D = Σ dattn·P from dattn tiles against the unrounded P, dl and round(P)
staged per sub-chunk of 4 key tiles for the transposed products, the f32
window partials summed per key pixel in raster order of the windows, the
bias gradient in groups of 16 windows. `fwd_plan` and `bwd_plan` below
are plain PyTorch in that order; they hold it against
`block_halo_attention_torch` / `block_halo_attention_bwd_torch` before
the card does (float32: sums in another order, 1e-5 of the largest
magnitude; bf16: the kernels' bf16 bounds, 2**-7 max and 2e-3 rms, for an
f32 sum next to a rounding boundary), and one case each against the TPU
kernels run in interpret mode (`block_halo_attention_pallas` and its VJP,
float32, 1e-5).

Also here: the body gate, each kernel's shared memory at halos 1–8, the
body counters and the profile tools' labels.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pixel_heal_thyself_tpu.ops.attention_pallas import block_halo_attention_pallas  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import attention_cuda  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.attention import (  # noqa: E402
    _heads,
    block_halo_attention_bwd_torch,
    block_halo_attention_torch,
    blocks_from_image,
    extract_halo_windows,
    image_from_blocks,
    rel_bias,
)
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (  # noqa: E402
    MAX_SMEM,
    attention_body,
    attention_tc_plan,
)

PLAN_TOL = 1e-5
BF16_TOL = (2**-7, 2e-3)


def _inputs(seed, b, h, w, c, heads, bs, halo, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    window = bs + 2 * halo

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    q, k, v, do = (rand((b, h, w, c)).to(dtype) for _ in range(4))
    return q, k, v, rand((window, c // heads // 2)), rand((window, c // heads // 2)), do


def _operands(q, k, v, rel_h, rel_w, bs, halo, heads):
    """The kernels' shared tiles, f32: Q [.., nq, hd] and the zero-padded
    k_eff (round(k + bias)) and v [.., 16 nt, hd] of every (window, head)."""
    b, h, w, c = q.shape
    window, hd = bs + 2 * halo, c // heads
    hb, wb, nk = h // bs, w // bs, window * window
    nt = attention_tc_plan(bs, halo, hd).key_tiles
    qh = _heads(blocks_from_image(q, bs), heads)
    kw = extract_halo_windows(k, bs, halo).reshape(b, hb, wb, window, window, heads, hd)
    kw = (kw.float() + rel_bias(rel_h, rel_w)[:, :, None, :]).to(q.dtype)
    pad = (0, 0, 0, 16 * nt - nk)
    kh = torch.nn.functional.pad(_heads(kw.reshape(b, hb, wb, nk, c), heads), pad)
    vh = torch.nn.functional.pad(
        _heads(extract_halo_windows(v, bs, halo).reshape(b, hb, wb, nk, c), heads), pad)
    return qh, kh, vh, nt, nk


def _logits(qh, kh, t, nk, scale):
    """Key tile t of the logits, -inf for the padded keys."""
    s = torch.matmul(qh, kh[..., 16 * t:16 * t + 16, :].transpose(-1, -2)) * scale
    keys = torch.arange(16 * t, 16 * t + 16)
    return s.masked_fill(keys >= nk, float("-inf"))


def _stats(qh, kh, nt, nk, scale, resident):
    """Row max and sum of exp: exact over the resident tiles, or online
    over the tiles (each tile's max, the running sum rescaled)."""
    if resident:
        s = torch.cat([_logits(qh, kh, t, nk, scale) for t in range(nt)], dim=-1)
        m = s.amax(-1, keepdim=True)
        return m, torch.exp(s - m).sum(-1, keepdim=True)
    m = torch.full(qh.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    for t in range(nt):
        s = _logits(qh, kh, t, nk, scale)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        m = mn
    return m, l


def _probs(qh, kh, t, nk, scale, m, l):
    return torch.exp(_logits(qh, kh, t, nk, scale) - m) / l


def fwd_plan(q, k, v, rel_h, rel_w, *, block_size, halo_size, num_heads, residual=None,
             resident=None):
    """K1's tensor-core body in plain PyTorch: per key tile of 16, the
    probabilities rounded from the row statistics, P·v summed tile by tile
    in f32, rounded once (then the residual)."""
    b, h, w, c = q.shape
    bs, hd = block_size, c // num_heads
    qh, kh, vh, nt, nk = _operands(q, k, v, rel_h, rel_w, bs, halo_size, num_heads)
    if resident is None:
        resident = attention_tc_plan(bs, halo_size, hd).resident
    scale = torch.tensor(hd, dtype=torch.float32) ** -0.5
    m, l = _stats(qh, kh, nt, nk, scale, resident)
    acc = torch.zeros(qh.shape)
    for t in range(nt):
        p = _probs(qh, kh, t, nk, scale, m, l).to(q.dtype).float()
        acc = acc + torch.matmul(p, vh[..., 16 * t:16 * t + 16, :])
    hb, wb = h // bs, w // bs
    out = acc.to(q.dtype).permute(0, 1, 2, 4, 3, 5).reshape(b, hb, wb, bs * bs, c)
    out = image_from_blocks(out, bs)
    return out if residual is None else residual + out


def gather_partials(part, b, h, w, bs, halo):
    """The gather kernel's order: each key pixel sums the f32 partials
    [windows, nk, C] of the windows that hold it, windows in raster order."""
    window = bs + 2 * halo
    hb, wb, c = h // bs, w // bs, part.shape[-1]
    part = part.reshape(b, hb, wb, window, window, c)
    img = torch.zeros(b, h + 2 * halo, w + 2 * halo, c)
    for by in range(hb):
        for bx in range(wb):
            img[:, by * bs:by * bs + window, bx * bs:bx * bs + window] += part[:, by, bx]
    return img[:, halo:halo + h, halo:halo + w]


def bwd_plan(q, k, v, rel_h, rel_w, do, *, block_size, halo_size, num_heads, resident=None,
             sub=attention_cuda.TC_SUB, bias_group=16):
    """K4's tensor-core body in plain PyTorch: P (unrounded) from the row
    statistics, D = Σ dattn·P tile by tile, then per sub-chunk of `sub`
    key tiles dl = round(P (dattn − D)) and round(P), dq += dl·k_eff, the
    window partials dk_w = dlᵀ·q·scale and dv_w = round(P)ᵀ·do; the
    gather's and the bias reduction's fixed orders."""
    b, h, w, c = q.shape
    bs, hd, half = block_size, c // num_heads, c // num_heads // 2
    qh, kh, vh, nt, nk = _operands(q, k, v, rel_h, rel_w, bs, halo_size, num_heads)
    doh = _heads(blocks_from_image(do, bs), num_heads)
    if resident is None:
        resident = attention_tc_plan(bs, halo_size, hd).resident
    scale = torch.tensor(hd, dtype=torch.float32) ** -0.5
    m, l = _stats(qh, kh, nt, nk, scale, resident)
    tile = lambda x, t: x[..., 16 * t:16 * t + 16, :]  # noqa: E731
    d = torch.zeros(qh.shape[:-1] + (1,))
    for t in range(nt):
        dattn = torch.matmul(doh, tile(vh, t).transpose(-1, -2))
        d = d + (dattn * _probs(qh, kh, t, nk, scale, m, l)).sum(-1, keepdim=True)
    dq = torch.zeros(qh.shape)
    dk_w, dv_w = torch.zeros(kh.shape), torch.zeros(kh.shape)
    for sc in range(0, nt, sub):
        tiles = range(sc, min(sc + sub, nt))
        dls, prs = {}, {}
        for t in tiles:
            p = _probs(qh, kh, t, nk, scale, m, l)
            dattn = torch.matmul(doh, tile(vh, t).transpose(-1, -2))
            dls[t] = (p * (dattn - d)).to(q.dtype).float()
            prs[t] = p.to(q.dtype).float()
            dq = dq + torch.matmul(dls[t], tile(kh, t))
        for t in tiles:  # after the barrier: one key tile per warp
            dk_w[..., 16 * t:16 * t + 16, :] = torch.matmul(dls[t].transpose(-1, -2), qh) * scale
            dv_w[..., 16 * t:16 * t + 16, :] = torch.matmul(prs[t].transpose(-1, -2), doh)
    hb, wb = h // bs, w // bs
    dq = image_from_blocks((dq * scale).to(q.dtype).permute(0, 1, 2, 4, 3, 5)
                           .reshape(b, hb, wb, bs * bs, c), bs)
    # partials [windows, nk, C], padded keys dropped
    part = lambda x: x[..., :nk, :].permute(0, 1, 2, 4, 3, 5).reshape(b * hb * wb, nk, c)  # noqa: E731
    dk_part, dv_part = part(dk_w), part(dv_w)
    dk = gather_partials(dk_part, b, h, w, bs, halo_size).to(q.dtype)
    dv = gather_partials(dv_part, b, h, w, bs, halo_size).to(q.dtype)
    # bias: groups of windows (heads summed in order), then the groups
    per_head = dk_part.reshape(-1, nk, num_heads, hd)
    groups = [per_head[g:g + bias_group].sum(0).sum(1) for g in range(0, len(per_head), bias_group)]
    dbias = torch.stack(groups).sum(0).reshape(bs + 2 * halo_size, bs + 2 * halo_size, hd)
    return dq, dk, dv, dbias[..., :half].sum(1), dbias[..., half:].sum(0)


def _close(got, ref, max_rel, rms_rel=None, name=""):
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    err = (got - ref).abs()
    assert err.max().item() <= max_rel * scale, (name, err.max().item() / scale)
    if rms_rel is not None:
        assert err.pow(2).mean().sqrt().item() <= rms_rel * scale, name


# (block, halo, heads, C): every halo 1..8 at block 8 (4 resident tile
# counts, then the streamed plan), block 4, head_ch 16/32/64
PLAN_CASES = [(8, 1, 2, 64), (8, 2, 4, 64), (8, 3, 4, 256), (8, 4, 2, 128), (8, 5, 4, 128),
              (8, 6, 2, 32), (8, 7, 2, 64), (8, 8, 4, 256), (4, 1, 2, 64), (4, 3, 2, 32)]


@pytest.mark.parametrize("bs,halo,heads,c", PLAN_CASES)
def test_fwd_plan_matches_plain(bs, halo, heads, c):
    """Key tiles of 16 with the padded keys out of the softmax, resident or
    two-pass statistics, P·v tile by tile: the plain forward at 1e-5."""
    q, k, v, rel_h, rel_w, do = _inputs(bs * 10 + halo, 2, 16, 24, c, heads, bs, halo)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads)
    ref = block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw, residual=do)
    for resident in (False, True):
        _close(fwd_plan(q, k, v, rel_h, rel_w, **kw, residual=do, resident=resident), ref,
               PLAN_TOL, name=f"resident={resident}")


@pytest.mark.parametrize("bs,halo,heads,c", PLAN_CASES)
def test_bwd_plan_matches_plain(bs, halo, heads, c):
    """D on the unrounded P, dl and round(P) per sub-chunk, the window
    partials, their raster-order gather and grouped bias sum: the plain
    backward at 1e-5 for all five gradients, in both plans."""
    q, k, v, rel_h, rel_w, do = _inputs(bs * 10 + halo + 1, 2, 16, 24, c, heads, bs, halo)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads)
    ref = block_halo_attention_bwd_torch(q, k, v, rel_h, rel_w, do, **kw)
    for resident in (False, True):
        got = bwd_plan(q, k, v, rel_h, rel_w, do, **kw, resident=resident)
        for name, g, r in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, ref, strict=True):
            _close(g, r, PLAN_TOL, name=f"{name} resident={resident}")


@pytest.mark.parametrize("halo", [3, 8])
def test_plans_bf16_within_kernel_bounds(halo):
    """In bf16 the plans round at the plain versions' points; they differ
    only where an f32 sum in another order lands next to a bf16 rounding
    boundary: inside the kernels' bf16 bounds."""
    q, k, v, rel_h, rel_w, do = _inputs(40 + halo, 1, 16, 16, 128, 2, 8, halo, torch.bfloat16)
    kw = dict(block_size=8, halo_size=halo, num_heads=2)
    _close(fwd_plan(q, k, v, rel_h, rel_w, **kw),
           block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw), *BF16_TOL)
    for g, r in zip(bwd_plan(q, k, v, rel_h, rel_w, do, **kw),
                    block_halo_attention_bwd_torch(q, k, v, rel_h, rel_w, do, **kw)):
        _close(g, r, *BF16_TOL)


def test_d_needs_the_unrounded_probabilities():
    """D = Σ dattn·P must take the unrounded P: with round(P) the plan's dq
    leaves the plain backward's by far more than the f32 bound."""
    q, k, v, rel_h, rel_w, do = _inputs(7, 1, 16, 16, 64, 2, 8, 3)
    kw = dict(block_size=8, halo_size=3, num_heads=2)
    ref = block_halo_attention_bwd_torch(q, k, v, rel_h, rel_w, do, **kw)
    qh, kh, vh, nt, nk = _operands(q, k, v, rel_h, rel_w, 8, 3, 2)
    doh = _heads(blocks_from_image(do, 8), 2)
    scale = torch.tensor(32.0) ** -0.5
    m, l = _stats(qh, kh, nt, nk, scale, True)
    p = torch.cat([_probs(qh, kh, t, nk, scale, m, l) for t in range(nt)], -1)
    dattn = torch.matmul(doh, vh.transpose(-1, -2))
    for rounded, ok in ((False, True), (True, False)):
        pd = p.to(torch.bfloat16).float() if rounded else p
        d = (dattn * pd).sum(-1, keepdim=True)
        dq = torch.matmul(p * (dattn - d), kh) * scale
        dq = image_from_blocks(dq.permute(0, 1, 2, 4, 3, 5).reshape(1, 2, 2, 64, 64), 8)
        err = (dq - ref[0]).abs().max().item() / ref[0].abs().max().item()
        assert (err <= PLAN_TOL) == ok, (rounded, err)


def test_gather_order_is_the_overlap_add():
    """The gather's raster-order sum of the window partials is the
    overlap-add of the plain backward (F.fold), out-of-frame keys dropped."""
    from pixel_heal_thyself_tpu_torch.ops.attention import overlap_add_windows

    rng = np.random.default_rng(3)
    b, h, w, c, bs, halo = 2, 16, 24, 8, 8, 3
    window = bs + 2 * halo
    part = torch.as_tensor(rng.standard_normal((b * 2 * 3, window * window, c)),
                           dtype=torch.float32)
    want = overlap_add_windows(part.reshape(b, 2, 3, window, window, c), h, w, bs, halo)
    _close(gather_partials(part, b, h, w, bs, halo), want, 1e-6)


def test_body_gate():
    """"tc" for bf16, head_ch a multiple of 16 up to 64, block 4 or 8 and
    16-byte aligned tensors; fp32 at those blocks and head_ch a multiple of
    4 up to 64 takes the float32 body ("f32"), other fp32 shapes the general
    one; other widths and blocks, or an operand off 16 bytes take the
    general body."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    assert attention_body(torch.bfloat16, 256, 4, 8, 3, x) == "tc"  # prod
    for halo in range(1, 9):
        assert attention_body(torch.bfloat16, 256, 4, 8, halo) == "tc"
        assert attention_body(torch.float32, 256, 4, 8, halo) == "f32"
    assert attention_body(torch.float32, 256, 2, 8, 3) == "general"  # fp32 head_ch 128
    assert attention_body(torch.float32, 256, 4, 16, 3) == "general"  # fp32 block 16
    assert attention_body(torch.bfloat16, 32, 2, 8, 3) == "tc"  # head_ch 16
    assert attention_body(torch.bfloat16, 64, 2, 4, 4) == "tc"
    assert attention_body(torch.float16, 256, 4, 8, 3) == "general"
    assert attention_body(torch.bfloat16, 32, 4, 8, 3) == "general"  # head_ch 8
    assert attention_body(torch.bfloat16, 96, 2, 8, 3) == "tc"  # head_ch 48
    assert attention_body(torch.bfloat16, 96, 4, 8, 3) == "general"  # head_ch 24
    assert attention_body(torch.bfloat16, 256, 2, 8, 3) == "general"  # head_ch 128
    assert attention_body(torch.bfloat16, 256, 4, 16, 3) == "general"  # block 16
    assert attention_body(torch.bfloat16, 256, 4, 2, 1) == "general"  # block 2
    assert attention_body(torch.bfloat16, 256, 4, 8, 3, x[1:]) == "general"  # 2 bytes off


def test_shared_memory_plan():
    """Both kernels fit one CTA at every halo 1..8 (block 8, head_ch 64),
    halo ≤ 4 keeps the logits / probabilities in registers, and at the prod
    halo 3 K1 fits three CTAs an SM and K4 two (228 KB an SM, 1 KB each
    reserved)."""
    per_sm = 233_472
    for halo in range(1, 9):
        plan = attention_tc_plan(8, halo, 64)
        assert plan.smem_fwd <= MAX_SMEM and plan.smem_bwd <= MAX_SMEM, halo
        assert plan.resident == (halo <= 4), halo
        assert plan.threads == 128
    prod = attention_tc_plan(8, 3, 64)
    assert (prod.key_tiles, prod.smem_fwd, prod.smem_bwd) == (13, 69_120, 96_768)
    assert 3 * (prod.smem_fwd + 1024) <= per_sm
    assert 2 * (prod.smem_bwd + 1024) <= per_sm
    assert [attention_tc_plan(4, h, 32).key_tiles for h in range(1, 5)] == [3, 4, 7, 9]
    assert attention_tc_plan(8, 8, 64).key_tiles == 36


def test_wrappers_count_launches_by_body():
    """Each wrapper counts its launches and each body's; on a CPU tensor it
    refuses before counting, and the dispatchers run the plain versions
    without counting."""
    from pixel_heal_thyself_tpu_torch.ops.attention import (
        block_halo_attention,
        block_halo_attention_bwd,
    )

    fns = (attention_cuda.block_halo_attention_cuda,
           attention_cuda.block_halo_attention_bwd_cuda)
    for fn in fns:
        assert set(fn.body_launches) == {"tc", "f32", "general"}
        assert isinstance(fn.launches, int)
    q = torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16)
    rel = torch.zeros(14, 8)
    kw = dict(block_size=8, halo_size=3, num_heads=2)
    before = [(fn.launches, dict(fn.body_launches)) for fn in fns]
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.block_halo_attention_cuda(q, q, q, rel, rel, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.attention_body_launch("tc", q, q, q, rel, rel, **kw)
    assert block_halo_attention(q, q, q, rel, rel, **kw).shape == q.shape
    assert block_halo_attention_bwd(q, q, q, rel, rel, q, **kw)[0].shape == q.shape
    assert [(fn.launches, dict(fn.body_launches)) for fn in fns] == before


def test_profile_labels():
    """The profile tools file both bodies' kernels under K1 and K4."""
    from pixel_heal_thyself_tpu_torch.profile_serving import group

    for name in ("void (anonymous namespace)::attention_fwd_tc_kernel<13>(...)",
                 "attention_fwd_kernel<__nv_bfloat16>", "attention_fwd_chunked_kernel<float>"):
        assert group(name) == "K1 attention", name
    for name in ("attention_bwd_tc_kernel<0>", "attention_bwd_kernel<float>",
                 "attention_bwd_gather_kernel<__nv_bfloat16>", "attention_bias_reduce_kernel"):
        assert group(name) == "K4 attention backward", name


def _tpu_case():
    """2 heads, C 32 (head_ch 16), a 32² image, block 8, halo 3, float32."""
    return _inputs(21, 1, 32, 32, 32, 2, 8, 3)


def test_fwd_plan_matches_tpu_kernel_interpret():
    q, k, v, rel_h, rel_w, _ = _tpu_case()
    kw = dict(block_size=8, halo_size=3, num_heads=2)
    with pltpu.force_tpu_interpret_mode():
        want = block_halo_attention_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v, rel_h,
                                                                              rel_w)), **kw)
    _close(fwd_plan(q, k, v, rel_h, rel_w, **kw), torch.from_numpy(np.array(want)), PLAN_TOL)


def test_bwd_plan_matches_tpu_kernel_interpret():
    q, k, v, rel_h, rel_w, do = _tpu_case()
    kw = dict(block_size=8, halo_size=3, num_heads=2)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: block_halo_attention_pallas(*a, **kw),
                         *(jnp.asarray(t.numpy()) for t in (q, k, v, rel_h, rel_w)))
        want = vjp(jnp.asarray(do.numpy()))
    got = bwd_plan(q, k, v, rel_h, rel_w, do, **kw)
    for name, g, r in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, want, strict=True):
        _close(g, torch.from_numpy(np.array(r)), PLAN_TOL, name=name)

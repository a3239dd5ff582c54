"""PyTorch port: the float32 body of K1 and K4, on the CPU.

The float32 body (`csrc/attention_f32.cuh`, `attention_fwd.cu`
`attention_fwd_f32_kernel`, `attention_bwd.cu` `attention_bwd_f32_kernel`)
takes K1 in the plain version's own order on the card (each logit one FMA
chain over the channels; the row sum as PyTorch's warp softmax takes it,
lane L of 32 summing the keys j = L mod 32 in order, then a butterfly 16,
8, 4, 2, 1, which the kernel's 8 lanes a row reproduce with four partials
each; P = exp / sum; P·v one chain a value over the keys in order), and K4
in another order: the keys in equal chunks of at most 208 slots split
between two warps, a lane holding the slots lk + 8t of its half for four
query rows, the row statistics from the 8 lanes of the row and the two
halves in a fixed order (online over chunks), dl·k_eff summed per lane and
reduce-scattered over the lanes (xor 4, 2, 1) 8 channels at a time, the
halves of dq added at the end, dlᵀ·q and Pᵀ·do summed over the query rows
into the f32 window partials, which the gather sums per key pixel and the
bias reduction in groups of 16 windows. `fwd_replay` and `bwd_replay` below
are plain PyTorch in those orders; they hold them against
`block_halo_attention_torch` / `block_halo_attention_bwd_torch` and
against the TPU kernels run in interpret mode (`block_halo_attention_pallas`
and its VJP) at float32, 1e-5 of the largest magnitude (sums in another
order, and on the CPU products rounded apart from their sums).

Also here: `attention_f32_plan` (shared memory, threads, the values a
thread holds) at halos 1–8 and head_ch 4–64, the gate, the counters and the
CPU dispatch.
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
    block_halo_attention,
    block_halo_attention_bwd,
    block_halo_attention_bwd_torch,
    block_halo_attention_torch,
    blocks_from_image,
    extract_halo_windows,
    image_from_blocks,
    overlap_add_windows,
    rel_bias,
)
from pixel_heal_thyself_tpu_torch.ops.attention_cuda import (  # noqa: E402
    MAX_SMEM,
    attention_body,
    attention_f32_plan,
)

TOL = 1e-5
LANES = 8  # the lanes of a query row's group
BIAS_GROUP = 16  # windows per first-level group of the bias reduction


def _inputs(seed, b, h, w, c, heads, bs, halo):
    rng = np.random.default_rng(seed)
    window = bs + 2 * halo

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    q, k, v, do = (rand((b, h, w, c)) for _ in range(4))
    return q, k, v, rand((window, c // heads // 2)), rand((window, c // heads // 2)), do


def _operands(q, k, v, rel_h, rel_w, bs, halo, heads, slots_total):
    """Q [.., nq, hd] and k_eff = k + bias, v [.., slots_total, hd] of every
    (window, head), the slots past the window's keys zero."""
    b, h, w, c = q.shape
    window, hd = bs + 2 * halo, c // heads
    hb, wb, nk = h // bs, w // bs, window * window
    qh = _heads(blocks_from_image(q, bs), heads)
    kw = extract_halo_windows(k, bs, halo).reshape(b, hb, wb, window, window, heads, hd)
    kw = kw + rel_bias(rel_h, rel_w)[:, :, None, :]
    pad = (0, 0, 0, slots_total - nk)
    kh = torch.nn.functional.pad(_heads(kw.reshape(b, hb, wb, nk, c), heads), pad)
    vh = torch.nn.functional.pad(
        _heads(extract_halo_windows(v, bs, halo).reshape(b, hb, wb, nk, c), heads), pad)
    return qh, kh, vh, nk


def _by_lane(x, slots):
    """[..., 8 × slots] → [..., slots, 8]: slot lk + 8t at [t, lk]."""
    return x.reshape(*x.shape[:-1], slots, LANES)


def _group_sum(x):
    """x [..., 8 lanes] summed as the lanes do (shuffles xor 1, 2, 4)."""
    idx = torch.arange(LANES)
    for mask in (1, 2, 4):
        x = x + x[..., idx ^ mask]
    return x[..., 0]


def _reduce_scatter(part):
    """part [..., 8 lanes, hd]: the sums over the lanes in the order of the
    kernel's reduce-scatter (xor 4, then 2, then 1), channel 8p + L of each
    pass of 8 finished by lane L."""
    idx = torch.arange(LANES)
    for mask in (4, 2, 1):
        part = part + part[..., idx ^ mask, :]
    hd = part.shape[-1]
    return part[..., torch.arange(hd) % LANES, torch.arange(hd)]


def _lane_partials(p, b, slots):
    """p [.., rows, 8 slots] (logits-shaped), b [.., 8 slots, hd]: each lane's
    sum over its slots, [.., rows, 8 lanes, hd], slot by slot."""
    pl = _by_lane(p, slots)  # [.., rows, T, 8]
    bl = b.reshape(*b.shape[:-2], slots, LANES, b.shape[-1])  # [.., T, 8, hd]
    acc = torch.zeros(*pl.shape[:-2], LANES, b.shape[-1])
    for t in range(slots):
        acc = acc + pl[..., t, :, None] * bl[..., None, t, :, :]
    return acc


def _halves(x, halves):
    """[..., halves × 8T] → [..., halves, 8T]: each warp's slots of a chunk."""
    return x.reshape(*x.shape[:-1], halves, x.shape[-1] // halves)


def _row_sum(x, slots, halves):
    """x [.., rows, slots of a chunk] summed per lane, over a half's 8 lanes
    (shuffles) and over the halves in order."""
    per_half = _group_sum(_by_lane(_halves(x, halves), slots).sum(-2))
    total = per_half[..., 0]
    for h in range(1, halves):
        total = total + per_half[..., h]
    return total[..., None]


def _stats(s, slots, halves, m, l):
    """The online row statistics after one chunk's logits s [.., rows, slots]."""
    mn = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - mn)
    l = l * alpha + _row_sum(torch.exp(s - mn), slots, halves)
    return mn, l, alpha


def _chunk_logits(qh, kh, c, ck, nk, scale):
    s = torch.matmul(qh, kh[..., c * ck:(c + 1) * ck, :].transpose(-1, -2)) * scale
    keys = torch.arange(c * ck, (c + 1) * ck)
    return s.masked_fill(keys >= nk, float("-inf"))


def _warp_row_sum(e):
    """e [..., nk] summed as PyTorch's warp softmax sums a row on the card:
    lane L of 32 the keys j = L mod 32 in order, then lanes xor 16, 8, 4, 2,
    1."""
    nk = e.shape[-1]
    lanes = torch.nn.functional.pad(e, (0, -nk % 32)).reshape(*e.shape[:-1], -1, 32)
    p = torch.zeros(lanes.shape[:-2] + (32,))
    for it in range(lanes.shape[-2]):
        p = p + lanes[..., it, :]
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        p = p + p[..., idx ^ off]
    return p[..., :1]


def _kernel_row_sum(e, slots):
    """The same sum as K1's lanes take it: 8 lanes a row, lane lk holding the
    keys j = lk + 8u of its chunks (8 × `slots` keys a chunk), each in four
    partials a = u mod 4 (the warp's lanes lk + 8a), then (p0 + p2) + (p1 +
    p3) and lanes xor 4, 2, 1."""
    nk = e.shape[-1]
    by_key = torch.nn.functional.pad(e, (0, -nk % (8 * slots))).reshape(*e.shape[:-1], -1, 8)
    part = torch.zeros(by_key.shape[:-2] + (4, 8))
    for u in range(by_key.shape[-2]):
        part[..., u % 4, :] = part[..., u % 4, :] + by_key[..., u, :]
    v = (part[..., 0, :] + part[..., 2, :]) + (part[..., 1, :] + part[..., 3, :])
    idx = torch.arange(8)
    for off in (4, 2, 1):
        v = v + v[..., idx ^ off]
    return v[..., :1]


def fwd_replay(q, k, v, rel_h, rel_w, *, block_size, halo_size, num_heads, residual=None):
    """K1's float32 body in plain PyTorch: the logits of every key, the row
    max, exp(s − m) summed as its lanes sum it (`_kernel_row_sum`, the warp
    softmax's order), P = exp / sum, and P·v summed key by key."""
    b, h, w, c = q.shape
    bs, hd = block_size, c // num_heads
    plan = attention_f32_plan(bs, halo_size, hd)
    qh, kh, vh, nk = _operands(q, k, v, rel_h, rel_w, bs, halo_size, num_heads,
                               (bs + 2 * halo_size) ** 2)
    scale = torch.tensor(hd, dtype=torch.float32) ** -0.5
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / _kernel_row_sum(e, plan.slots_fwd)
    o = torch.zeros(qh.shape)
    for j in range(nk):
        o = o + p[..., j:j + 1] * vh[..., j:j + 1, :]
    hb, wb = h // bs, w // bs
    out = o.permute(0, 1, 2, 4, 3, 5).reshape(b, hb, wb, bs * bs, c)
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


def bwd_replay(q, k, v, rel_h, rel_w, do, *, block_size, halo_size, num_heads):
    """K4's float32 body in plain PyTorch: the row statistics (online over
    the chunks), D = Σ dattn·P per lane, over a half's lanes and over the
    two halves, then per chunk dl = P (dattn − D), each half's dq summed per
    lane and reduce-scattered (the halves added at the end), the window
    partials dk_w = dlᵀ·q·scale and dv_w = Pᵀ·do summed over the rows in
    order; the gather's and the bias reduction's fixed orders."""
    b, h, w, c = q.shape
    bs, hd, half = block_size, c // num_heads, c // num_heads // 2
    plan = attention_f32_plan(bs, halo_size, hd)
    slots, nc = plan.slots_bwd, plan.chunks_bwd
    ck = 2 * LANES * slots
    qh, kh, vh, nk = _operands(q, k, v, rel_h, rel_w, bs, halo_size, num_heads, nc * ck)
    doh = _heads(blocks_from_image(do, bs), num_heads)
    scale = torch.tensor(hd, dtype=torch.float32) ** -0.5
    m = torch.full(qh.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    for ci in range(nc):
        m, l, _ = _stats(_chunk_logits(qh, kh, ci, ck, nk, scale), slots, 2, m, l)
    tile = lambda x, ci: x[..., ci * ck:(ci + 1) * ck, :]  # noqa: E731

    def probs_dattn(ci):
        p = torch.exp(_chunk_logits(qh, kh, ci, ck, nk, scale) - m) / l
        return p, torch.matmul(doh, tile(vh, ci).transpose(-1, -2))

    dsum = torch.zeros_like(m)
    for ci in range(nc):
        p, dattn = probs_dattn(ci)
        dsum = dsum + _row_sum(dattn * p, slots, 2)
    dq_halves = [torch.zeros(qh.shape), torch.zeros(qh.shape)]
    dk_w, dv_w = torch.zeros(kh.shape), torch.zeros(kh.shape)
    for ci in range(nc):
        p, dattn = probs_dattn(ci)
        dl = p * (dattn - dsum)
        for hh in range(2):
            keys = slice(hh * LANES * slots, (hh + 1) * LANES * slots)
            part = _lane_partials(dl[..., keys], tile(kh, ci)[..., keys, :], slots)
            dq_halves[hh] = dq_halves[hh] + _reduce_scatter(part)
        kw_acc, vw_acc = torch.zeros(tile(kh, ci).shape), torch.zeros(tile(kh, ci).shape)
        for r in range(bs * bs):  # the tiles sum over the query rows in order
            kw_acc = kw_acc + dl[..., r, :, None] * qh[..., r, None, :]
            vw_acc = vw_acc + p[..., r, :, None] * doh[..., r, None, :]
        dk_w[..., ci * ck:(ci + 1) * ck, :] = kw_acc * scale
        dv_w[..., ci * ck:(ci + 1) * ck, :] = vw_acc
    hb, wb = h // bs, w // bs
    dq = (dq_halves[0] + dq_halves[1]) * scale
    dq = image_from_blocks(dq.permute(0, 1, 2, 4, 3, 5).reshape(b, hb, wb, bs * bs, c), bs)
    part = lambda x: x[..., :nk, :].permute(0, 1, 2, 4, 3, 5).reshape(b * hb * wb, nk, c)  # noqa: E731
    dk_part, dv_part = part(dk_w), part(dv_w)
    dk = gather_partials(dk_part, b, h, w, bs, halo_size)
    dv = gather_partials(dv_part, b, h, w, bs, halo_size)
    per_head = dk_part.reshape(-1, nk, num_heads, hd)
    groups = [per_head[g:g + BIAS_GROUP].sum(0).sum(1)
              for g in range(0, len(per_head), BIAS_GROUP)]
    window = bs + 2 * halo_size
    dbias = torch.stack(groups).sum(0).reshape(window, window, hd)
    return dq, dk, dv, dbias[..., :half].sum(1), dbias[..., half:].sum(0)


def _close(got, ref, tol=TOL, name=""):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= tol, (name, err)


# (block, halo, heads, C) at block 8: halo 1 (K1 and K4 one chunk), 3 (the
# prod one, 4 heads of 64: K1 two chunks, K4 one), 4 and 6 (K4 two), 8 (K1
# six, K4 three); block 4; head_ch 12, 16, 32, 48 and 64
REPLAY_CASES = [(8, 1, 2, 32), (8, 3, 4, 256), (8, 4, 2, 96), (8, 6, 2, 64), (8, 8, 2, 24),
                (4, 1, 2, 32), (4, 4, 2, 128)]


@pytest.mark.parametrize("bs,halo,heads,c", REPLAY_CASES)
def test_fwd_replay_matches_plain(bs, halo, heads, c):
    """Chunks of 8 × slots keys, the online statistics, the per-lane sums
    reduce-scattered, the division at the end: the plain forward at 1e-5."""
    q, k, v, rel_h, rel_w, res = _inputs(bs * 10 + halo, 1, 2 * bs, 3 * bs, c, heads, bs, halo)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads)
    ref = block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw, residual=res)
    _close(fwd_replay(q, k, v, rel_h, rel_w, **kw, residual=res), ref)


@pytest.mark.parametrize("bs,halo,heads,c", REPLAY_CASES)
def test_bwd_replay_matches_plain(bs, halo, heads, c):
    """The statistics and D over the chunks, dl, dq per lane, the window
    partials over the rows, their gather and grouped bias sum: the plain
    backward at 1e-5 for all five gradients."""
    q, k, v, rel_h, rel_w, do = _inputs(bs * 10 + halo + 1, 1, 2 * bs, 3 * bs, c, heads, bs,
                                        halo)
    kw = dict(block_size=bs, halo_size=halo, num_heads=heads)
    ref = block_halo_attention_bwd_torch(q, k, v, rel_h, rel_w, do, **kw)
    got = bwd_replay(q, k, v, rel_h, rel_w, do, **kw)
    for name, g, r in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, ref, strict=True):
        _close(g, r, name=name)


@pytest.mark.parametrize("nk,slots", [(196, 13), (100, 13), (144, 9), (36, 5), (576, 12)])
def test_k1_lanes_sum_as_the_warp_softmax(nk, slots):
    """K1's four partials a lane and (p0 + p2) + (p1 + p3) then lanes xor
    4, 2, 1 give the warp softmax's row sum to the bit: the first two steps
    of its butterfly (lanes xor 16 and 8) pair keys inside one lane of 8."""
    e = torch.as_tensor(np.random.default_rng(nk).random((5, nk)), dtype=torch.float32)
    assert torch.equal(_kernel_row_sum(e, slots), _warp_row_sum(e))


def test_reduce_scatter_is_the_lane_sum():
    """The reduce-scatter's butterfly finishes every channel with the sum of
    all 8 lanes' partials (each channel by the lane that owns it)."""
    part = torch.as_tensor(np.random.default_rng(2).standard_normal((3, LANES, 64)),
                           dtype=torch.float32)
    _close(_reduce_scatter(part), part.sum(-2), 1e-6)
    torch.testing.assert_close(_group_sum(part[..., 0].contiguous()), part[..., 0].sum(-1))


def test_overlap_add_is_the_gather():
    """The gather's raster-order sum of the window partials is the plain
    backward's overlap-add (out-of-frame keys dropped)."""
    rng = np.random.default_rng(4)
    b, h, w, c, bs, halo = 1, 16, 24, 8, 8, 5
    window = bs + 2 * halo
    part = torch.as_tensor(rng.standard_normal((b * 2 * 3, window * window, c)),
                           dtype=torch.float32)
    want = overlap_add_windows(part.reshape(b, 2, 3, window, window, c), h, w, bs, halo)
    _close(gather_partials(part, b, h, w, bs, halo), want, 1e-6)


def _tpu_case():
    """2 heads, C 32 (head_ch 16), a 32² image, block 8, halo 3, float32."""
    return _inputs(23, 1, 32, 32, 32, 2, 8, 3)


def test_fwd_replay_matches_tpu_kernel_interpret():
    q, k, v, rel_h, rel_w, _ = _tpu_case()
    kw = dict(block_size=8, halo_size=3, num_heads=2)
    with pltpu.force_tpu_interpret_mode():
        want = block_halo_attention_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v, rel_h,
                                                                              rel_w)), **kw)
    _close(fwd_replay(q, k, v, rel_h, rel_w, **kw), torch.from_numpy(np.array(want)))


def test_bwd_replay_matches_tpu_kernel_interpret():
    q, k, v, rel_h, rel_w, do = _tpu_case()
    kw = dict(block_size=8, halo_size=3, num_heads=2)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: block_halo_attention_pallas(*a, **kw),
                         *(jnp.asarray(t.numpy()) for t in (q, k, v, rel_h, rel_w)))
        want = vjp(jnp.asarray(do.numpy()))
    got = bwd_replay(q, k, v, rel_h, rel_w, do, **kw)
    for name, g, r in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, want, strict=True):
        _close(g, torch.from_numpy(np.array(r)), name=name)


@pytest.mark.parametrize("hd", [4, 8, 16, 24, 32, 48, 64])
def test_f32_plan(hd):
    """Both kernels fit one CTA at every block 4 / 8 and halo; a lane holds
    at most 13 slots and a thread at most 136 f32 values in registers; K4
    takes one chunk (one pass) while the window has at most 208 keys; K1
    runs 4 warps at block 8 (three CTAs an SM at the prod shape), K4 8."""
    for bs in (4, 8):
        for halo in range(1, bs + 1):
            plan = attention_f32_plan(bs, halo, hd)
            nk = (bs + 2 * halo) ** 2
            assert plan.smem_fwd <= MAX_SMEM and plan.smem_bwd <= MAX_SMEM, (bs, halo)
            assert (plan.threads_fwd, plan.threads_bwd) == (2 * bs * bs, 4 * bs * bs)
            assert max(plan.slots_fwd, plan.slots_bwd) <= attention_cuda.F32_SLOTS
            assert plan.values_fwd <= 136 and plan.values_bwd <= 136
            assert (plan.chunks_bwd == 1) == (nk <= 208)
            for chunks, width in ((plan.chunks_fwd, 8 * plan.slots_fwd),
                                  (plan.chunks_bwd, 16 * plan.slots_bwd)):
                assert nk <= width * chunks and width * (chunks - 1) < nk
    prod = attention_f32_plan(8, 3, 64)
    assert (prod.chunks_fwd, prod.slots_fwd, prod.chunks_bwd, prod.slots_bwd) == (2, 13, 1, 13)
    assert (prod.smem_fwd, prod.smem_bwd) == (73_984, 220_160)
    assert 3 * (prod.smem_fwd + 1024) <= 233_472  # three K1 CTAs an SM (1 KB reserved each)
    for bad in (6, 68, 128):
        with pytest.raises(ValueError, match="head_ch"):
            attention_f32_plan(8, 3, bad)


def test_f32_gate():
    """"f32" for float32 at head_ch a multiple of 4 up to 64, block 4 or 8,
    1 ≤ halo ≤ block and 16-byte aligned tensors; other fp32 shapes take
    the general body; bf16 keeps its bodies."""
    x = torch.zeros(64)
    assert attention_body(torch.float32, 256, 4, 8, 3, x) == "f32"  # prod
    for halo in range(1, 9):
        assert attention_body(torch.float32, 256, 4, 8, halo) == "f32"
    assert attention_body(torch.float32, 16, 4, 8, 3) == "f32"  # head_ch 4
    assert attention_body(torch.float32, 96, 2, 4, 4) == "f32"  # head_ch 48, block 4
    assert attention_body(torch.float32, 24, 4, 8, 3) == "general"  # head_ch 6
    assert attention_body(torch.float32, 256, 2, 8, 3) == "general"  # head_ch 128
    assert attention_body(torch.float32, 256, 4, 16, 3) == "general"  # block 16
    assert attention_body(torch.float32, 256, 4, 2, 1) == "general"  # block 2
    assert attention_body(torch.float32, 256, 4, 8, 3, x[1:]) == "general"  # 4 bytes off
    assert attention_body(torch.float16, 256, 4, 8, 3) == "general"
    assert attention_body(torch.bfloat16, 256, 4, 8, 3) == "tc"


def test_f32_counters_and_cpu_dispatch():
    """The wrappers count the f32 body's launches; on CPU tensors the body
    refuses before counting and the dispatchers run the plain versions,
    counting nothing."""
    fns = (attention_cuda.block_halo_attention_cuda,
           attention_cuda.block_halo_attention_bwd_cuda)
    for fn in fns:
        assert fn.body_launches["f32"] >= 0
    q = torch.zeros(1, 8, 8, 32)
    rel = torch.zeros(14, 8)
    kw = dict(block_size=8, halo_size=3, num_heads=2)
    before = [(fn.launches, dict(fn.body_launches)) for fn in fns]
    for grad in (None, q):
        with pytest.raises(ValueError, match="CUDA"):
            attention_cuda.attention_body_launch("f32", q, q, q, rel, rel, grad, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.block_halo_attention_bwd_cuda(q, q, q, rel, rel, q, **kw)
    assert block_halo_attention(q, q, q, rel, rel, **kw).shape == q.shape
    assert block_halo_attention_bwd(q, q, q, rel, rel, q, **kw)[0].shape == q.shape
    assert [(fn.launches, dict(fn.body_launches)) for fn in fns] == before

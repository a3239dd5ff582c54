"""PyTorch port: the plan of K7's and K8's tensor-core bodies, on the CPU.

The tensor-core bodies (`csrc/ssd_chain.cuh`, `csrc/ssd_bwd.cu`) compute
the fused Mamba2 interior in another order than the plain versions: the
scores C·Bᵀ once per chunk for all heads, then a walk over the heads; in
the backward, intra-chunk and head rest fused per head with W never
stored, the sum over heads of dS taken in head order, and dB/dC from that
sum. `chain_fwd_plan` and `chain_bwd_plan` below are plain PyTorch in that
order, with every chunk product through `mm`; they hold the algebra
against `fused_mamba_chain_torch` / `fused_mamba_chain_bwd_torch` before
the card does (f32 sums in another order: 1e-5 of the largest magnitude).

The precision control emulates the kernels' products on the CPU: tf32
operands (each mantissa rounded to 10 bits, to nearest with ties away, as
`cvt.rna.tf32.f32`) split as in `csrc/tf32x3.cuh`. With 3×TF32 products the
emit variant's output and entering states pass both rows of chip_smoke's
`MAMBA_TOL`; with one tf32 pass the states, K8's input, fail its fp32 row
(the output's error is diluted by the exact D skip and the RMSNorm).

Also here: the body gate, the tensor-core kernels' shared memory at every
shape the gate admits, the body counters, the profile tools' labels.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pixel_heal_thyself_tpu_torch.ops import ssd_mega
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (
    MAX_SMEM,
    fused_mamba_chain_bwd_cuda,
    fused_mamba_chain_cuda,
    fused_mamba_chain_emit_cuda,
    ssd_chain_body,
    ssd_tc_smem,
)

REPO = Path(__file__).resolve().parent.parent
# (b, l, d_inner, d_state, headdim, chunk): tests/test_torch_port_cuda.py's
# MAMBA_CONFIGS, the prod width last
CONFIGS = [(2, 256, 128, 64, 64, 64), (1, 128, 128, 32, 32, 32), (2, 192, 256, 64, 64, 64),
           (2, 1024, 128, 16, 32, 128), (1, 512, 256, 8, 128, 128), (1, 256, 128, 32, 8, 16),
           (1, 1024, 1024, 64, 64, 128)]
PLAN_TOL = 1e-5


def _chain_inputs(seed, dtype, b, l, d_inner, d_state, headdim, k=4) -> list:
    """tests/test_torch_port_cuda.py `_chain_inputs`, on the CPU."""
    rng = np.random.default_rng(seed)
    h, dc = d_inner // headdim, d_inner + 2 * d_state

    def rand(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32)

    return [rand((b, l, 2 * d_inner + 2 * d_state + h), 0.5).to(dtype), rand((k, dc), 0.2),
            rand((dc,), 0.1), torch.as_tensor(rng.uniform(-4.0, -1.0, h), dtype=torch.float32),
            torch.as_tensor(-np.exp(rng.uniform(0.0, 1.5, h)), dtype=torch.float32),
            rand((h,)), 1.0 + rand((d_inner,), 0.1)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x's mantissa rounded to 10 bits, to nearest with ties away from zero
    (`cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_f32(a, b):
    return a @ b


def mm_tf32x3(a, b):
    """tf32x3.cuh's product: a_hi·b_hi plus the cross terms a_lo·b_hi +
    a_hi·b_lo, each operand split as a_hi = tf32(a), a_lo = tf32(a − a_hi)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def mm_tf32(a, b):
    """One tf32 pass: what the split exists to avoid."""
    return tf32(a) @ tf32(b)


def _views(xbc, dt, d_inner, d_state, headdim):
    b, nc, q, h = dt.shape
    x = xbc[..., :d_inner].reshape(b, nc, q, h, headdim)
    Bm = xbc[..., d_inner:d_inner + d_state].reshape(b, nc, q, d_state)
    Cm = xbc[..., d_inner + d_state:].reshape(b, nc, q, d_state)
    return x, Bm, Cm


def _decay(c_, causal):
    """exp(cum_t − cum_j) for j ≤ t, else 0, of one head's cum [b, nc, q]."""
    diff = c_[..., :, None] - c_[..., None, :]
    return torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)


def _chunk_outputs(x, Bm, Cm, dt, cum, D, states, mm):
    """The tensor-core chunk output: scores once per chunk, then per head
    y = (C·st) exp(cum) + W·x + D x, W = scores ⊙ decay ⊙ dt_j."""
    q, h = dt.shape[2], dt.shape[3]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    scores = mm(Cm, Bm.transpose(-1, -2))
    ys = []
    for hh in range(h):
        c_, d_, xh = cum[..., hh], dt[..., hh], x[..., hh, :]
        w = scores * _decay(c_, causal) * d_[..., None, :]
        ys.append(mm(Cm, states[:, :, hh].float()) * torch.exp(c_)[..., None] + mm(w, xh)
                  + xh * D[hh])
    return torch.stack(ys, dim=3)


def chain_fwd_plan(zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, d_inner, d_state, headdim,
                   chunk, mm=mm_f32):
    """K7's tensor-core body in plain PyTorch: (out, the entering states in
    zxbcdt's dtype)."""
    zx = zxbcdt.float()
    xbc, dt, cum = ssd_mega.chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    b, nc, q, h = dt.shape
    x, Bm, Cm = _views(xbc, dt, d_inner, d_state, headdim)
    last = cum[:, :, -1]
    # the chunk states, head by head: B^T (x dt exp(cum_last − cum))
    S = torch.stack([
        mm(Bm.transpose(-1, -2),
           x[..., hh, :] * (dt[..., hh] * torch.exp(last[..., None, hh] - cum[..., hh]))[..., None])
        for hh in range(h)], dim=2)
    st, entering = torch.zeros_like(S[:, 0]), []
    for c in range(nc):
        entering.append(st)
        st = torch.exp(last[:, c])[..., None, None] * st + S[:, c]
    states = torch.stack(entering, dim=1)
    y = _chunk_outputs(x, Bm, Cm, dt, cum, D, states, mm).reshape(b, nc * q, d_inner)
    return ssd_mega.chain_norm(y, zx[..., :d_inner], norm_w, zxbcdt.dtype), states.to(zxbcdt.dtype)


def chain_bwd_plan(zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, states, dy, d_inner, d_state,
                   headdim, chunk, mm=mm_f32):
    """K8's tensor-core body in plain PyTorch, at the saved entering
    `states`: the recompute through the chunk output; the dstate local
    terms as the per-head [n, p] product; launch 6' (per head, in order:
    dW, W, dS summed over heads, the dcum row and column sums, the readout,
    B·dst, Wᵀ·dy, the head rest); launch 8' (dB, dC from the sum of dS)."""
    zx = zxbcdt.float()
    xbc, dt, cum = ssd_mega.chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    b, nc, q, h = dt.shape
    l, p = nc * q, headdim
    x, Bm, Cm = _views(xbc, dt, d_inner, d_state, headdim)
    y = _chunk_outputs(x, Bm, Cm, dt, cum, D, states, mm).reshape(b, l, d_inner)
    dy_ssd, dz, dnw = ssd_mega.chain_norm_bwd(y, zx[..., :d_inner], norm_w,
                                              dy.to(zxbcdt.dtype).float())
    dys = dy_ssd.reshape(b, nc, q, h, p)
    local = torch.stack([mm(Cm.transpose(-1, -2), dys[..., hh, :] * torch.exp(cum[..., hh])[..., None])
                         for hh in range(h)], dim=2)
    dst = ssd_mega.chain_reverse_carry(local, cum)

    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    scores = mm(Cm, Bm.transpose(-1, -2))
    ds_sum = torch.zeros(b, nc, q, q)
    dC, dB = torch.zeros(b, nc, q, d_state), torch.zeros(b, nc, q, d_state)
    dx, ddt = torch.empty(b, nc, q, h, p), torch.empty(b, nc, q, h)
    dA, dD = torch.empty(h), torch.empty(h)
    for hh in range(h):  # launch 6', one head after the other
        c_, d_, xh, dyh = cum[..., hh], dt[..., hh], x[..., hh, :], dys[..., hh, :]
        st_h, dst_h = states[:, :, hh].float(), dst[:, :, hh]
        lm = _decay(c_, causal)
        dw = mm(dyh, (xh * d_[..., None]).transpose(-1, -2))
        w = scores * lm
        ds_sum = ds_sum + dw * lm
        dd = dw * w
        e, d2 = torch.exp(c_), torch.exp(c_[..., -1:] - c_)
        pc = (dyh * e[..., None] * mm(Cm, st_h)).sum(-1)
        dxs = mm(Bm, dst_h)
        xdt_s = xh * d_[..., None] * d2[..., None]
        pd = (dxs * xdt_s).sum(-1)
        dxdt = mm(w.transpose(-1, -2), dyh) + dxs * d2[..., None]
        dcum = (dd.sum(-1) - dd.sum(-2)) + pc - pd
        dlast = torch.exp(c_[..., -1]) * (dst_h * st_h).sum(dim=(-1, -2)) + pd.sum(-1)
        dda = dcum.flip(-1).cumsum(-1).flip(-1) + dlast[..., None]
        ddt[..., hh] = dda * A[hh] + (dxdt * xh).sum(-1)
        dx[..., hh, :] = dxdt * d_[..., None] + dyh * D[hh]
        dA[hh], dD[hh] = (dda * d_).sum(), (dyh * xh).sum()
        # launch 8', the per-head terms
        dC = dC + mm(dyh * e[..., None], st_h.transpose(-1, -2))
        dB = dB + mm(xdt_s, dst_h.transpose(-1, -2))
    dC = dC + mm(ds_sum, Bm)  # launch 8', the sum over heads of dS
    dB = dB + mm(ds_sum.transpose(-1, -2), Cm)
    dxbc = torch.cat([dx.reshape(b, l, d_inner), dB.reshape(b, l, -1), dC.reshape(b, l, -1)], -1)
    dxr, dw_, db_, ddtr, dbias = ssd_mega.chain_prologue_bwd(zx, conv_w, conv_b, dt_bias, dxbc,
                                                             ddt.reshape(b, l, h), d_inner)
    dzx = torch.cat([dz, dxr, ddtr], dim=-1).to(zxbcdt.dtype)
    return dzx, dw_, db_, dbias, dA, dD, dnw


def _rel(got, ref) -> tuple:
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item() + 1e-30
    err = (got - ref).abs()
    return err.max().item() / scale, err.pow(2).mean().sqrt().item() / scale


@pytest.mark.parametrize("cfg", CONFIGS)
def test_fwd_plan_matches_plain_chain(cfg):
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(0, torch.float32, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    ref, ref_states = ssd_mega.fused_mamba_chain_torch(*args, **dims, emit=True)
    got, states = chain_fwd_plan(*args, **dims)
    assert _rel(got, ref)[0] <= PLAN_TOL
    assert _rel(states, ref_states)[0] <= PLAN_TOL


@pytest.mark.parametrize("cfg", CONFIGS)
def test_bwd_plan_matches_plain_backward(cfg):
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(1, torch.float32, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    _, states = ssd_mega.fused_mamba_chain_torch(*args, **dims, emit=True)
    dy = torch.as_tensor(np.random.default_rng(2).standard_normal((b, l, d_inner)),
                         dtype=torch.float32)
    ref = ssd_mega.fused_mamba_chain_bwd_torch(*args, states, dy, **dims)
    got = chain_bwd_plan(*args, states, dy, **dims)
    names = ("dzx", "conv_w", "conv_b", "dt_bias", "A", "D", "norm_w")
    for name, g, r in zip(names, got, ref, strict=True):
        assert g.shape == r.shape, name
        assert _rel(g, r)[0] <= PLAN_TOL, (name, _rel(g, r))


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("cfg", [CONFIGS[0], CONFIGS[1], CONFIGS[3], CONFIGS[6]])
@pytest.mark.parametrize("label,dtype", [("bf16", torch.bfloat16), ("fp32", torch.float32)])
def test_tf32x3_products_pass_and_one_pass_fails(cfg, label, dtype):
    """The emit variant with every chunk product at 3×TF32 stays within both
    rows of chip_smoke's MAMBA_TOL (output and states); with one tf32 pass
    the entering states fail the fp32 row."""
    tol = _chip_smoke().MAMBA_TOL
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(3, dtype, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    ref = ssd_mega.fused_mamba_chain_torch(*args, **dims, emit=True)
    for got, want in zip(chain_fwd_plan(*args, **dims, mm=mm_tf32x3), ref):
        mx, rms = _rel(got, want)
        assert mx <= tol[label][0] and rms <= tol[label][1], (mx, rms)
    if label == "fp32":
        mx, rms = _rel(chain_fwd_plan(*args, **dims, mm=mm_tf32)[1], ref[1])
        assert mx > tol["fp32"][0] or rms > tol["fp32"][1], (mx, rms)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # representable in tf32
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-20, 1.0 + 2.0**-12, -(1.0 + 2.0**-11),
                      one], dtype=torch.float32)
    want = torch.tensor([one, one, 1.0, -one, one], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    # the split a = hi + lo, both tf32, within 2**-22 of |a|
    a = torch.as_tensor(np.random.default_rng(5).standard_normal(4096), dtype=torch.float32)
    hi = tf32(a)
    assert ((hi + tf32(a - hi)) - a).abs().le(2.0**-22 * a.abs()).all()


@pytest.mark.parametrize("d_state,headdim,chunk,body", [
    (64, 64, 128, "tc"),        # prod
    (64, 8, 128, "general"),    # headdim 8
    (16, 32, 128, "tc"), (32, 32, 32, "tc"), (64, 64, 64, "tc"), (48, 16, 96, "tc"),
    (8, 128, 128, "general"),   # d_state 8, headdim 128
    (32, 8, 16, "general"),     # chunk 16
    (64, 128, 128, "general"), (128, 64, 128, "general"), (24, 64, 128, "general"),
    (64, 64, 256, "general"), (64, 64, 48, "general"),
])
def test_ssd_chain_body_gate(d_state, headdim, chunk, body):
    assert ssd_chain_body(d_state, headdim, chunk) == body


def _admitted():
    return [(n, p, q) for q in range(8, 257, 8) for p in (8, 16, 32, 64, 128)
            for n in range(8, 129, 8) if ssd_chain_body(n, p, q) == "tc"]


def test_tc_smem_fits_every_admitted_shape():
    shapes = _admitted()
    assert len(shapes) == 4 * 3 * 4  # chunk 32..128, headdim 16/32/64, d_state 16..64
    for n, p, q in shapes:
        sizes = ssd_tc_smem(n, p, q)
        assert max(sizes.values()) <= MAX_SMEM, (n, p, q, sizes)
        assert all(s % 16 == 0 for s in sizes.values()), (n, p, q, sizes)
    assert ssd_tc_smem(64, 64, 128) == {"output": 221_184, "head_state": 111_616,
                                        "intra_rest": 225_856, "bc": 217_088}


@pytest.mark.parametrize("fn", [fused_mamba_chain_cuda, fused_mamba_chain_emit_cuda,
                                fused_mamba_chain_bwd_cuda])
def test_cpu_dispatch_of_k7_k8_counts_no_launch(fn):
    """The Mamba dispatchers on the CPU run the plain versions: no launch,
    no body count."""
    b, l, d_inner, d_state, headdim, chunk = CONFIGS[1]
    args = _chain_inputs(4, torch.float32, b, l, d_inner, d_state, headdim)
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    before = fn.launches, dict(fn.body_launches)
    out, states = ssd_mega.fused_mamba_chain_emit(*args, **dims)
    ssd_mega.fused_mamba_chain(*args, **dims)
    ssd_mega.fused_mamba_chain_bwd(*args, states, torch.ones_like(out), **dims)
    assert (fn.launches, dict(fn.body_launches)) == before


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::ssd_chunk_output_tc_kernel<float>(float const*, float const*, "
     "float const*, float const*, float const*, float*, (anonymous namespace)::Dims)",
     "K7 chunk output"),
    ("void (anonymous namespace)::ssd_chunk_output_tc_kernel<__nv_bfloat16>(float const*, "
     "float const*, float const*, __nv_bfloat16 const*, float const*, float*, "
     "(anonymous namespace)::Dims)", "K7 chunk output"),
    ("void (anonymous namespace)::ssd_chunk_state_tc_kernel(float const*, float const*, "
     "float const*, float*, (anonymous namespace)::Dims)", "K7 chunk state"),
    ("void (anonymous namespace)::ssd_dstate_local_tc_kernel(float const*, float const*, "
     "float const*, float*, (anonymous namespace)::Dims)", "K8 dstate local"),
    ("void (anonymous namespace)::ssd_intra_rest_tc_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
     "float const*, float const*, float const*, float const*, __nv_bfloat16 const*, float const*, "
     "float const*, float const*, float const*, float*, __nv_bfloat16*, float*, float*, "
     "(anonymous namespace)::Dims)", "K8 intra + head rest"),
    ("void (anonymous namespace)::ssd_bc_tc_kernel<float>(float const*, float const*, "
     "float const*, float const*, float const*, float const*, float const*, float*, "
     "(anonymous namespace)::Dims)", "K8 dB/dC"),
    ("void (anonymous namespace)::ssd_intra_bwd_kernel(float const*, float const*, float const*, "
     "float const*, float*, float*, float*, (anonymous namespace)::Dims)", "K8 intra"),
    ("void (anonymous namespace)::ssd_head_bwd_kernel<float>(float const*)", "K8 head rest"),
])
def test_profile_groups_name_the_tc_bodies(name, label):
    """The profile tools attribute the tensor-core bodies' launches (K8's
    fused intra and head rest under its own label) and keep the general
    bodies' apart."""
    from pixel_heal_thyself_tpu_torch.profile_serving import group

    assert group(name) == label

"""PyTorch port: the plans of K11's tensor-core body and K10's vec body, on
the CPU.

K11's tensor-core body (`csrc/ssd_scan.cu`, bf16) computes the chunked SSD
scan in another order than its plain version `ops.ssd.ssd_pallas_torch`:
the scores C·Bᵀ once per chunk, rounded to bf16, then per head M =
round(G · round(exp(cum_t − cum_j))); every product on bf16 operands with
f32 sums taken k-step by k-step (16 at a time, in order); the chunk sums
S = Bᵀ·v folded into the carry at once, and the state entering each chunk
stored in the input dtype. `scan_tc_plan` below is plain PyTorch in that
order. It is held to chip_smoke's SSD_SCAN_TOL against the plain version
(max 8e-3, rms 1e-5 of the largest output in bf16; 1e-4, 1e-5 in fp32:
the same rounding points, f32 sums in another order), and against the
JAX `ssd_pallas` run in interpret mode at the bounds of
tests/test_torch_port_ssd_pallas.py (fp32 atol 2e-4, rtol 1e-3; bf16 two
ulps of the largest output, 2**-6 of it, since XLA on the CPU fuses some of
the kernel's bf16 roundings away). The plain scan that carries the state
in f32 fails the bf16 rms bound at the same inputs.

K10's vec body (`csrc/conv_silu.cu`) keeps the plain version's dx
arithmetic, product by product, and sums dw and db per (batch, row tile of
`conv_cuda.BWD_ROWS`) with fused multiply-adds in row order, then adds the
tiles' partials in the fixed order of `sum_tiles_kernel`.
`conv_bwd_vec_plan` emulates that order: its dx equals the plain version's
to the bit, and dw and db are within 1e-4 of the largest (CONV_BWD_TOL);
against the JAX kernel in interpret mode, the bounds of
tests/test_torch_port_conv_fused.py.

Also here: both bodies' gates, the tensor-core kernels' shared memory at
every shape the gate admits, the dispatchers' launch counts on the CPU and
the profile tools' labels of the new launches.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pixel_heal_thyself_tpu.ops import conv_pallas  # noqa: E402
from pixel_heal_thyself_tpu.ops import ssd as jssd  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import conv_cuda, conv_fused, ssd  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.conv_cuda import (  # noqa: E402
    conv_bwd_body,
    fused_causal_conv1d_silu_bwd_cuda,
)
from pixel_heal_thyself_tpu_torch.ops.ssd_cuda import (  # noqa: E402
    ssd_pallas_cuda,
    ssd_scan_body,
    ssd_scan_tc_smem,
)
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import MAX_SMEM  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
KSTEP = 16  # the depth of one mma.sync m16n8k16


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _rel(got, ref) -> tuple:
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item() + 1e-30
    err = (got - ref).abs()
    return err.max().item() / scale, err.pow(2).mean().sqrt().item() / scale


def kstep_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the shared dimension 16 at a time, the k-steps' f32 sums
    added in order (the tensor-core bodies' order)."""
    out = None
    for k0 in range(0, a.shape[-1], KSTEP):
        part = a[..., k0:k0 + KSTEP] @ b[..., k0:k0 + KSTEP, :]
        out = part if out is None else out + part
    return out


def scan_tc_plan(x, dt, A, B, C, D=None, chunk: int = 128) -> torch.Tensor:
    """K11's tensor-core plan in plain PyTorch (see the module docstring);
    in fp32 every rounding is the identity."""
    dtype = x.dtype

    def rnd(t):
        return t.to(dtype).float()

    b, l, h, p = x.shape
    q, nc = chunk, l // chunk
    cum, xdt, Bc, Cc = ssd.pallas_stacks(x, dt, A, B, C, chunk)  # sequential f32 cumsum
    xdt, Bc, Cc = xdt.float(), Bc.float(), Cc.float()
    # launch 2: v = round(xdt · round(exp(cum_last − cum))), S = Bᵀ·v, the carry
    dte = rnd(torch.exp(cum[..., -1:] - cum))                          # [b, nc, h, q]
    v = rnd(xdt * dte[..., None])                                      # [b, nc, h, q, p]
    S = kstep_mm(Bc.transpose(-1, -2)[:, :, None], v)                  # [b, nc, h, n, p]
    a = torch.exp(cum[..., -1])                                        # [b, nc, h]
    st = torch.zeros_like(S[:, 0])
    st_in = []
    for c in range(nc):
        st_in.append(st)
        st = rnd(a[:, c, :, None, None] * st + S[:, c])
    st_in = torch.stack(st_in, dim=1)                                  # stored in T
    # launch 3: G once per chunk, M per head, y = M·xdt + exp(cum)·(C·st)
    G = rnd(kstep_mm(Cc, Bc.transpose(-1, -2)))                        # [b, nc, q, q]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    E = rnd(torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, -torch.inf)))
    M = rnd(G[:, :, None] * E)                                         # [b, nc, h, q, q]
    y = kstep_mm(M, xdt) + torch.exp(cum)[..., None] * kstep_mm(Cc[:, :, None], st_in)
    y = rnd(y).transpose(2, 3).reshape(b, l, h, p)
    if D is not None:
        y = rnd(y + rnd(x.float() * D.to(dtype).float()[None, None, :, None]))
    return y.to(dtype)


def _scan_inputs(b, l, h, p, n, seed=0) -> tuple:
    """Seeded numpy inputs (tests/test_mamba.py `_ssd_inputs`' distributions)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, l, h)).astype(np.float32)
    A = -rng.uniform(1, 8, (h,)).astype(np.float32)
    B = (rng.standard_normal((b, l, 1, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, l, 1, n)) * 0.5).astype(np.float32)
    D = rng.standard_normal((h,)).astype(np.float32)
    return x, dt, A, B, C, D


DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (b, l, h, p, n, chunk)
SCAN_CASES = [(2, 512, 4, 16, 16, 32), (2, 512, 4, 64, 64, 128), (1, 512, 2, 64, 16, 32)]


def _both(args, jd, td) -> tuple:
    ja = [jnp.asarray(a).astype(jd) for a in args]
    return ja, [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(td) for a in ja]


@pytest.mark.parametrize("label", list(DTYPES))
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_plan_matches_plain_version(case, label):
    """The plan within SSD_SCAN_TOL of `ssd_pallas_torch`."""
    tol = _chip_smoke().SSD_SCAN_TOL[label]
    b, l, h, p, n, chunk = case
    _, ta = _both(_scan_inputs(b, l, h, p, n), *DTYPES[label])
    got = scan_tc_plan(*ta, chunk=chunk)
    ref = ssd.ssd_pallas_torch(*ta, chunk=chunk)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    mx, rms = _rel(got, ref)
    assert mx <= tol[0] and rms <= tol[1], (mx, rms)


@pytest.mark.parametrize("label", list(DTYPES))
def test_scan_plan_matches_tpu_kernel_interpret(label):
    """The plan against the JAX `ssd_pallas` in interpret mode, at the bounds
    of tests/test_torch_port_ssd_pallas.py."""
    jd, td = DTYPES[label]
    ja, ta = _both(_scan_inputs(2, 128, 4, 16, 16, seed=1), jd, td)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jnp.asarray(jssd.ssd_pallas(*ja, chunk=32, group=2)).astype(jnp.float32))
    got = scan_tc_plan(*ta, chunk=32).float().numpy()
    if label == "fp32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2**-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 1024, 4, 16, 16), (1, 512, 8, 64, 64)])
def test_scan_plan_passes_and_f32_carry_fails_the_bf16_bound(shape):
    """At Mamba-like inputs (chip_smoke.ssd_scan_inputs) the plan passes
    SSD_SCAN_TOL["bf16"] against the plain version, and the plain scan that
    carries the state in f32 fails its rms bound."""
    cs = _chip_smoke()
    tol = cs.SSD_SCAN_TOL["bf16"]
    args = cs.ssd_scan_inputs(torch.device("cpu"), *shape)
    ref = ssd.ssd_pallas_torch(*args, chunk=128)
    mx, rms = _rel(scan_tc_plan(*args, chunk=128), ref)
    assert mx <= tol[0] and rms <= tol[1], (mx, rms)
    assert _rel(cs.f32_carry_scan(*args, chunk=128), ref)[1] > tol[1]


def conv_bwd_vec_plan(zxbcdt, w, b, dy, offset: int, width: int, rows: int) -> tuple:
    """K10's vec body in plain PyTorch: the plain version's dx and dpre;
    dw, db summed per (batch, tile of `rows` rows) by fused multiply-adds
    (db by adds) in row order, then the tiles' partials added as
    `sum_tiles_kernel` adds them: 8 running sums over the partials v, v +
    8, ..., then those 8 in order."""
    dtype = zxbcdt.dtype
    k, l = w.shape[0], zxbcdt.shape[1]
    x = zxbcdt[..., offset:offset + width].float()
    pre = conv_fused._pre(x, w, b)
    sig = torch.sigmoid(pre)
    dpre = dy.to(dtype).float() * (sig * (1 + pre * (1 - sig)))
    wf = w.float()
    dpp = F.pad(dpre, (0, 0, 0, k - 1))
    dx = dpre * wf[k - 1]
    for j in range(k - 1):
        dx = dx + dpp[:, k - 1 - j:k - 1 - j + l] * wf[j]
    # the tap operands of row t: the raw rows t - (k - 1) + j, tap k - 1 the row itself
    xp = F.pad(x, (0, 0, k - 1, 0))
    taps = torch.stack([xp[:, j:j + l] for j in range(k)], dim=2)      # [b, l, k, width]
    tiles = -(-l // rows)
    pad = tiles * rows - l
    dp = F.pad(dpre, (0, 0, 0, pad)).reshape(dpre.shape[0], tiles, rows, width)
    tp = F.pad(taps, (0, 0, 0, 0, 0, pad)).reshape(dpre.shape[0], tiles, rows, k, width)
    dw = torch.zeros(dpre.shape[0], tiles, k, width)
    db = torch.zeros(dpre.shape[0], tiles, width)
    for r in range(rows):  # fmaf: one rounding of dp·x + acc (f64 holds dp·x exactly)
        d_r = dp[:, :, r]
        dw = (d_r[:, :, None].double() * tp[:, :, r].double() + dw.double()).float()
        db = db + d_r
    part = torch.cat([dw, db[:, :, None]], dim=2).reshape(-1, k + 1, width)
    sums = []
    for v in range(8):
        s = torch.zeros(k + 1, width)
        for i in range(v, part.shape[0], 8):
            s = s + part[i]
        sums.append(s)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return dx.to(dtype), out[:k].to(w.dtype), out[k].to(b.dtype)


def _conv_data(l, ctot=512, width=256, k=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, l, ctot)).astype(np.float32),
            (rng.standard_normal((k, width)) * 0.3).astype(np.float32),
            (rng.standard_normal((width,)) * 0.1).astype(np.float32),
            rng.standard_normal((2, l, width)).astype(np.float32))


@pytest.mark.parametrize("label", list(DTYPES))
@pytest.mark.parametrize("l", [200, 512])
def test_conv_bwd_plan_matches_plain_and_tpu_kernel(l, label, monkeypatch):
    """The vec body's order: dx equal to the plain version's to the bit, dw
    and db within CONV_BWD_TOL's 1e-4 of it; against the JAX kernel in
    interpret mode, tests/test_torch_port_conv_fused.py's bounds."""
    tol = _chip_smoke().CONV_BWD_TOL[label]
    jd, td = DTYPES[label]
    z, w, b, dy = _conv_data(l)
    zj = jnp.asarray(z).astype(jd)
    zt = torch.from_numpy(np.asarray(zj.astype(jnp.float32))).to(td)
    dyt = torch.from_numpy(np.asarray(jnp.asarray(dy).astype(jd).astype(jnp.float32))).to(td)
    args = (zt, torch.from_numpy(w), torch.from_numpy(b), dyt, 128, 256)
    got = conv_bwd_vec_plan(*args, rows=conv_cuda.BWD_ROWS)
    ref = conv_fused.fused_causal_conv1d_silu_bwd_torch(*args)
    assert torch.equal(got[0], ref[0])
    for name, g, r in zip(("dw", "db"), got[1:], ref[1:]):
        mx, rms = _rel(g, r)
        assert mx <= tol[name][0] and rms <= tol[name][1], (name, mx, rms)

    if l == 512:  # the TPU kernel's row tiles of 64: the context crosses them
        monkeypatch.setattr(conv_pallas, "_pick_l_tile", lambda _l: 64)
    else:
        return  # 200 is no multiple of a TPU row tile
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda a, c, d: conv_pallas.fused_causal_conv1d_silu(a, c, d, 128, 256, True),
            zj, jnp.asarray(w), jnp.asarray(b))
        want = [np.asarray(jnp.asarray(t).astype(jnp.float32))
                for t in vjp(jnp.asarray(dy).astype(jd))]
    dz = np.zeros_like(want[0])
    dz[..., 128:384] = got[0].float().numpy()
    if label == "fp32":
        for g, r in zip((dz, got[1].numpy(), got[2].numpy()), want, strict=True):
            np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)
        return
    np.testing.assert_allclose(dz, want[0], atol=1e-5, rtol=2**-7)
    for g, r in zip((got[1].numpy(), got[2].numpy()), want[1:], strict=True):
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max(), rtol=1e-4)


@pytest.mark.parametrize("dtype,d_state,headdim,chunk,aligned,body", [
    (torch.bfloat16, 64, 64, 128, True, "tc"),          # prod
    (torch.float32, 64, 64, 128, True, "general"),      # fp32
    (torch.bfloat16, 64, 64, 128, False, "general"),    # a tensor not 16-byte aligned
    (torch.bfloat16, 16, 16, 16, True, "tc"), (torch.bfloat16, 48, 32, 96, True, "tc"),
    (torch.bfloat16, 32, 48, 64, True, "tc"),
    (torch.bfloat16, 64, 64, 144, True, "general"),     # chunk above 128
    (torch.bfloat16, 64, 64, 40, True, "general"),      # chunk not a multiple of 16
    (torch.bfloat16, 80, 64, 128, True, "general"),     # d_state above 64
    (torch.bfloat16, 64, 128, 128, True, "general"),    # headdim above 64
    (torch.bfloat16, 8, 8, 32, True, "general"),        # narrow heads
])
def test_ssd_scan_body_gate(dtype, d_state, headdim, chunk, aligned, body):
    assert ssd_scan_body(dtype, d_state, headdim, chunk, aligned) == body


def test_tc_scan_smem_fits_every_admitted_shape():
    """Every admitted shape fits: the chunk state one CTA an SM, the chunk
    output two (half an SM's 228 KB, less the 1 KB each CTA reserves)."""
    shapes = [(n, p, q) for q in range(8, 257, 8) for p in range(8, 129, 8)
              for n in range(8, 129, 8) if ssd_scan_body(torch.bfloat16, n, p, q) == "tc"]
    assert len(shapes) == 8 * 4 * 4  # chunk 16..128, headdim 16..64, d_state 16..64
    for n, p, q in shapes:
        sizes = ssd_scan_tc_smem(n, p, q)
        assert sizes["state"] <= MAX_SMEM and sizes["output"] <= 233_472 // 2 - 1024, sizes
        assert all(s % 16 == 0 for s in sizes.values()), (n, p, q, sizes)
    assert ssd_scan_tc_smem(64, 64, 128) == {"state": 192_000, "output": 112_640}


@pytest.mark.parametrize("dtype,columns,offset,width,aligned,body", [
    (torch.bfloat16, 2192, 1024, 1152, True, "vec"),    # the prod window
    (torch.float32, 2192, 1024, 1152, True, "vec"),
    (torch.bfloat16, 2192, 1024, 1152, False, "general"),
    (torch.bfloat16, 2192, 1020, 1152, True, "general"),  # offset 2,040 bytes
    (torch.float32, 2192, 1020, 1152, True, "vec"),       # 4,080 bytes
    (torch.bfloat16, 2192, 1024, 1148, True, "general"),  # width
    (torch.bfloat16, 2190, 1024, 1152, True, "general"),  # row stride
    (torch.float32, 2190, 1024, 1152, True, "general"),
    (torch.bfloat16, 100, 10, 50, True, "general"),
])
def test_conv_bwd_body_gate(dtype, columns, offset, width, aligned, body):
    assert conv_bwd_body(dtype, columns, offset, width, aligned) == body


def test_cpu_dispatch_of_k10_k11_counts_no_launch():
    """On the CPU the dispatchers run the plain versions: no launch and no
    body count, whatever the shape would take on the card."""
    cs = _chip_smoke()
    before = (ssd_pallas_cuda.launches, dict(ssd_pallas_cuda.body_launches),
              fused_causal_conv1d_silu_bwd_cuda.launches,
              dict(fused_causal_conv1d_silu_bwd_cuda.body_launches))
    args = cs.ssd_scan_inputs(torch.device("cpu"), 1, 256, 2, 64, 64)
    assert ssd.ssd_pallas(*args, chunk=128).shape == args[0].shape
    z, w, b, dy = (torch.from_numpy(t) for t in _conv_data(64))
    conv_fused.fused_causal_conv1d_silu_bwd(z.bfloat16(), w, b, dy.bfloat16(), 128, 256)
    assert before == (ssd_pallas_cuda.launches, dict(ssd_pallas_cuda.body_launches),
                      fused_causal_conv1d_silu_bwd_cuda.launches,
                      dict(fused_causal_conv1d_silu_bwd_cuda.body_launches))


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::scan_cum_tc_kernel(float const*, float const*, float*, "
     "(anonymous namespace)::ScanDims, int)", "K11 cum"),
    ("void (anonymous namespace)::scan_state_tc_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, float const*, __nv_bfloat16*, (anonymous namespace)::ScanDims)",
     "K11 chunk state + carry"),
    ("void (anonymous namespace)::scan_output_tc_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, float const*, __nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, (anonymous namespace)::ScanDims)", "K11 chunk output"),
    ("void (anonymous namespace)::scan_chunk_output_kernel<float>(float const*)",
     "K11 chunk output"),
    ("void (anonymous namespace)::scan_state_pass_kernel<float>(float*)", "K11 state pass"),
    ("void (anonymous namespace)::conv_silu_bwd_vec_kernel<__nv_bfloat16, 4>(__nv_bfloat16 "
     "const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, "
     "(anonymous namespace)::ConvDims)", "K10 main"),
    ("void (anonymous namespace)::conv_silu_bwd_kernel<float, 4>(float const*)", "K10 main"),
    ("void (anonymous namespace)::sum_tiles_kernel(float const*, float*, int, int)",
     "K10 tap/bias sums"),
    ("void (anonymous namespace)::conv_silu_fwd_kernel<__nv_bfloat16, 4>(__nv_bfloat16 const*)",
     "K9 conv1d + SiLU"),
    ("void (anonymous namespace)::conv_silu_fwd_vec_kernel<__nv_bfloat16, 4>(__nv_bfloat16 "
     "const*, float const*, __nv_bfloat16*, (anonymous namespace)::ConvDims)", "K9 conv1d + SiLU"),
    ("void (anonymous namespace)::conv_silu_fwd_vec_kernel<float, 9>(float const*)",
     "K9 conv1d + SiLU"),
    # K7's prologue, both bodies: not K8's conv backward, not cuDNN
    ("void (anonymous namespace)::ssd_prologue_vec_kernel<__nv_bfloat16, 4>(__nv_bfloat16 "
     "const*, float const*, float const*, float const*, float const*, float*, float*, float*, "
     "int, (anonymous namespace)::Dims)", "K7 prologue"),
    ("void (anonymous namespace)::ssd_prologue_kernel<float>(float const*, float const*, float "
     "const*, float const*, float const*, float*, float*, float*, (anonymous namespace)::Dims)",
     "K7 prologue"),
])
def test_profile_groups_name_k9_k10_k11(name, label):
    from pixel_heal_thyself_tpu_torch.profile_serving import group

    assert group(name) == label

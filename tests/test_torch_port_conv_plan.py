"""PyTorch port: the vec bodies of K9 (the fused conv1d + SiLU forward) and
of K7's prologue, on the CPU.

K9's vec body (`csrc/conv_silu.cu` `conv_silu_fwd_vec_kernel`) keeps the
general body's arithmetic, product by product, so its plan is the plain
version itself (tests/test_torch_port_conv_fused.py holds that against
the TPU kernel in interpret mode); here: its gate and its launch count.

K7's prologue (`csrc/ssd_chain.cuh`), both bodies: acc = x_t·w[k-1]
rounded, then acc = fmaf(x_{t-(k-1)+j}, w[j], acc) for j = 0..k-2, then
silu(acc + b) = pre / (1 + exp(-pre)); dt = softplus(dt_raw + dt_bias);
cum the running fmaf(dt, A, run) down each chunk's rows. The vec body must
give the same bits as the general one (a card test holds that);
`ssd_prologue_plan` is that order in plain PyTorch, each fmaf emulated in
f64 (the f64 product of two f32 values is exact, and one rounding of the
f64 sum to f32 differs from fmaf's single rounding only in rare halfway
cases). Against `ssd_mega.chain_prologue`, which rounds each product and
sum apart and takes F.silu = x·sigmoid(x): xbc and cum within 8 f32 ulps
(2**-20) of their largest magnitude, dt equal (the same softplus). Against
the JAX TPU kernel in interpret mode, through the whole chain
(`fused_mamba_chain_torch` with the plan in place of `chain_prologue`):
1e-4 of the largest output, tests/test_torch_port_mamba_ops.py's bound.

Also here: both gates, the dispatchers' counts on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pixel_heal_thyself_tpu.ops import ssd_mega as jmega  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import conv_fused, ssd_mega  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.conv_cuda import (  # noqa: E402
    conv_bwd_body,
    conv_fwd_body,
    fused_causal_conv1d_silu_cuda,
)
from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import (  # noqa: E402
    fused_mamba_chain_bwd_cuda,
    fused_mamba_chain_cuda,
    fused_mamba_chain_emit_cuda,
    ssd_prologue_body,
)

ULPS8 = 2**-20  # 8 f32 ulps of the largest magnitude


def _fma(a, b, c):
    """fmaf in f32, emulated in f64 (see the module's docstring)."""
    return (a.double() * b.double() + c.double()).float()


def ssd_prologue_plan(zx, conv_w, conv_b, dt_bias, A, d_inner: int, chunk: int) -> tuple:
    """K7's prologue in its kernels' order on f32 `zx` [b, l, width]: (xbc
    [b, l, dc], dt and cum [b, l/chunk, chunk, h]), `chain_prologue`'s
    layout."""
    b, l, _ = zx.shape
    k, dc = conv_w.shape
    h = dt_bias.shape[0]
    x = zx[..., d_inner:d_inner + dc]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = conv_w.float()
    acc = x * w[k - 1]
    for j in range(k - 1):
        acc = _fma(xp[:, j:j + l], w[j], acc)
    pre = acc + conv_b.float()
    xbc = pre / (1 + torch.exp(-pre))
    dt = ssd_mega.softplus(zx[..., d_inner + dc:] + dt_bias.float()).reshape(b, l // chunk,
                                                                            chunk, h)
    run = torch.zeros(b, l // chunk, h)
    cum = []
    for t in range(chunk):
        run = _fma(dt[:, :, t], A.float(), run)
        cum.append(run)
    return xbc, dt, torch.stack(cum, dim=2)


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


def _max_rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


# (b, l, d_inner, d_state, headdim, chunk, k): a narrow shape; the prod
# d_state and headdim at a short sequence; k 3 and k 1
PLAN_CASES = [(2, 256, 64, 16, 16, 64, 4), (1, 256, 128, 64, 64, 128, 4),
              (2, 192, 128, 32, 32, 64, 3), (1, 128, 128, 16, 32, 32, 1)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_prologue_plan_matches_chain_prologue(case, bf16):
    b, l, d_inner, d_state, headdim, chunk, k = case
    zx, conv_w, conv_b, dt_bias, A, _, _ = map(
        torch.from_numpy, _chain_inputs(1, b, l, d_inner, d_state, headdim, k))
    if bf16:  # the kernels read bf16 zxbcdt and widen it to f32
        zx = zx.bfloat16().float()
    got = ssd_prologue_plan(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    ref = ssd_mega.chain_prologue(zx, conv_w, conv_b, dt_bias, A, d_inner, chunk)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in ref]
    assert _max_rel(got[0], ref[0]) <= ULPS8
    assert torch.equal(got[1], ref[1])
    assert _max_rel(got[2], ref[2]) <= ULPS8


@pytest.mark.parametrize("cfg", [(2, 256, 128, 16, 32, 64), (2, 256, 128, 64, 64, 64)])
def test_prologue_plan_chain_matches_tpu_kernel_interpret(cfg, monkeypatch):
    """The whole chain with the prologue in the kernels' order against the
    JAX TPU kernel in interpret mode (1e-4, as the plain chain is held), at
    2 × 256 tokens and the smallest d_inner the TPU kernel takes (128: its
    lane tiles)."""
    b, l, d_inner, d_state, headdim, chunk = cfg
    args = _chain_inputs(0, b, l, d_inner, d_state, headdim)
    want = np.asarray(jmega.fused_mamba_chain(*map(jnp.asarray, args), d_inner, d_state,
                                              headdim, chunk, True), np.float32)
    calls = []

    def plan(*a, **kw):
        calls.append(1)
        return ssd_prologue_plan(*a, **kw)

    monkeypatch.setattr(ssd_mega, "chain_prologue", plan)
    got = ssd_mega.fused_mamba_chain_torch(
        *(torch.from_numpy(a) for a in args), d_inner=d_inner, d_state=d_state,
        headdim=headdim, chunk=chunk)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


# (dtype, columns, d_inner, dc, aligned, body)
@pytest.mark.parametrize("dtype,columns,d_inner,dc,aligned,body", [
    (torch.bfloat16, 2192, 1024, 1152, True, "vec"),     # prod: 4,384, 2,048, 2,304 bytes
    (torch.float32, 2192, 1024, 1152, True, "vec"),
    (torch.bfloat16, 2192, 1024, 1152, False, "general"),  # a tensor not 16-byte aligned
    (torch.bfloat16, 164, 64, 96, True, "general"),     # row of 328 bytes
    (torch.float32, 164, 64, 96, True, "vec"),          # 656 bytes
    (torch.bfloat16, 2192, 1020, 1152, True, "general"),  # offset 2,040 bytes
    (torch.bfloat16, 2192, 1024, 1148, True, "general"),  # width 2,296 bytes
    (torch.float32, 2190, 1024, 1152, True, "general"),   # row stride 8,760 bytes
])
def test_ssd_prologue_body_gate(dtype, columns, d_inner, dc, aligned, body):
    assert ssd_prologue_body(dtype, columns, d_inner, dc, aligned) == body


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
def test_conv_fwd_body_gate(dtype, columns, offset, width, aligned, body):
    assert conv_fwd_body(dtype, columns, offset, width, aligned) == body
    assert conv_bwd_body(dtype, columns, offset, width, aligned) == body


def _counts() -> tuple:
    fns = (fused_causal_conv1d_silu_cuda, fused_mamba_chain_cuda, fused_mamba_chain_emit_cuda,
           fused_mamba_chain_bwd_cuda)
    return tuple((fn.launches, dict(fn.body_launches), dict(getattr(fn, "prologue_body_launches",
                                                                     {}))) for fn in fns)


def test_cpu_dispatch_of_k9_k7_counts_no_launch():
    """On the CPU the dispatchers of K9, K7, K7's emit variant and K8 run
    the plain versions: no launch, no body and no prologue body counted,
    whatever body the shape would take on the card."""
    before = _counts()
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((2, 64, 512)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((4, 256)) * 0.3).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(256) * 0.1).astype(np.float32))
    assert conv_fwd_body(z.dtype, 512, 128, 256) == "vec"
    assert torch.equal(conv_fused.fused_causal_conv1d_silu(z, w, bias, 128, 256),
                       conv_fused.fused_causal_conv1d_silu_torch(z, w, bias, 128, 256))
    b, l, d_inner, d_state, headdim, chunk = 1, 128, 128, 16, 16, 64
    args = [torch.from_numpy(a) for a in _chain_inputs(2, b, l, d_inner, d_state, headdim)]
    args[0] = args[0].bfloat16()
    assert ssd_prologue_body(torch.bfloat16, args[0].shape[-1], d_inner,
                             d_inner + 2 * d_state) == "vec"
    dims = dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)
    ssd_mega.fused_mamba_chain(*args, **dims)
    _, states = ssd_mega.fused_mamba_chain_emit(*args, **dims)
    ssd_mega.fused_mamba_chain_bwd(*args, states, torch.ones(b, l, d_inner).bfloat16(), **dims)
    assert _counts() == before

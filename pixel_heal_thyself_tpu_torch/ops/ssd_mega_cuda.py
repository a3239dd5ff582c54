"""Wrappers of the fused Mamba2-chain kernels: the forward K7
(`csrc/ssd_fwd.cu`) and the backward K8 (`csrc/ssd_bwd.cu`).

K7 replaces the TPU kernel `pixel_heal_thyself_tpu/ops/ssd_mega.py:256`
(`_fwd_kernel_infer`) and, with `emit=True`, its training variant
`_fwd_kernel_train` (:252), which also returns the state entering each
chunk in the input dtype: K7's state pass writes that rounded copy beside
the f32 states it keeps for the chunk outputs. K7 runs as five launches on
the current stream (prologue, chunk states, state pass, chunk outputs,
gated RMSNorm; design in the source's header) with f32 scratch allocated
here: at the prod shape (8 × 16,384 tokens, d_inner 1024, d_state 64)
1.4 GB. K8 replaces the TPU kernel `_bwd_kernel` (:260): the VJP at those
saved states, in ten launches (eleven on the general body) with 2.1 GB of
f32 scratch at that shape (4.2 GB on the general body, which writes W and
dS per head; design in `csrc/ssd_bwd.cu`). The plain
versions are `ops.ssd_mega.fused_mamba_chain_torch` and
`fused_mamba_chain_bwd_torch`. `fused_mamba_chain_cuda.launches`,
`fused_mamba_chain_emit_cuda.launches` and
`fused_mamba_chain_bwd_cuda.launches` count the calls that launched,
`.body_launches` each body's and `.prologue_body_launches` each body of
their first launch's.

Each has two bodies, chosen by the C entries (`pht_ssd_chain_body`): the
tensor-core body ("tc": every chunk product on mma.sync at 3×TF32, the
scores computed once per chunk, K8's W kept on chip) for the shapes of
`ssd_chain_body`, and the general scalar-FMA body for the rest. The
wrappers ask the library which body it takes, to count it and to size
K8's scratch; `ssd_chain_body` states the same rule for callers without
the library, and a card test holds the two equal. Beyond
`supports_shapes`, the card limits a chunk's shared memory to one CTA's
227 KB: the C entries refuse a general-body chunk that needs more (d_state
128 at headdim 64 and chunk 128, which no config uses) with
cudaErrorInvalidValue before they launch anything, and `_build.check`
raises.

Their first launch, the prologue (conv + SiLU of xBC, dt and cum), has
two bodies of its own, which the wrappers pick by `ssd_prologue_body` and
name to the C entries: the vec body (4 channels a thread, a copy ring of
rows, k a template argument; 16-byte aligned windows, the prod shape among
them) and the general one. Both give the same bits. `ssd_prologue_cuda`
runs the prologue alone on a named body, for the comparisons of the two.
"""

from __future__ import annotations

import torch

from pixel_heal_thyself_tpu_torch import _build

MAX_SMEM = 232_448  # the opt-in shared memory of one CTA on the H100
TC_WARPS = 8  # K8's fused intra and head rest: 256 threads, dcum sums per warp


def ssd_chain_body(d_state: int, headdim: int, chunk: int) -> str:
    """The body K7 and K8 take: "tc" (tensor cores) for chunks a multiple
    of 32 up to 128, headdim 16, 32 or 64 and d_state a multiple of 16 up
    to 64 (csrc/ssd_chain.cuh `tc_body`); "general" otherwise."""
    tc = (chunk % 32 == 0 and chunk <= 128 and headdim in (16, 32, 64)
          and d_state % 16 == 0 and 16 <= d_state <= 64)
    return "tc" if tc else "general"


def ssd_tc_smem(d_state: int, headdim: int, chunk: int) -> dict:
    """Dynamic shared memory (bytes) of one CTA of each tensor-core kernel
    of K7 and K8, as the C sources lay it out (`pht_ssd_chain_tc_smem`):
    the chunk output, the per-head [n, p] product (K7's chunk state, K8's
    dstate local), K8's fused intra/head rest and its dB/dC."""
    q, n, p = chunk, d_state, headdim
    tri = (q // 16) * (q // 16 + 1) * 128  # the causal 16 × 8 tiles, packed
    bs = q * (n + 4)
    head = 2 * q * (p + 4) + n * (p + 8) + n * (p + 4) + 2 * q
    floats = {
        "output": tri + max(tri, bs) + bs + 2 * q * (p + 8) + 2 * n * (p + 8) + 4 * q,
        "head_state": q * (n + 8) + 2 * q * (p + 8) + 2 * q,
        "intra_rest": (tri + 2 * q * (n + 4) + 2 * q * (p + 4) + 2 * n * (p + 8)
                       + (2 + 2 * TC_WARPS + 6 + 1) * q + 16),
        "bc": max(tri + 2 * q * (n + 8), head) + head,
    }
    return {name: 4 * f for name, f in floats.items()}


def ssd_prologue_body(dtype: torch.dtype, columns: int, d_inner: int, dc: int,
                      aligned: bool = True) -> str:
    """The body K7's prologue takes (in K7, its emit variant and K8): "vec"
    where the xBC window's offset `d_inner`, zxbcdt's row of `columns` and
    the window's width `dc` are multiples of 16 bytes and the tensors it
    moves 16 bytes at a time (zxbcdt, the f32 taps and bias, xbc) are
    16-byte aligned (csrc/ssd_chain.cuh `prologue_vec_body`); "general"
    otherwise."""
    per = 16 // torch.empty(0, dtype=dtype).element_size()
    vec = aligned and d_inner % per == 0 and columns % per == 0 and dc % per == 0
    return "vec" if vec else "general"


def _prologue_body(zxbcdt, d_inner: int, conv_w, conv_b, xbc) -> str:
    """The prologue's body for these tensors (`ssd_prologue_body`)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (zxbcdt, conv_w, conv_b, xbc))
    return ssd_prologue_body(zxbcdt.dtype, zxbcdt.shape[-1], d_inner, conv_w.shape[1], aligned)


def _body(chunk: int, d_state: int, headdim: int) -> str:
    """The body the library takes for this shape."""
    return "tc" if _build.lib().pht_ssd_chain_body(chunk, d_state, headdim) else "general"


def _checked(what: str, zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim, chunk,
             *tensors) -> tuple:
    """Refuse what the kernels do not take; (b, l, k, dc, h)."""
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import chain_dims, supports_shapes

    _build.refuse_autograd(what, zxbcdt, conv_w, dt_bias, *tensors)
    if zxbcdt.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {zxbcdt.device}")
    if zxbcdt.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {zxbcdt.dtype} (bf16 or fp32)")
    if not zxbcdt.is_contiguous():
        raise ValueError(f"{what} needs a contiguous zxbcdt")
    b, l, k, dc, h = chain_dims(zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim)
    if not supports_shapes(l, d_inner, 1, d_state, headdim, k, chunk):
        raise ValueError(f"{what}: unsupported shape l={l}, d_inner={d_inner}, "
                         f"d_state={d_state}, headdim={headdim}, d_conv={k}, chunk={chunk}")
    return b, l, k, dc, h


def _launch_fwd(what: str, zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
                d_inner: int, d_state: int, headdim: int, chunk: int, emit: bool):
    b, l, k, dc, h = _checked(what, zxbcdt, conv_w, dt_bias, d_inner, d_state, headdim, chunk,
                              conv_b, A, D, norm_w)
    dev = zxbcdt.device
    f32 = dict(dtype=torch.float32, device=dev)
    params = [t.to(**f32).contiguous() for t in (conv_w, conv_b, dt_bias, A, D, norm_w)]
    xbc = torch.empty(b, l, dc, **f32)
    dt = torch.empty(b, l, h, **f32)
    cum = torch.empty(b, l, h, **f32)
    states = torch.empty(b, l // chunk, h, d_state, headdim, **f32)
    y = torch.empty(b, l, d_inner, **f32)
    out = torch.empty(b, l, d_inner, dtype=zxbcdt.dtype, device=dev)
    bf = zxbcdt.dtype == torch.bfloat16
    # bf16: the state pass writes a rounded copy; fp32: the states are it
    emitted = torch.empty(states.shape, dtype=zxbcdt.dtype, device=dev) if emit and bf else None
    pro = _prologue_body(zxbcdt, d_inner, params[0], params[1], xbc)
    err = _build.lib().pht_ssd_chain_fwd(
        zxbcdt.data_ptr(), *(t.data_ptr() for t in params),
        xbc.data_ptr(), dt.data_ptr(), cum.data_ptr(), states.data_ptr(), y.data_ptr(),
        out.data_ptr(), None if emitted is None else emitted.data_ptr(),
        b, l, d_inner, d_state, h, k, chunk, int(bf), int(pro == "vec"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, what)
    return out, (states if emitted is None else emitted) if emit else None, pro


def fused_mamba_chain_cuda(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> torch.Tensor:
    """Launch K7: zxbcdt [b, l, 2·d_inner + 2·d_state + h] (bf16 or fp32,
    contiguous, on a CUDA device) → [b, l, d_inner] in its dtype."""
    out, _, pro = _launch_fwd("fused_mamba_chain_cuda", zxbcdt, conv_w, conv_b, dt_bias, A, D,
                              norm_w, d_inner, d_state, headdim, chunk, emit=False)
    fused_mamba_chain_cuda.launches += 1
    fused_mamba_chain_cuda.body_launches[_body(chunk, d_state, headdim)] += 1
    fused_mamba_chain_cuda.prologue_body_launches[pro] += 1
    return out


fused_mamba_chain_cuda.launches = 0
fused_mamba_chain_cuda.body_launches = {"tc": 0, "general": 0}
fused_mamba_chain_cuda.prologue_body_launches = {"vec": 0, "general": 0}


def fused_mamba_chain_emit_cuda(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> tuple:
    """Launch K7's emit variant: (the output, as `fused_mamba_chain_cuda`;
    the state entering each chunk [b, l/chunk, h, d_state, headdim] in
    zxbcdt's dtype)."""
    out, states, pro = _launch_fwd("fused_mamba_chain_emit_cuda", zxbcdt, conv_w, conv_b,
                                   dt_bias, A, D, norm_w, d_inner, d_state, headdim, chunk,
                                   emit=True)
    fused_mamba_chain_emit_cuda.launches += 1
    fused_mamba_chain_emit_cuda.body_launches[_body(chunk, d_state, headdim)] += 1
    fused_mamba_chain_emit_cuda.prologue_body_launches[pro] += 1
    return out, states


fused_mamba_chain_emit_cuda.launches = 0
fused_mamba_chain_emit_cuda.body_launches = {"tc": 0, "general": 0}
fused_mamba_chain_emit_cuda.prologue_body_launches = {"vec": 0, "general": 0}


def fused_mamba_chain_bwd_cuda(
    zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, states, dy,
    d_inner: int, d_state: int, headdim: int, chunk: int = 128,
) -> tuple:
    """Launch K8: the VJP of K7 at the emitted entering `states` ([b,
    l/chunk, h, d_state, headdim], zxbcdt's dtype) for the output gradient
    `dy` [b, l, d_inner] → (dzx in zxbcdt's dtype, dconv_w, dconv_b,
    ddt_bias, dA, dD, dnorm_w in their parameters' dtypes)."""
    b, l, k, dc, h = _checked("fused_mamba_chain_bwd_cuda", zxbcdt, conv_w, dt_bias, d_inner,
                              d_state, headdim, chunk, conv_b, A, D, norm_w, states, dy)
    nc, q, n, p = l // chunk, chunk, d_state, headdim
    if tuple(states.shape) != (b, nc, h, n, p) or tuple(dy.shape) != (b, l, d_inner):
        raise ValueError(f"fused_mamba_chain_bwd_cuda: states {tuple(states.shape)} / dy "
                         f"{tuple(dy.shape)} do not match zxbcdt {tuple(zxbcdt.shape)}")
    dev, dtype = zxbcdt.device, zxbcdt.dtype
    states = states.to(dtype).contiguous()
    dy = dy.to(dtype).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    params = [t.to(**f32).contiguous() for t in (conv_w, conv_b, dt_bias, A, D, norm_w)]
    body = _body(chunk, d_state, headdim)
    if body == "tc":  # W stays on chip; the sum over heads of dS, packed causal tiles
        intra = [None, torch.empty(b * nc, (q // 16) * (q // 16 + 1), 16, 8, **f32), None]
    else:
        intra = [
            torch.empty(b, nc, h, q, q, **f32),  # W per head
            torch.empty(b, nc, h, q, q, **f32),  # dscores per head
            torch.empty(b, l, h, **f32),         # dcum, intra-chunk part
        ]
    scratch = [
        torch.empty(b, l, dc, **f32),           # xbc (recomputed)
        torch.empty(b, l, h, **f32),            # dt
        torch.empty(b, l, h, **f32),            # cum
        torch.empty(b, l, d_inner, **f32),      # y_ssd, then dy_ssd in place
        torch.empty(b, nc, h, n, p, **f32),     # the state gradient per chunk
        *intra,
        torch.empty(b, l, dc, **f32),           # dxBC post-SiLU, then dpre in place
        torch.empty(b * nc, k + 1, dc, **f32),  # conv tap/bias partials per chunk
        torch.empty(b * nc, d_inner, **f32),    # norm weight partials per chunk
        torch.empty(b * nc, 3, h, **f32),       # dt_bias, A, D partials per chunk
    ]
    dzx = torch.empty_like(zxbcdt)
    dwb = torch.empty(k + 1, dc, **f32)
    dpv = torch.empty(3, h, **f32)
    dnw = torch.empty(d_inner, **f32)
    pro = _prologue_body(zxbcdt, d_inner, params[0], params[1], scratch[0])
    err = _build.lib().pht_ssd_chain_bwd(
        zxbcdt.data_ptr(), *(t.data_ptr() for t in params), states.data_ptr(), dy.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch),
        dzx.data_ptr(), dwb.data_ptr(), dpv.data_ptr(), dnw.data_ptr(),
        b, l, d_inner, d_state, h, k, chunk, int(dtype == torch.bfloat16), int(pro == "vec"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "fused_mamba_chain_bwd_cuda")
    fused_mamba_chain_bwd_cuda.launches += 1
    fused_mamba_chain_bwd_cuda.body_launches[body] += 1
    fused_mamba_chain_bwd_cuda.prologue_body_launches[pro] += 1
    return (dzx, dwb[:k].to(conv_w.dtype), dwb[k].to(conv_b.dtype), dpv[0].to(dt_bias.dtype),
            dpv[1].to(A.dtype), dpv[2].to(D.dtype), dnw.to(norm_w.dtype))


fused_mamba_chain_bwd_cuda.launches = 0
fused_mamba_chain_bwd_cuda.body_launches = {"tc": 0, "general": 0}
fused_mamba_chain_bwd_cuda.prologue_body_launches = {"vec": 0, "general": 0}


def ssd_prologue_cuda(zxbcdt, conv_w, conv_b, dt_bias, A, d_inner: int, d_state: int,
                      headdim: int, chunk: int = 128, body: str | None = None) -> tuple:
    """K7's prologue alone on `body` ("vec" or "general"; by default the one
    K7 takes for these tensors): (xbc [b, l, d_inner + 2·d_state], dt, cum
    [b, l, h]), f32, as K7 leaves them in its scratch. Not on any model's
    path, and uncounted: chip_smoke and the card tests compare the two
    bodies through it. The C entry refuses a window the named body does
    not take."""
    b, l, k, dc, h = _checked("ssd_prologue_cuda", zxbcdt, conv_w, dt_bias, d_inner, d_state,
                              headdim, chunk, conv_b, A)
    dev = zxbcdt.device
    f32 = dict(dtype=torch.float32, device=dev)
    params = [t.to(**f32).contiguous() for t in (conv_w, conv_b, dt_bias, A)]
    xbc = torch.empty(b, l, dc, **f32)
    dt = torch.empty(b, l, h, **f32)
    cum = torch.empty(b, l, h, **f32)
    body = body or _prologue_body(zxbcdt, d_inner, params[0], params[1], xbc)
    err = _build.lib().pht_ssd_prologue(
        zxbcdt.data_ptr(), *(t.data_ptr() for t in params), xbc.data_ptr(), dt.data_ptr(),
        cum.data_ptr(), b, l, d_inner, d_state, h, k, chunk, int(zxbcdt.dtype == torch.bfloat16),
        int(body == "vec"), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "ssd_prologue_cuda")
    return xbc, dt, cum

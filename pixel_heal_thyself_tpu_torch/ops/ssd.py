"""Mamba2 SSD (state-space dual) scan.

Port of `pixel_heal_thyself_tpu/ops/ssd.py`: `ssd_naive` (:36, the
time-step oracle), `ssd_chunked` (:221, the chunked matmul form that the
literal Mamba2 layer runs) and `ssd_pallas` (:393, the forward-only scan
of the TPU kernel `_ssd_fwd_kernel` :324, which no model calls: only
`bench_mamba` and the tests). Semantics, with scalar-per-head decay:

    state_t = exp(dt_t·A_h)·state_{t-1} + dt_t·(B_t ⊗ x_t)
    y_t     = C_t · state_t + D_h·x_t

`ssd_chunked` and `ssd_pallas_torch` round to the input dtype at the
points where their JAX functions do (their contractions accumulate in f32,
`preferred_element_type`); in float32 every cast is the identity. The two
round at different points: `ssd_pallas` carries the state from chunk to
chunk rounded to the input dtype after every chunk. `ssd_pallas`
dispatches to the kernel K11 (`ops/ssd_cuda.py`) for CUDA tensors and to
`ssd_pallas_torch` for CPU tensors. The sequence-sharded path chains the
state across ranks: `initial_state` / `return_final_state`,
`ssd_state_summary` (:275) and `ssd_sharded` (:288), plain PyTorch as the
JAX functions are plain XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixel_heal_thyself_tpu_torch._build import dispatch, refuse_autograd
from pixel_heal_thyself_tpu_torch.ops.ssd_cuda import ssd_pallas_cuda


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[b, l, g, n] → [b, l, h, n], each group broadcast over its heads."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


def ssd_naive(x, dt, A, B, C, D=None, initial_state=None, return_final_state=False):
    """Time-step scan. x: [b, l, h, p], dt: [b, l, h], A: [h], B, C:
    [b, l, g, n] (h % g == 0). Returns [b, l, h, p] in x's dtype (and the
    final [b, h, n, p] state with `return_final_state`); `initial_state`
    [b, h, n, p] is the carried-in state (sequence chaining)."""
    b, l, h, p = x.shape
    Bh, Ch = _heads(B, h), _heads(C, h)
    dA = torch.exp(dt * A[None, None, :])
    xdt = x * dt[..., None]
    state = (x.new_zeros(b, h, B.shape[3], p) if initial_state is None
             else initial_state.to(x.dtype))
    ys = []
    for t in range(l):
        state = dA[:, t, :, None, None] * state + Bh[:, t, :, :, None] * xdt[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return (y, state) if return_final_state else y


def _mm(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation (JAX `preferred_element_type=f32`)."""
    return torch.einsum(eq, *(o.float() for o in ops))


def _ssd_stacks(x, dt, A, B, C, chunk: int) -> dict:
    """The chunked stacks and per-chunk summaries that the output pass and
    the state summary share (JAX `_ssd_stacks` :86): the sequence padded to
    a chunk multiple, B/C/x/dt in chunks, the in-chunk cumulative log-decay
    `cum` [b, nc, q, g, rep] (f32), x·dt, each chunk's decayed input
    projection `S` [b, nc, g, rep, n, p] and decay `a` [b, nc, g, rep].

    Chunk padding leaves the final state unchanged: padded tokens have
    dt = 0, so decay 1 and no state increment."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    dtype = x.dtype
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (l + pad) // q

    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)
    xc = x.reshape(b, nc, q, g, rep, p)
    dtc = dt.reshape(b, nc, q, g, rep)
    dA = (dtc * A.reshape(g, rep)).float()
    cum = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None].to(dtype)
    decay_to_end = torch.exp(cum[:, :, -1:] - cum).to(dtype)
    S = _mm("bcjgn,bcjgrp->bcgrnp", Bc, xdt * decay_to_end[..., None]).to(dtype)
    a = torch.exp(cum[:, :, -1]).to(dtype)
    dims = dict(b=b, l=l, h=h, p=p, g=g, n=n, rep=rep, q=q, nc=nc)
    return dict(Bc=Bc, Cc=Cc, xdt=xdt, cum=cum, S=S, a=a, dims=dims)


def _ssd_carry(stacks: dict, initial_state=None, with_outputs: bool = True) -> tuple:
    """The inter-chunk state recurrence over the per-chunk summaries (JAX
    `_ssd_carry` :135), from `initial_state` [b, h, n, p] or zeros.
    Returns (final state [b, g, rep, n, p], the state entering each chunk
    [b, nc, g, rep, n, p] or None)."""
    d, S, a = stacks["dims"], stacks["S"], stacks["a"]
    state = (torch.zeros_like(S[:, 0]) if initial_state is None else
             initial_state.reshape(d["b"], d["g"], d["rep"], d["n"], d["p"]).to(S.dtype))
    st_in = []
    for c in range(d["nc"]):
        if with_outputs:
            st_in.append(state)
        state = a[:, c, ..., None, None] * state + S[:, c]
    return state, (torch.stack(st_in, dim=1) if with_outputs else None)


def _ssd_outputs(stacks: dict, st_in: torch.Tensor, x, D) -> torch.Tensor:
    """The intra-chunk attention-like products with a causal decay mask and
    the entering states' readout, every chunk in one batch (JAX
    `_ssd_outputs` :161), then the D skip."""
    d = stacks["dims"]
    b, l, h, p, q, nc = d["b"], d["l"], d["h"], d["p"], d["q"], d["nc"]
    Bc, Cc, xdt, cum = stacks["Bc"], stacks["Cc"], stacks["xdt"], stacks["cum"]
    dtype = x.dtype
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    cumT = cum.permute(0, 1, 3, 4, 2)                        # [b,nc,g,rep,q]
    diff = cumT[..., :, None] - cumT[..., None, :]
    lmask = torch.exp(diff.masked_fill(~causal, float("-inf"))).to(dtype)
    scores = _mm("bcign,bcjgn->bcgij", Cc, Bc).to(dtype)
    y = _mm("bcgrij,bcjgrp->bcigrp", scores[:, :, :, None] * lmask, xdt).to(dtype)
    in_decay = torch.exp(cum).to(dtype)                      # [b,nc,q,g,rep]
    y = y + in_decay[..., None] * _mm("bcign,bcgrnp->bcigrp", Cc, st_in).to(dtype)
    y = y.reshape(b, nc * q, h, p)[:, :l]
    if D is not None:
        y = y + x[:, :l] * D[None, None, :, None].to(dtype)
    return y


def ssd_chunked(x, dt, A, B, C, D=None, chunk: int = 128, initial_state=None,
                return_final_state: bool = False):
    """Chunked matmul-form SSD; same signature and semantics as
    `ssd_naive`. Intra-chunk attention-like products with a causal decay
    mask, the inter-chunk state carried by a short loop over per-chunk
    summaries (`_ssd_stacks` / `_ssd_carry` / `_ssd_outputs`, as the JAX
    function, with every chunk in one batch)."""
    stacks = _ssd_stacks(x, dt, A, B, C, chunk)
    final, st_in = _ssd_carry(stacks, initial_state)
    y = _ssd_outputs(stacks, st_in, x, D)
    if return_final_state:
        d = stacks["dims"]
        return y, final.reshape(d["b"], d["h"], d["n"], d["p"])
    return y


def _state_summary(stacks: dict, dtype: torch.dtype) -> tuple:
    """(total decay [b, h], final state from zero [b, h, n, p]) of a token
    strip's affine recurrence `state_out = a_tot·state_in + S_fin` (JAX
    `_state_summary` :260), from its chunk stacks."""
    d = stacks["dims"]
    final, _ = _ssd_carry(stacks, None, with_outputs=False)
    # the product of the chunk decays, summed in log space
    a_tot = torch.exp(stacks["cum"][:, :, -1].sum(dim=1)).reshape(d["b"], d["h"]).to(dtype)
    return a_tot, final.reshape(d["b"], d["h"], d["n"], d["p"])


def ssd_state_summary(x, dt, A, B, C, chunk: int = 128) -> tuple:
    """A strip's state summary (a_tot [b, h], S_fin [b, h, n, p]): the
    scan from any entering state s ends at a_tot·s + S_fin. Skips the
    output products."""
    return _state_summary(_ssd_stacks(x, dt, A, B, C, chunk), x.dtype)


def ssd_sharded(x, dt, A, B, C, D=None, *, axis, chunk: int = 128):
    """Sequence-sharded SSD over the ranks of `axis` (a
    `parallel.mesh.RowAxis`), each holding a contiguous strip of the
    global sequence; a collective, so every rank calls it. Each rank's
    state summary is all-gathered, the ranks before this one are folded
    left into its entering state (a_e·s + S_e, e = 0..index-1), and the
    local chunk carry starts from it. Equal to the unsharded scan up to
    floating-point reordering; the chunk stacks serve both the summary and
    the outputs."""
    stacks = _ssd_stacks(x, dt, A, B, C, chunk)
    a_tot, S_fin = _state_summary(stacks, x.dtype)
    a_all, S_all = axis.all_gather(a_tot), axis.all_gather(S_fin)
    init = torch.zeros_like(S_fin)
    for e in range(axis.index):
        init = a_all[e][..., None, None] * init + S_all[e]
    _, st_in = _ssd_carry(stacks, init)
    return _ssd_outputs(stacks, st_in, x, D)


def pallas_stacks(x, dt, A, B, C, chunk: int) -> tuple:
    """The chunked inputs of the TPU kernel (`ssd_pallas` :418-423): cum
    [b, nc, h, q] (the in-chunk cumsum of dt·A, the product formed in the
    promoted dtype of dt and A, then cast to f32), xdt [b, nc, h, q, p]
    (x·dt in x's dtype), Bc, Cc [b, nc, q, n]."""
    b, l, h, p = x.shape
    n, q = B.shape[3], chunk
    nc = l // q
    cum = torch.cumsum((dt * A[None, None, :]).float().reshape(b, nc, q, h), dim=2)
    xdt = (x * dt[..., None].to(x.dtype)).reshape(b, nc, q, h, p).transpose(2, 3)
    return cum.transpose(2, 3), xdt, B.reshape(b, nc, q, n), C.reshape(b, nc, q, n)


def pallas_states(cum, xdt, Bc, carry_dtype: torch.dtype) -> torch.Tensor:
    """The state entering each chunk [b, nc, h, n, p]: st ← exp(cum_last)·st
    + Bᵀ·(xdt·decay_to_end), with the f32 sum rounded to `carry_dtype`
    after every chunk (the TPU kernel's state scratch, :389, :452: the
    input dtype)."""
    dtype = xdt.dtype
    decay_to_end = torch.exp(cum[..., -1:] - cum).to(dtype)
    S = _mm("bcjn,bchjp->bchnp", Bc.to(dtype), xdt * decay_to_end[..., None])
    a = torch.exp(cum[..., -1])                               # [b,nc,h] f32
    st = torch.zeros_like(S[:, 0], dtype=carry_dtype)
    st_in = []
    for c in range(S.shape[1]):
        st_in.append(st)
        st = (a[:, c, :, None, None] * st.float() + S[:, c]).to(carry_dtype)
    return torch.stack(st_in, dim=1)


def pallas_outputs(cum, xdt, Bc, Cc, st_in, x, D=None) -> torch.Tensor:
    """y [b, l, h, p] of each chunk from its entering state (the TPU kernel's
    body, :350-377), then the D skip in x's dtype (:461)."""
    dtype = x.dtype
    b, l, h, p = x.shape
    q = cum.shape[-1]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]               # [b,nc,h,qi,qj]
    lmask = torch.exp(diff.masked_fill(~causal, float("-inf"))).to(dtype)
    scores = _mm("bcin,bcjn->bcij", Cc, Bc).to(dtype)           # shared across heads
    y = _mm("bchij,bchjp->bchip", scores[:, :, None] * lmask, xdt)
    y = y + torch.exp(cum)[..., None] * _mm("bcin,bchnp->bchip", Cc.to(dtype), st_in)
    y = y.to(dtype).transpose(2, 3).reshape(b, l, h, p)
    if D is not None:
        y = y + x * D[None, None, :, None].to(dtype)
    return y


def ssd_pallas_torch(x, dt, A, B, C, D=None, chunk: int = 128, group: int = 8):
    """Plain version of the TPU `ssd_pallas` kernel path (ngroups 1, l a
    positive multiple of `chunk`): the chunked scan with the TPU kernel's
    rounding points, the carried state in x's dtype. `group` (chunks per
    TPU program) changes nothing numerically."""
    del group
    b, l, h, p = x.shape
    if B.shape[2] != 1 or l == 0 or l % chunk:
        raise ValueError(f"ssd_pallas_torch: ngroups {B.shape[2]}, l {l}, chunk {chunk}")
    cum, xdt, Bc, Cc = pallas_stacks(x, dt, A, B, C, chunk)
    st_in = pallas_states(cum, xdt, Bc, x.dtype)
    return pallas_outputs(cum, xdt, Bc, Cc, st_in, x, D)


def ssd_pallas(x, dt, A, B, C, D=None, chunk: int = 128, group: int = 8):
    """Forward-only chunked SSD, the JAX `ssd_pallas` signature: K11 for
    CUDA tensors (launch or raise), `ssd_pallas_torch` for CPU tensors. As
    the JAX function, ngroups ≠ 1, l = 0 and l not a multiple of `chunk`
    go to `ssd_chunked`. Refuses inputs that require grad in grad mode."""
    refuse_autograd("ssd_pallas", x, dt, A, B, C, D)
    l, g = x.shape[1], B.shape[2]
    if g != 1 or l % chunk or l == 0:
        return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
    return dispatch("ssd_pallas", x, ssd_pallas_cuda, ssd_pallas_torch, x, dt, A, B, C, D,
                    chunk=chunk)

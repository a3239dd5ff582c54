"""Wrappers of the block-halo attention CUDA kernels: forward K1
(`csrc/attention_fwd.cu`) and backward K4 (`csrc/attention_bwd.cu`).

K1 replaces the TPU kernel `pixel_heal_thyself_tpu/ops/attention_pallas.py:217`
(`_fwd_kernel`), K4 the TPU kernel `:383` (`_bwd_kernel`) and the
attention stage of `ops/block_mega.py:662`. Semantics and rounding order
are those of the plain `ops.attention.block_halo_attention_torch` and
`block_halo_attention_bwd_torch`, which the CPU tests hold against the JAX
package and `chip_smoke.py` holds these kernels against on the card.

Each has three bodies, picked by `attention_body`: the tensor-core body
("tc": every window product on mma.sync bf16, `csrc/attention_tc.cuh`)
for bf16 at head_ch a multiple of 16 up to 64, block 4 or 8 and 16-byte
aligned tensors (the prod shape); the float32 body ("f32": true f32 FMAs,
register-tiled, `csrc/attention_f32.cuh`; `attention_f32_plan`) for
fp32 at head_ch a multiple of 4 up to 64, block 4 or 8 and 16-byte
aligned tensors (the prod fp32 shape); and the general scalar-FMA body for
every other shape (a 3×TF32 tensor-core fp32 body ran no faster and moved
the fp32 training step past its bound: PERF.md). All run every 1 ≤ halo ≤
block: where the window's keys are too many for registers (tc, f32) or
for one shared-memory stage (general), they walk the keys in more passes.
A wrapper launches the body the gate picks or raises; nothing falls back.
`block_halo_attention_cuda.launches` / `block_halo_attention_bwd_cuda.
launches` count the launches, `.body_launches` each body's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch import _build

# windows per first-level group of K4's bias-gradient reduction
_BIAS_GROUP = 16
MAX_SMEM = 232_448  # the opt-in shared memory of one CTA on the H100
TC_MAX_HEAD = 64  # the largest head_ch of the tensor-core body
TC_BLOCKS = (4, 8)  # its block sizes: 16 or 64 queries, one warp per 16
TC_SKEW = 8  # bf16 elements appended to each of its shared rows
TC_SUB = 4  # key tiles of dl / round(P) that K4 stages at once
# key-tile counts whose logits (K1) or probabilities (K4) stay in registers
RESIDENT_TILES = (3, 4, 7, 9, 13, 16)
F32_MAX_HEAD = 64  # the largest head_ch of the float32 body
F32_LD = 68  # f32 words in each of its staged rows (64 + 4)
F32_LANES = 8  # the lanes of a query row, which split its keys (and 8 channels a pass)
F32_SLOTS = 13  # key slots a lane holds: K1 chunks of ≤ 104 keys, K4 of ≤ 208
# each body's C entry points (K1, K4)
_ENTRIES = {"tc": ("pht_attention_fwd_tc", "pht_attention_bwd_tc"),
            "f32": ("pht_attention_fwd_f32", "pht_attention_bwd_f32"),
            "general": ("pht_attention_fwd", "pht_attention_bwd")}


@dataclass(frozen=True)
class AttentionPlan:
    """The tensor-core body at one shape: key tiles of 16 (padded keys
    never enter the softmax), whether a warp keeps its rows' logits /
    probabilities in registers (else K1 takes two passes over the key
    tiles and K4 three), threads, and each kernel's shared memory."""

    key_tiles: int
    resident: bool
    threads: int
    smem_fwd: int
    smem_bwd: int


def attention_tc_plan(block_size: int, halo_size: int, head_ch: int) -> AttentionPlan:
    """The plan of `csrc/attention_tc.cuh` (`key_tiles`, `resident_tiles`,
    `fwd_smem`, `bwd_smem`): bf16 rows of head_ch + TC_SKEW values for q,
    k_eff and v (K4: and do), K4's dl and round(P) sub-chunks of TC_SUB key
    tiles."""
    window = block_size + 2 * halo_size
    nq, nt = block_size * block_size, -(-window * window // 16)
    row = 2 * (head_ch + TC_SKEW)
    return AttentionPlan(
        key_tiles=nt, resident=nt in RESIDENT_TILES, threads=2 * nq,
        smem_fwd=row * (nq + 2 * 16 * nt),
        smem_bwd=row * (2 * nq + 2 * 16 * nt) + 2 * 2 * nq * (TC_SUB * 16 + TC_SKEW),
    )


@dataclass(frozen=True)
class F32Plan:
    """The float32 body at one shape. A lane holds 4 query rows and
    `slots_fwd` (K1) or `slots_bwd` (K4) key slots of a chunk: K1's 8 lanes
    of a row hold a chunk of 8 × slots keys, K4's two warps of a row group
    one of 16 × slots; a window takes `chunks_fwd` / `chunks_bwd` equal
    chunks (K1 holds the logits of up to two in registers, more take it
    three passes; K4 takes one pass for one chunk, three for more).
    Threads, each kernel's shared memory, and the f32 values a thread holds
    in registers at its peak (K1: the logits of up to two chunks and its 4 ×
    8 outputs; K4: its P, dattn and dq channels)."""

    chunks_fwd: int
    slots_fwd: int
    chunks_bwd: int
    slots_bwd: int
    threads_fwd: int
    threads_bwd: int
    smem_fwd: int
    smem_bwd: int
    values_fwd: int
    values_bwd: int


def _f32_chunks(nk: int, halves: int) -> tuple[int, int]:
    """(chunks, slots a lane) of `csrc/attention_f32.cuh` `chunks`, `slots`."""
    cap = F32_LANES * F32_SLOTS * halves
    chunks = -(-nk // cap)
    per_chunk = -(-nk // chunks)
    return chunks, -(-per_chunk // (F32_LANES * halves))


def attention_f32_plan(block_size: int, halo_size: int, head_ch: int) -> F32Plan:
    """The plan of `csrc/attention_f32.cuh` (`chunks`, `slots`, `fwd_smem`,
    `bwd_smem`): f32 rows of F32_LD words for q, k_eff and v (K4: and do,
    dq's exchange), K4's [row][slot] dl and its row statistics' exchange; P
    takes v's rows. `head_ch` must be a multiple of 4 up to 64: the rows
    are F32_LD wide whatever it is."""
    if head_ch % 4 or not 4 <= head_ch <= F32_MAX_HEAD:
        raise ValueError(f"head_ch={head_ch}: the f32 body takes a multiple of 4 up to 64")
    window = block_size + 2 * halo_size
    nq, nk = block_size * block_size, window * window
    chunks_fwd, slots_fwd = _f32_chunks(nk, 1)
    chunks_bwd, slots_bwd = _f32_chunks(nk, 2)
    ck_fwd, ck_bwd = F32_LANES * slots_fwd, 2 * F32_LANES * slots_bwd
    passes = F32_MAX_HEAD // F32_LANES
    return F32Plan(
        chunks_fwd=chunks_fwd, slots_fwd=slots_fwd, chunks_bwd=chunks_bwd, slots_bwd=slots_bwd,
        threads_fwd=2 * nq, threads_bwd=4 * nq,
        smem_fwd=4 * F32_LD * (nq + 2 * ck_fwd),
        smem_bwd=4 * (F32_LD * (3 * nq + 2 * ck_bwd) + nq * ck_bwd + 6 * nq),
        values_fwd=4 * min(chunks_fwd, 2) * slots_fwd + 4 * F32_LANES,
        values_bwd=8 * slots_bwd + 4 * passes,
    )


def attention_body(dtype: torch.dtype, c: int, num_heads: int, block_size: int,
                   halo_size: int, *tensors) -> str:
    """The body K1 and K4 take: "tc" for bf16 with head_ch a multiple of 16
    up to 64 (C then a multiple of 8), block 4 or 8 and every tensor
    16-byte aligned (`_body`'s rule in `ops.block_cuda`), where both
    kernels' shared memory fits one CTA; "f32" for float32 with head_ch a
    multiple of 4 up to 64, block 4 or 8, 1 ≤ halo ≤ block and every tensor
    16-byte aligned, where both kernels' shared memory fits one CTA;
    "general" otherwise."""
    hd = c // num_heads
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in tensors)
    if dtype == torch.bfloat16:
        ok = hd % 16 == 0 and hd <= TC_MAX_HEAD and c % 8 == 0 and block_size in TC_BLOCKS
        if ok and aligned:
            plan = attention_tc_plan(block_size, halo_size, hd)
            if max(plan.smem_fwd, plan.smem_bwd) <= MAX_SMEM:
                return "tc"
    elif dtype == torch.float32:
        ok = (hd % 4 == 0 and 4 <= hd <= F32_MAX_HEAD and c % 4 == 0 and block_size in TC_BLOCKS
              and 1 <= halo_size <= block_size)
        if ok and aligned:
            plan = attention_f32_plan(block_size, halo_size, hd)
            if max(plan.smem_fwd, plan.smem_bwd) <= MAX_SMEM:
                return "f32"
    return "general"


def _check_inputs(q, tensors, rel_h, rel_w, block_size, halo_size, num_heads, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {q.dtype} (bf16 or fp32)")
    b, h, w, c = q.shape
    for t in [q, *tensors]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: q, k, v (do, residual) must share shape, dtype, device")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous NHWC tensors")
    if h % block_size or w % block_size:
        raise ValueError(f"H×W = {h}×{w} not divisible by block_size={block_size}")
    if c % num_heads or (c // num_heads) % 2:
        raise ValueError(f"C={c} must split into {num_heads} heads of even width")
    if not 1 <= halo_size <= block_size:
        raise ValueError(f"halo_size={halo_size} must be in [1, block_size]")
    window = block_size + 2 * halo_size
    hd = c // num_heads
    for name, r in (("rel_h", rel_h), ("rel_w", rel_w)):
        if r.shape != (window, hd // 2):
            raise ValueError(f"{name} shape {tuple(r.shape)} != {(window, hd // 2)}")


def _f32(r: torch.Tensor, device) -> torch.Tensor:
    return r.to(device=device, dtype=torch.float32).contiguous()


def _scale(head_ch: int) -> ctypes.c_float:
    return ctypes.c_float(float(np.float32(head_ch) ** np.float32(-0.5)))


def _fwd(body: str, q, k, v, rel_h, rel_w, residual, block_size, halo_size, num_heads):
    """Launch K1's `body` on `torch.cuda.current_stream()`: (out, error)."""
    b, h, w, c = q.shape
    rh, rw = _f32(rel_h, q.device), _f32(rel_w, q.device)
    out = torch.empty_like(q)
    entry = getattr(_build.lib(), _ENTRIES[body][0])
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        b, h, w, c, block_size, halo_size, num_heads,
        int(q.dtype == torch.bfloat16), _scale(c // num_heads),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, err


def block_halo_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    *,
    block_size: int,
    halo_size: int,
    num_heads: int,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K1 on `torch.cuda.current_stream()`: [B,H,W,C] q/k/v (bf16
    or fp32, contiguous) → [B,H,W,C], plus `residual` when given."""
    _build.refuse_autograd("block_halo_attention_cuda", q, k, v, rel_h, rel_w, residual)
    _check_inputs(q, [k, v] + ([residual] if residual is not None else []), rel_h, rel_w,
                  block_size, halo_size, num_heads, "block_halo_attention_cuda")
    body = attention_body(q.dtype, q.shape[-1], num_heads, block_size, halo_size,
                          q, k, v, residual, _f32(rel_h, q.device), _f32(rel_w, q.device))
    out, err = _fwd(body, q, k, v, rel_h, rel_w, residual, block_size, halo_size, num_heads)
    block_halo_attention_cuda.launches += 1
    block_halo_attention_cuda.body_launches[body] += 1
    _build.check(err, f"block_halo_attention_cuda ({body} body)")
    return out


# all launches, and by body: "tc" (attention_fwd_tc_kernel), "f32"
# (attention_fwd_f32_kernel) or "general"
block_halo_attention_cuda.launches = 0
block_halo_attention_cuda.body_launches = {"tc": 0, "f32": 0, "general": 0}


def _bwd(body: str, q, k, v, rel_h, rel_w, do, block_size, halo_size, num_heads):
    """Launch K4's `body`: ((dq, dk, dv, drel_h, drel_w), error)."""
    b, h, w, c = q.shape
    hd = c // num_heads
    window = block_size + 2 * halo_size
    nk = window * window
    nwin = b * (h // block_size) * (w // block_size)
    ngroups = -(-nwin // _BIAS_GROUP)
    dev = q.device
    rh, rw = _f32(rel_h, dev), _f32(rel_w, dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dk_part = torch.empty(nwin, nk, c, dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    bias_part = torch.empty(ngroups, nk, hd, dtype=torch.float32, device=dev)
    dbias = torch.empty(window, window, hd, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.lib()
    entry = getattr(lib, _ENTRIES[body][1])
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), bias_part.data_ptr(), _BIAS_GROUP,
        b, h, w, c, block_size, halo_size, num_heads,
        int(q.dtype == torch.bfloat16), _scale(hd), stream,
    )
    if err == 0:
        err = lib.pht_sum_splits(bias_part.data_ptr(), dbias.data_ptr(), nk * hd, ngroups, stream)
    # rel-pos bias gradients: the same unpack as the TPU wrapper
    # (attention_pallas.py:633-637)
    half = hd // 2
    return (dq, dk, dv, dbias[..., :half].sum(1), dbias[..., half:].sum(0)), err


def block_halo_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    do: torch.Tensor,
    *,
    block_size: int,
    halo_size: int,
    num_heads: int,
) -> tuple[torch.Tensor, ...]:
    """Launch K4: (dq, dk, dv) in q's dtype and f32 (drel_h, drel_w).

    Scratch: f32 per-window dk/dv partials [windows, window², C] (2 × 411
    MB at the prod shape 8 × 128² × 256) and the bias-gradient groups."""
    _build.refuse_autograd("block_halo_attention_bwd_cuda", q, k, v, rel_h, rel_w, do)
    _check_inputs(q, [k, v, do], rel_h, rel_w, block_size, halo_size, num_heads,
                  "block_halo_attention_bwd_cuda")
    body = attention_body(q.dtype, q.shape[-1], num_heads, block_size, halo_size,
                          q, k, v, do, _f32(rel_h, q.device), _f32(rel_w, q.device))
    grads, err = _bwd(body, q, k, v, rel_h, rel_w, do, block_size, halo_size, num_heads)
    block_halo_attention_bwd_cuda.launches += 1
    block_halo_attention_bwd_cuda.body_launches[body] += 1
    _build.check(err, f"block_halo_attention_bwd_cuda ({body} body)")
    return grads


block_halo_attention_bwd_cuda.launches = 0
block_halo_attention_bwd_cuda.body_launches = {"tc": 0, "f32": 0, "general": 0}


def attention_body_launch(body: str, q, k, v, rel_h, rel_w, do=None, *, block_size: int,
                          halo_size: int, num_heads: int, residual=None):
    """K1 (`do` None) or K4 through the named body, whatever the gate says,
    uncounted: chip_smoke's and the card tests' comparison of the two
    bodies on one shape. Raises where the body refuses the shape."""
    _build.refuse_autograd("attention_body_launch", q, k, v, rel_h, rel_w, do, residual)
    others = [k, v] + [t for t in (do, residual) if t is not None]
    _check_inputs(q, others, rel_h, rel_w, block_size, halo_size, num_heads,
                  "attention_body_launch")
    if body not in _ENTRIES:
        raise ValueError(f"unknown body {body!r}")
    cfg = (block_size, halo_size, num_heads)
    if do is None:
        result, err = _fwd(body, q, k, v, rel_h, rel_w, residual, *cfg)
    else:
        result, err = _bwd(body, q, k, v, rel_h, rel_w, do, *cfg)
    _build.check(err, f"attention_body_launch ({body} body)")
    return result

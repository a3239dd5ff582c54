"""The serving path's kernel boundaries as `torch.library` custom ops.

On the TPU a Pallas kernel lowers to a Mosaic custom call inside the
StableHLO program, so an exported JAX artifact keeps its kernels. Here
every kernel launches through `ctypes` (`_build.py`), which `torch.export`
cannot see: it traces with fake tensors that have no storage. Each TPU
kernel boundary on the serving path is therefore one op in the `pht`
namespace, and an exported graph holds one node per call:

- `pht::block_halo_attention`: TPU #1 (`ops/attention_pallas.py:217`),
  K1 on the card. The literal AFGSA route, FiLM and `fold_qkv` reach it.
- `pht::transformer_block_fwd`: TPU #3 (`ops/block_mega.py:413`), the
  whole block forward, K2 ×4 → K1 → K3 ×2 on the card; weights in the
  `ops.block_cuda.kernel_layout` layout.
- `pht::fused_mamba_chain`: TPU #5 (`ops/ssd_mega.py:256`), K7 on the
  card.

Each op's implementation is `_build.dispatch`: the kernel's wrapper for
a CUDA tensor (it picks its body, checks alignment, counts its launch and
launches, or raises), the plain version for a CPU tensor. All of that
happens at run time; each op's fake implementation gives only the output's
shape and dtype. The models reach these functions through the
dispatchers (`ops.attention.block_halo_attention`, `ops.block_cuda.
transformer_block_fwd`, `ops.ssd_mega.fused_mamba_chain`). The ops have
no autograd formula: `_build.dispatch` refuses grad-mode inputs that
require grad, and gradients go through `BlockHaloAttentionFn`,
`TransformerBlockFn` and `MambaChainFn` as before.

Each function here calls its op under `torch.export` and the op's
implementation directly otherwise, so an artifact and the live model run
the same wrapper. Called in eager mode, the op's own dispatch added about
50 µs a call to the host-bound AFGSA frame on an H100 (40 calls, 1.7% of
the frame; PERF.md), which the direct call saves. `<function>.op` is the
op itself.

Importing this module registers the ops; `serving.load_exported` does so
before `torch.export.load`. The kernel library itself still builds or
loads at the first launch. The implementations import the modules that
hold the wrappers and plain versions when first called, since those
modules import this one.
"""

import functools
from typing import Optional

import torch
from torch import Tensor

from pixel_heal_thyself_tpu_torch import _build


def _op(name: str):
    """Register the decorated function as the op `pht::<name>` and return
    a function that calls the op under `torch.export` and the decorated
    function itself otherwise."""

    def register(fn):
        op = torch.library.custom_op(f"pht::{name}", fn, mutates_args=())

        @functools.wraps(fn)
        def call(*args):
            return (op if torch.compiler.is_exporting() else fn)(*args)

        call.op = op
        return call

    return register


@_op("block_halo_attention")
def block_halo_attention(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor, rel_w: Tensor,
                         residual: Optional[Tensor], block_size: int, halo_size: int,
                         num_heads: int) -> Tensor:
    """K1 for CUDA tensors, `block_halo_attention_torch` for CPU ones."""
    from pixel_heal_thyself_tpu_torch.ops.attention import block_halo_attention_torch
    from pixel_heal_thyself_tpu_torch.ops.attention_cuda import block_halo_attention_cuda

    return _build.dispatch(
        "block_halo_attention", q, block_halo_attention_cuda, block_halo_attention_torch,
        q, k, v, rel_h, rel_w, block_size=block_size, halo_size=halo_size,
        num_heads=num_heads, residual=residual,
    )


@block_halo_attention.op.register_fake
def _(q, k, v, rel_h, rel_w, residual, block_size, halo_size, num_heads):
    return torch.empty_like(q)


@_op("transformer_block_fwd")
def transformer_block_fwd(x: Tensor, a: Tensor, wcat: Tensor, bcat: Tensor, wq: Tensor,
                          wk: Tensor, wv: Tensor, rel_h: Tensor, rel_w: Tensor, w1: Tensor,
                          b1: Tensor, w2: Tensor, b2: Tensor, block_size: int, halo_size: int,
                          num_heads: int, padding_mode: str) -> Tensor:
    """The block chain K2 → K1 → K3 for CUDA tensors,
    `transformer_block_torch` for CPU ones."""
    from pixel_heal_thyself_tpu_torch.ops.block_cuda import (
        transformer_block_cuda,
        transformer_block_torch,
    )

    return _build.dispatch(
        "transformer_block_fwd", x, transformer_block_cuda, transformer_block_torch,
        x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2, block_size=block_size,
        halo_size=halo_size, num_heads=num_heads, padding_mode=padding_mode,
    )


@transformer_block_fwd.op.register_fake
def _(x, a, wcat, bcat, wq, wk, wv, rel_h, rel_w, w1, b1, w2, b2, block_size, halo_size,
      num_heads, padding_mode):
    return torch.empty_like(x)


@_op("fused_mamba_chain")
def fused_mamba_chain(zxbcdt: Tensor, conv_w: Tensor, conv_b: Tensor, dt_bias: Tensor,
                      A: Tensor, D: Tensor, norm_w: Tensor, d_inner: int, d_state: int,
                      headdim: int, chunk: int) -> Tensor:
    """K7 for a CUDA `zxbcdt`, `fused_mamba_chain_torch` for a CPU one."""
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega import fused_mamba_chain_torch
    from pixel_heal_thyself_tpu_torch.ops.ssd_mega_cuda import fused_mamba_chain_cuda

    return _build.dispatch(
        "fused_mamba_chain", zxbcdt, fused_mamba_chain_cuda, fused_mamba_chain_torch,
        zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, d_inner=d_inner, d_state=d_state,
        headdim=headdim, chunk=chunk,
    )


@fused_mamba_chain.op.register_fake
def _(zxbcdt, conv_w, conv_b, dt_bias, A, D, norm_w, d_inner, d_state, headdim, chunk):
    return zxbcdt.new_empty((*zxbcdt.shape[:-1], d_inner))


def graph_ops(graph) -> dict[str, int]:
    """Nodes of each `pht::` op in an exported graph, by op name."""
    counts: dict[str, int] = {}
    for node in graph.nodes:
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith("pht."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts

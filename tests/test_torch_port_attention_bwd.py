"""PyTorch port: the block-halo attention backward against the JAX package.

- `block_halo_attention_bwd_torch` (the plain version of the CUDA kernel
  K4) against `jax.vjp` of `block_halo_attention_xla` in float32 at
  HIGHEST matmul precision, at halo 1/2/3, heads 2/4, frames 8×8 and
  16×24 (most keys are edge keys there: zero vectors plus the rel bias,
  which get no dk/dv but do count toward the bias gradient). The XLA path
  scales q before the product and the port scales the logits after it,
  so only float32 rounding differs: 1e-5 relative to each gradient's
  largest magnitude.
- `BlockHaloAttentionFn` (whose backward on a CPU tensor is that plain
  version) against autograd through the plain forward, float32, 1e-5.
- The dispatchers refuse inputs that require grad in grad mode, on the
  CPU as on the card, where a kernel output would have no `grad_fn`.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.ops.attention import block_halo_attention_xla  # noqa: E402
from pixel_heal_thyself_tpu.ops.curves import CurveOrder, make_curve_indices  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.attention import (  # noqa: E402
    BlockHaloAttentionFn,
    block_halo_attention,
    block_halo_attention_bwd,
    block_halo_attention_bwd_torch,
    block_halo_attention_torch,
)

BS = 8


def _inputs(seed, b, h, w, c, heads, halo):
    rng = np.random.default_rng(seed)
    window = BS + 2 * halo
    q, k, v, do = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(4))
    rel_h = rng.standard_normal((window, c // heads // 2)).astype(np.float32)
    rel_w = rng.standard_normal((window, c // heads // 2)).astype(np.float32)
    return q, k, v, rel_h, rel_w, do


@pytest.mark.parametrize("halo", [1, 2, 3])
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hw", [(8, 8), (16, 24)])
def test_attention_bwd_matches_jax_grad(halo, heads, hw):
    h, w = hw
    q, k, v, rel_h, rel_w, do = _inputs(halo * 10 + heads, 2, h, w, 16, heads, halo)
    order = jnp.asarray(make_curve_indices(BS, CurveOrder.RASTER))

    def f(*args):
        return block_halo_attention_xla(*args, order, order, block_size=BS,
                                        halo_size=halo, num_heads=heads)

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, rel_h, rel_w)))
        want = vjp(jnp.asarray(do))
    got = block_halo_attention_bwd_torch(
        *map(torch.from_numpy, (q, k, v, rel_h, rel_w, do)),
        block_size=BS, halo_size=halo, num_heads=heads,
    )
    for name, g, ref in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, want):
        ref = np.asarray(ref)
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("residual", [False, True])
def test_attention_fn_matches_autograd(residual):
    b, h, w, c, heads, halo = 2, 16, 24, 16, 2, 3
    arrays = _inputs(7, b, h, w, c, heads, halo)
    q, k, v, rel_h, rel_w = (torch.from_numpy(a).requires_grad_() for a in arrays[:5])
    do = torch.from_numpy(arrays[5])
    res = torch.from_numpy(arrays[0] * 0.5).requires_grad_() if residual else None
    leaves = [q, k, v, rel_h, rel_w] + ([res] if residual else [])

    out = BlockHaloAttentionFn.apply(q, k, v, rel_h, rel_w, res, BS, halo, heads)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    ref_out = block_halo_attention_torch(q, k, v, rel_h, rel_w, block_size=BS,
                                         halo_size=halo, num_heads=heads, residual=res)
    want = torch.autograd.grad(ref_out, leaves, do)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * r.abs().max().item())


def test_dispatchers_refuse_autograd():
    b, h, w, c, heads, halo = 1, 8, 8, 16, 2, 1
    q, k, v, rel_h, rel_w, do = map(torch.from_numpy, _inputs(9, b, h, w, c, heads, halo))
    kw = dict(block_size=BS, halo_size=halo, num_heads=heads)
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="not differentiable"):
        block_halo_attention(qg, k, v, rel_h, rel_w, **kw)
    with pytest.raises(RuntimeError, match="not differentiable"):
        block_halo_attention_bwd(qg, k, v, rel_h, rel_w, do, **kw)
    with pytest.raises(RuntimeError, match="not differentiable"):  # a keyword tensor
        block_halo_attention(q, k, v, rel_h, rel_w, residual=qg, **kw)
    with torch.no_grad():  # no graph to cut: allowed
        out = block_halo_attention(qg, k, v, rel_h, rel_w, **kw)
    torch.testing.assert_close(out, block_halo_attention_torch(q, k, v, rel_h, rel_w, **kw))

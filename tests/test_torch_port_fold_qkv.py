"""PyTorch port: the `fold_qkv` attention variant against the JAX package.

`QKVBlockHaloAttentionFn` on the CPU (its dispatchers take the plain
versions of K1 and K4) against `qkv_block_halo_attention_pallas`, the TPU
op with the q/k/v projections folded in, run in interpret mode as
tests/test_attention_pallas.py:89-125 runs it: 16² maps of 128 channels,
2 heads, block 8, halo 3, float32, inputs and the output gradient from
seeded numpy. Tolerances relative to each reference's largest magnitude:
the output 1e-5 (f32 sums in another order), the seven gradients 1e-4
(the attention backward's window sums and the projections' products over
every pixel, in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pixel_heal_thyself_tpu.ops.attention_pallas import (  # noqa: E402
    qkv_block_halo_attention_pallas,
)
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import afgsa_kwargs_from_config  # noqa: E402
from pixel_heal_thyself_tpu_torch.models import afgsa  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import attention  # noqa: E402

B, P, C, HEADS = 1, 16, 128, 2
NAMES = ("dn_aux", "dnoisy", "dwq", "dwk", "dwv", "drel_h", "drel_w")


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    hd = C // HEADS
    return (
        rng.standard_normal((B, P, P, C)).astype(np.float32),
        rng.standard_normal((B, P, P, C)).astype(np.float32),
        *(rng.standard_normal((C, C)).astype(np.float32) * 0.05 for _ in range(3)),
        *(rng.standard_normal((14, hd // 2)).astype(np.float32) for _ in range(2)),
    )


def test_qkv_fn_matches_tpu_op_interpret():
    args = _inputs()
    do = np.random.default_rng(12).standard_normal((B, P, P, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda *a: qkv_block_halo_attention_pallas(*a, 8, 3, HEADS),
                            *map(jnp.asarray, args))
        want_grads = vjp(jnp.asarray(do))

    ta = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = attention.QKVBlockHaloAttentionFn.apply(*ta, None, 8, 3, HEADS)
    got.backward(torch.from_numpy(do))
    _close(got.detach(), want, 1e-5)
    for name, t, g in zip(NAMES, ta, want_grads, strict=True):
        _close(t.grad, g, 1e-4, name)


@pytest.mark.parametrize("residual", [False, True])
def test_qkv_fn_matches_its_plain_version(residual):
    """The Function (plain K1/K4 on the CPU) against autograd through the
    plain projections and attention; the residual's gradient is the
    output's."""
    args = [torch.from_numpy(a) for a in _inputs(seed=13)]
    res = torch.from_numpy(np.random.default_rng(14).standard_normal((B, P, P, C))
                           .astype(np.float32)) if residual else None
    do = torch.from_numpy(np.random.default_rng(15).standard_normal((B, P, P, C))
                          .astype(np.float32))
    outs, grads = [], []
    for fn in ("Function", "plain"):
        ta = [a.clone().requires_grad_(True) for a in args]
        r = None if res is None else res.clone().requires_grad_(True)
        if fn == "Function":
            out = attention.QKVBlockHaloAttentionFn.apply(*ta, r, 8, 3, HEADS)
        else:
            out = attention.qkv_block_halo_attention_torch(*ta, block_size=8, halo_size=3,
                                                           num_heads=HEADS, residual=r)
        out.backward(do)
        outs.append(out.detach())
        grads.append([t.grad for t in ta] + ([] if r is None else [r.grad]))
    _close(outs[0], outs[1], 1e-6)
    for name, g, w in zip(NAMES + ("dres",), *grads):
        _close(g, w, 1e-4, name)


def _small(**kw):
    return dict(base_ch=C, enc_ch=16, num_sa=2, num_heads=HEADS, num_gcp=0, **kw)


def test_afgsanet_fold_qkv_takes_the_folded_literal_route(monkeypatch):
    """With the kernels on, fold_qkv and 128 channels, the literal route
    folds the projections (`QKVBlockHaloAttentionFn`) and gives the unfolded
    model's output and gradients (float32: 1e-5 and 1e-4)."""
    calls = []
    apply = attention.QKVBlockHaloAttentionFn.apply
    monkeypatch.setattr(attention.QKVBlockHaloAttentionFn, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    kw = _small(use_kernels=True, use_block_kernel=False)
    folded = afgsa.AFGSANet(**kw, fold_qkv=True, generator=torch.Generator().manual_seed(0))
    plain = afgsa.AFGSANet(**kw)
    plain.load_state_dict(folded.state_dict())
    assert all(b.attention.folded for b in folded.blocks)
    assert not any(b.attention.folded for b in plain.blocks)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.uniform(0, 2, (1, 16, 16, 3)).astype(np.float32))
    aux = torch.from_numpy(rng.standard_normal((1, 16, 16, 7)).astype(np.float32))
    outs, grads = [], []
    for model in (folded, plain):
        out = model(x, aux)
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert len(calls) == 2
    _close(outs[0], outs[1], 1e-5)
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[1].items():
        _close(grads[0][name], g, 1e-4, name)


def test_fold_qkv_gate():
    """The JAX gate: the kernels on, fold_qkv, and a multiple of 128
    channels (models/afgsa.py:350)."""
    def folded(ch, **kw):
        return afgsa.AFGSA(ch, ch, ch, num_heads=2, **kw).folded
    assert folded(128, use_kernels=True, fold_qkv=True)
    assert not folded(64, use_kernels=True, fold_qkv=True)
    assert not folded(128, use_kernels=False, fold_qkv=True)
    assert not folded(128, use_kernels=True, fold_qkv=False)


def test_prod_fold_qkv_builds_on_the_block_route():
    """`-cn prod +trainer.fold_qkv=true` builds a generator (the key is a
    schema default, not in the YAML, hence the `+`; the JAX package
    ignores fold_qkv on the block route, which takes precedence): the
    model is the block route's, and its output is the unfolded model's."""
    cfg = ConfigRegistry.create_config(compose("prod", ["+trainer.fold_qkv=true"],
                                               resolve_interpolations=False))
    kw = afgsa_kwargs_from_config(cfg)
    assert kw["fold_qkv"] and kw["use_block_kernel"]
    with torch.device("meta"):
        model = afgsa.AFGSANet(**kw)
    assert model.block_route(8, 128, 128)

    small = _small(use_kernels=True, use_block_kernel=True, dtype=torch.bfloat16)
    folded = afgsa.AFGSANet(**small, fold_qkv=True, generator=torch.Generator().manual_seed(1))
    plain = afgsa.AFGSANet(**small)
    plain.load_state_dict(folded.state_dict())
    assert folded.block_route(1, 16, 16)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.uniform(0, 2, (1, 16, 16, 3)).astype(np.float32))
    aux = torch.from_numpy(rng.standard_normal((1, 16, 16, 7)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(folded(x, aux), plain(x, aux))

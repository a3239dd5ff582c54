"""PyTorch port: the fused Mamba2 chain's backward against the JAX package.

On the CPU, inputs from seeded numpy (tests/test_ssd_mega.py
`_make_inputs`), cotangent from seed 9. The reference is `jax.vjp` of the
TPU kernel pair `ssd_mega.fused_mamba_chain` in interpret mode (its custom
VJP: `_fwd_kernel_train`, then `_bwd_kernel`). Tolerances, relative to
each reference gradient's largest magnitude:
- fp32, all seven gradients: 5e-5, ten times tighter than
  tests/test_ssd_mega.py:117-121's 5e-4 (only f32 summation order
  differs; the cancelling dt_bias sums read up to 5e-6);
- bf16 at one config: dzx max one bf16 ulp of the largest value (2**-8),
  rms 1e-6; the parameter gradients 5e-5. The TPU backward reads the saved
  entering states rounded to bf16: with unrounded states the port lands
  outside these bounds (the dt_bias and A gradients move by ~2e-4), so
  this test holds that rounding;
- against `torch.autograd` of the plain forward (fp32): 1e-5.
The emit variant's states against the TPU `_fwd(emit=True)`: fp32 1e-5;
bf16 within one bf16 ulp of the largest state (f32 sums in another order
may round the other way). `chip_smoke.py`'s control for K8's bounds (the
plain backward with the state-gradient carry cut) must fail them here too.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.ops import ssd_mega as jmega  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import ssd_mega  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# (b, l, d_inner, d_state, headdim, chunk): tests/test_ssd_mega.py CONFIGS
CONFIGS = [
    (2, 256, 128, 64, 64, 64),
    (1, 128, 128, 32, 32, 32),
    (2, 192, 256, 64, 64, 64),
]
NAMES = ("dzx", "conv_w", "conv_b", "dt_bias", "A", "D", "norm_w")


def _inputs(seed, b, l, d_inner, d_state, headdim, k=4):
    rng = np.random.default_rng(seed)
    h = d_inner // headdim
    dc = d_inner + 2 * d_state
    zx = rng.standard_normal((b, l, 2 * d_inner + 2 * d_state + h)).astype(np.float32) * 0.5
    conv_w = (rng.standard_normal((k, dc)) * 0.2).astype(np.float32)
    conv_b = (rng.standard_normal(dc) * 0.1).astype(np.float32)
    dt_bias = rng.uniform(-4.0, -1.0, h).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.5, h)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    norm_w = (1.0 + 0.1 * rng.standard_normal(d_inner)).astype(np.float32)
    dy = np.random.default_rng(9).standard_normal((b, l, d_inner)).astype(np.float32)
    return (zx, conv_w, conv_b, dt_bias, A, D, norm_w), dy


def _dims(cfg) -> dict:
    _, _, d_inner, d_state, headdim, chunk = cfg
    return dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)


def _jax_vjp(args, dy, cfg, bf16=False):
    _, _, d_inner, d_state, headdim, chunk = cfg
    ja = [jnp.asarray(a) for a in args]
    if bf16:
        ja[0] = ja[0].astype(jnp.bfloat16)
    out, vjp = jax.vjp(
        lambda *a: jmega.fused_mamba_chain(*a, d_inner, d_state, headdim, chunk, True), *ja)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy).astype(out.dtype))]


def _port_bwd(args, dy, cfg, bf16=False, states=None):
    t = [torch.from_numpy(a.copy()) for a in args]
    dyt = torch.from_numpy(dy)
    if bf16:
        t[0], dyt = t[0].bfloat16(), dyt.bfloat16()
    if states is None:
        _, states = ssd_mega.fused_mamba_chain_torch(*t, **_dims(cfg), emit=True)
    return ssd_mega.fused_mamba_chain_bwd_torch(*t, states, dyt, **_dims(cfg))


def _rel(got, want) -> tuple:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want)
    return err.max() / scale, np.sqrt((err**2).mean()) / scale


@pytest.mark.parametrize("cfg", CONFIGS)
def test_bwd_matches_tpu_vjp_interpret(cfg):
    args, dy = _inputs(1, *cfg[:5])
    want = _jax_vjp(args, dy, cfg)
    got = _port_bwd(args, dy, cfg)
    for name, g, w, a in zip(NAMES, got, want, args):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        assert _rel(g.numpy(), w)[0] <= 5e-5, (name, _rel(g.numpy(), w))


def test_bwd_bf16_matches_tpu_vjp_and_its_state_rounding():
    cfg = CONFIGS[0]
    args, dy = _inputs(1, *cfg[:5])
    want = _jax_vjp(args, dy, cfg, bf16=True)
    got = _port_bwd(args, dy, cfg, bf16=True)
    assert got[0].dtype == torch.bfloat16
    mx, rms = _rel(got[0].float().numpy(), want[0])
    assert mx <= 2**-8 and rms <= 1e-6, (mx, rms)
    for name, g, w in zip(NAMES[1:], got[1:], want[1:]):
        assert _rel(g.numpy(), w)[0] <= 5e-5, (name, _rel(g.numpy(), w))
    # the same backward at the unrounded f32 states misses the TPU function
    zx = torch.from_numpy(args[0].copy())
    _, f32_states = ssd_mega.fused_mamba_chain_torch(
        zx, *(torch.from_numpy(a.copy()) for a in args[1:]), **_dims(cfg), emit=True)
    off = _port_bwd(args, dy, cfg, bf16=True, states=f32_states)
    worst = max(_rel(g.numpy(), w)[0] for g, w in zip(off[1:], want[1:]))
    assert worst > 5e-5, worst


@pytest.mark.parametrize("cfg", [CONFIGS[1], (1, 256, 128, 32, 8, 16)])
def test_bwd_matches_autograd_of_plain_forward(cfg):
    args, dy = _inputs(2, *cfg[:5])
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    ssd_mega.fused_mamba_chain_torch(*leaves, **_dims(cfg)).backward(torch.from_numpy(dy))
    got = _port_bwd(args, dy, cfg)
    for name, g, leaf in zip(NAMES, got, leaves):
        assert _rel(g.numpy(), leaf.grad.numpy())[0] <= 1e-5, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emit_states_match_tpu_fwd_train(dtype):
    cfg = CONFIGS[0]
    b, l, d_inner, d_state, headdim, chunk = cfg
    args, _ = _inputs(3, *cfg[:5])
    ja = [jnp.asarray(a) for a in args]
    ja[0] = ja[0].astype(getattr(jnp, dtype))
    y, stin, _ = jmega._fwd(*ja, d_inner=d_inner, d_state=d_state, headdim=headdim,
                            chunk=chunk, emit=True, interpret=True)
    t = [torch.from_numpy(a.copy()) for a in args]
    t[0] = t[0].to(getattr(torch, dtype))
    out, states = ssd_mega.fused_mamba_chain_torch(*t, **_dims(cfg), emit=True)
    h = d_inner // headdim
    assert states.dtype == t[0].dtype and states.shape == (b, l // chunk, h, d_state, headdim)
    # the TPU layout [b, nc, n, di] → [b, nc, h, n, p]
    want = np.asarray(stin.astype(jnp.float32)).reshape(b, l // chunk, d_state, h, headdim)
    want = want.transpose(0, 1, 3, 2, 4)
    bound = 1e-5 if dtype == "float32" else 2**-8
    assert _rel(states.float().numpy(), want)[0] <= bound
    assert torch.equal(out, ssd_mega.fused_mamba_chain_torch(*t, **_dims(cfg)))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mamba_chain_fn_is_the_plain_pair_on_the_cpu(use_kernels):
    """`MambaChainFn` on CPU tensors: the plain emit forward and backward,
    through the dispatchers (use_kernels) or directly."""
    cfg = CONFIGS[1]
    args, dy = _inputs(4, *cfg[:5])
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    conf = ssd_mega.MambaChainConfig(**_dims(cfg), use_kernels=use_kernels)
    out = ssd_mega.MambaChainFn.apply(conf, *leaves)
    assert torch.equal(out.detach(), ssd_mega.fused_mamba_chain_torch(
        *(t.detach() for t in leaves), **_dims(cfg)))
    out.backward(torch.from_numpy(dy))
    want = _port_bwd(args, dy, cfg)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name


def test_bwd_dispatchers_refuse_autograd():
    cfg = CONFIGS[1]
    args, dy = _inputs(5, *cfg[:5])
    t = [torch.from_numpy(a.copy()) for a in args]
    _, states = ssd_mega.fused_mamba_chain_torch(*t, **_dims(cfg), emit=True)
    t[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        ssd_mega.fused_mamba_chain_emit(*t, **_dims(cfg))
    with pytest.raises(RuntimeError, match="not differentiable"):
        ssd_mega.fused_mamba_chain_bwd(*t, states, torch.from_numpy(dy), **_dims(cfg))
    with torch.no_grad():
        got = ssd_mega.fused_mamba_chain_bwd(*t, states, torch.from_numpy(dy), **_dims(cfg))
    assert torch.equal(got[0], ssd_mega.fused_mamba_chain_bwd_torch(
        *t, states, torch.from_numpy(dy), **_dims(cfg))[0])


@pytest.mark.parametrize("cfg", CONFIGS + [(2, 1024, 128, 16, 32, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_carry_cut_control_fails_k8_bounds(cfg, dtype):
    """The control of chip_smoke.py's K8 rows fails their bounds at the
    test shapes, in both dtypes."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    args, dy = _inputs(6, *cfg[:5])
    t = [torch.from_numpy(a.copy()) for a in args]
    dyt = torch.from_numpy(dy)
    t[0], dyt = t[0].to(getattr(torch, dtype)), dyt.to(getattr(torch, dtype))
    _, states = ssd_mega.fused_mamba_chain_torch(*t, **_dims(cfg), emit=True)
    ref = ssd_mega.fused_mamba_chain_bwd_torch(*t, states, dyt, **_dims(cfg))
    ctl = chip_smoke.carry_cut_chain_bwd(*t, states, dyt, **_dims(cfg))
    label = "bf16" if dtype == "bfloat16" else "fp32"
    bounds = chip_smoke.MAMBA_BWD_TOL[label]
    bad = chip_smoke.outside(chip_smoke.named_devs(bounds, ctl, ref), bounds)
    assert {"dzx", "dt_bias", "A"} <= set(bad), bad

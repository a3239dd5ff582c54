"""PyTorch port: the literal Mamba2 route with the fused conv1d + SiLU
(`use_pallas`) against the JAX package, on the CPU.

The JAX side runs its `conv_pallas` kernel as tests/test_mamba.py:223-258
does: under `pltpu.force_tpu_interpret_mode()`. One flax param tree goes
into both packages, and inputs and output gradients come from seeded
numpy. d_model 32 gives d_inner 128 and, with d_state 64, conv_dim 256:
lane-aligned windows, so both gates admit the fused conv. Tolerances, in
float32 (JAX at HIGHEST precision), relative to the reference's largest
magnitude: the layer's output 1e-5 and gradients 1e-4; the 2-block
denoiser's output 1e-4 (f32 sums in another order through the encoders,
the blocks and the decoder, as tests/test_torch_port_mamba_model.py).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pixel_heal_thyself_tpu.models import mamba as jmamba  # noqa: E402
from pixel_heal_thyself_tpu.ops import conv_pallas  # noqa: E402
from pixel_heal_thyself_tpu_torch import bench_mamba  # noqa: E402
from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose  # noqa: E402
from pixel_heal_thyself_tpu_torch.inference import mamba_kwargs_from_config  # noqa: E402
from pixel_heal_thyself_tpu_torch.models import mamba  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import conv_fused  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import mamba_state_from_flax  # noqa: E402

LAYER = dict(d_model=32, d_state=64, headdim=32)
NET = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=64, headdim=32, expansion=4,
           padding_mode="replicate", num_gcp=0)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _fill(rng):
    """Seeded values for a flax param leaf, scaled by its role."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "A_log":
            return rng.uniform(0.0, 1.5, leaf.shape).astype(np.float32)
        if name == "dt_bias":
            return rng.uniform(-4.0, -1.0, leaf.shape).astype(np.float32)
        if name in ("scale", "weight", "D"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan = float(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 10.0
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(np.float32)
    return fill


def _layer_state(params) -> dict:
    """A flax Mamba2Layer tree as the port's `Mamba2Layer` state dict."""
    out = {}
    for name, val in params.items():
        if name in ("in_proj", "out_proj"):
            out[f"{name}.weight"] = torch.from_numpy(np.asarray(val["kernel"]).T.copy())
        elif name == "norm":
            out["norm.weight"] = torch.from_numpy(np.array(val["weight"]))
        else:
            out[name] = torch.from_numpy(np.array(val))
    return out


@pytest.fixture
def spy(monkeypatch):
    """Counts the port's fused conv forwards and backwards."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = conv_fused.fused_causal_conv1d_silu, conv_fused.fused_causal_conv1d_silu_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(conv_fused, "fused_causal_conv1d_silu", count_fwd)
    monkeypatch.setattr(conv_fused, "fused_causal_conv1d_silu_bwd", count_bwd)
    return calls


def test_layer_fused_conv_matches_jax(spy):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 64, 32)).astype(np.float32)
    dout = rng.standard_normal((1, 64, 32)).astype(np.float32)
    jlayer = jmamba.Mamba2Layer(**LAYER, use_pallas=True)
    shapes = jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(4)), shapes)
    with jax.default_matmul_precision("highest"), pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda p, u: jlayer.apply({"params": p}, u), params, jnp.asarray(x))
        dparams, dx = vjp(jnp.asarray(dout))

    layer = mamba.Mamba2Layer(**LAYER, use_pallas=True, use_kernels=True)
    assert layer.fused_conv_route(64) and not layer.fused_route(64)
    layer.load_state_dict(_layer_state(params))
    u = torch.from_numpy(x).requires_grad_(True)
    got = layer(u)
    got.backward(torch.from_numpy(dout))
    assert spy == {"fwd": 1, "bwd": 1}, "the fused conv route was not taken"
    _close(got.detach(), want, 1e-5)
    _close(u.grad, dx, 1e-4)
    grads = {n: p.grad for n, p in layer.named_parameters()}
    for name, want_g in _layer_state(dparams).items():
        _close(grads[name], want_g, 1e-4)
    with torch.no_grad():
        _close(layer(u), want, 1e-5)
    assert spy == {"fwd": 2, "bwd": 1}


def test_denoiser_literal_fused_conv_matches_jax(spy):
    jnet = jmamba.MambaDenoiserNet(**NET, use_pallas=True)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    aux = rng.uniform(-1, 1, (2, 16, 16, 7)).astype(np.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                            jnp.zeros((1, 16, 16, 7)))["params"]
    params = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(6)), shapes)
    calls = []
    orig = conv_pallas.fused_causal_conv1d_silu
    try:
        conv_pallas.fused_causal_conv1d_silu = lambda *a, **k: calls.append(1) or orig(*a, **k)
        with jax.default_matmul_precision("highest"), pltpu.force_tpu_interpret_mode():
            want = jnet.apply({"params": params}, x, aux)
    finally:
        conv_pallas.fused_causal_conv1d_silu = orig
    assert calls, "the JAX model did not take its fused conv"

    model = mamba.MambaDenoiserNet(**NET, use_pallas=True, use_kernels=True).eval()
    model.load_state_dict(mamba_state_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(aux))
    assert spy["fwd"] == NET["num_blocks"]
    _close(got, want, 1e-4)


def test_fused_conv_off_in_the_trainer_config():
    """The JAX `MambaTrainer` hard-wires `use_pallas=False` for the Mamba
    generator (training/trainer.py:641-645); so does the port's mapping."""
    cfg = ConfigRegistry.create_config(compose("prod", ["model=mamba"],
                                               resolve_interpolations=False))
    assert mamba_kwargs_from_config(cfg)["use_pallas"] is False


def test_bench_mamba_runs_on_cpu(capsys):
    """The sections of `python -m pixel_heal_thyself_tpu_torch.bench_mamba
    --pallas --device cpu` at one 16² patch (256 tokens: the fused conv and
    the `ssd_pallas` scan both take their plain versions)."""
    res = bench_mamba.run(batch=1, patch=16, iters=1, pallas=True, device="cpu")
    assert list(res) == ["Mamba G fwd", "Mamba G fwd+bwd (L1)", "Mamba2Layer fwd+bwd",
                         "SSD core fwd+bwd", "SSD chunked fwd", "SSD pallas fwd"]
    assert all(r["ms"] > 0 and r["peak_bytes"] is None for r in res.values())
    assert "peak not measured (CPU)" in capsys.readouterr().out

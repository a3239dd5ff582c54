"""`tools/tpu_rounding.py`, the replay of the TPU kernel #5's forward with
one-pass bf16 products, on the CPU.

- `bf16_products_chain` against the JAX package's
  `ssd_mega.fused_mamba_chain(..., interpret=True)` with its `_dot`
  patched (for the test only, `unittest.mock.patch.object`) to round both
  operands to bf16 before the f32-accumulated product: relative error
  ||got − want|| / ||want|| within TOL = 1e-5, at l 256, chunk 128,
  d_inner 128, d_state 16, headdim 32, inputs from numpy seeds. The patch
  reaches the kernel only through a fresh trace, so JAX's caches are
  cleared around each patched call.
- The control: the port's unrounded `fused_mamba_chain_torch` lies more
  than 10 × TOL from the same patched output, so the first test cannot
  pass with an unrounded chain.
- A bf16 `zxbcdt` gives a bf16 output rounded once from the f32 chain;
  `replayed()` swaps the model's no-grad interior and counts its calls;
  the H1 rule's edges.
- `run` end to end on a tiny campaign checkpoint (`--device cpu`): both
  passes finite, the replay called, the K7 pass through the plain
  version, and the record's deltas those of its two passes.
"""

from __future__ import annotations

import json
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.ops import ssd_mega as jmega  # noqa: E402
from pixel_heal_thyself_tpu_torch.config.run_dirs import reset_run_dirs_cache  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import ssd_mega  # noqa: E402
from pixel_heal_thyself_tpu_torch.tools import quality_campaign as qc  # noqa: E402
from pixel_heal_thyself_tpu_torch.tools import tpu_rounding  # noqa: E402

TOL = 1e-5
# (b, l, d_inner, d_state, headdim, chunk)
SHAPE = (2, 256, 128, 16, 32, 128)
SEEDS = (0, 1, 2, 3)


@pytest.fixture(autouse=True, scope="module")
def _determinism_restored():
    """A trainer sets torch's determinism switches and
    CUBLAS_WORKSPACE_CONFIG for its process (`trainer.deterministic`):
    restored when this file's tests end, so that the worker's next files
    run under torch's defaults."""
    import os
    from unittest import mock

    from pixel_heal_thyself_tpu_torch.tools.critic_numerics import arithmetic, switches_now

    with arithmetic(switches_now()), mock.patch.dict(os.environ):
        yield


def _inputs(seed, b, l, d_inner, d_state, headdim, k=4):
    """tests/test_ssd_mega.py `_make_inputs`, as numpy."""
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
    return zx, conv_w, conv_b, dt_bias, A, D, norm_w


def _dims():
    _, _, d_inner, d_state, headdim, chunk = SHAPE
    return dict(d_inner=d_inner, d_state=d_state, headdim=headdim, chunk=chunk)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _patched_tpu_kernel(args) -> np.ndarray:
    """The interpret-mode TPU kernel with every `_dot` rounding both
    operands once to bf16 (f32 accumulation), traced afresh."""
    exact = jmega._dot

    def one_pass_bf16(a, b, dims):
        return exact(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), dims)

    d = _dims()
    jax.clear_caches()
    try:
        with mock.patch.object(jmega, "_dot", one_pass_bf16):
            out = jmega.fused_mamba_chain(*map(jnp.asarray, args), d["d_inner"], d["d_state"],
                                          d["headdim"], d["chunk"], True)
            return np.asarray(out)
    finally:
        jax.clear_caches()  # no later trace reuses the patched one


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@pytest.mark.parametrize("seed", SEEDS)
def test_replay_matches_tpu_kernel_with_bf16_products(seed):
    args = _inputs(seed, *SHAPE[:5])
    want = _patched_tpu_kernel(args)
    got = tpu_rounding.bf16_products_chain(*map(_t, args), **_dims())
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_control_unrounded_chain_misses_the_bound(seed):
    args = _inputs(seed, *SHAPE[:5])
    want = _patched_tpu_kernel(args)
    plain = ssd_mega.fused_mamba_chain_torch(*map(_t, args), **_dims())
    assert _rel(plain, want) > 10 * TOL


def test_bf16_input_rounds_the_output_once():
    args = list(map(_t, _inputs(5, *SHAPE[:5])))
    zx16 = args[0].bfloat16()
    got = tpu_rounding.bf16_products_chain(zx16, *args[1:], **_dims())
    assert got.dtype == torch.bfloat16
    want = tpu_rounding.bf16_products_chain(zx16.float(), *args[1:], **_dims())
    assert torch.equal(got, want.bfloat16())


def test_replayed_swaps_the_models_interior():
    kw = dict(base_ch=64, num_blocks=1, d_state=16, expansion=2, headdim=32, num_gcp=0,
              enc_ch=16, use_megakernel=True)
    net = MambaDenoiserNet(**kw, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    # 16² pixels: 256 tokens, two chunks of 128
    noisy = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    aux = torch.rand(1, 16, 16, 7, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        plain = net(noisy, aux)
        with tpu_rounding.replayed() as calls:
            got = net(noisy, aux)
        again = net(noisy, aux)
    assert len(calls) == 1
    assert torch.equal(again, plain)  # restored
    assert 0 < _rel(got, plain) < 1e-2


@pytest.mark.parametrize("served, val, want", [
    (-0.2, -0.0666, True), (-0.45, 0.1, True), (-0.3, -0.11, False), (-0.19, 0.0, False),
    (-0.46, 0.0, False), (0.3, 0.0, False)])
def test_h1_rule(served, val, want):
    assert tpu_rounding.h1_holds(served, val) is want


def test_run_end_to_end_on_the_cpu(tmp_path):
    """A tiny seed leg of 2b trained, served and replayed on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    reset_run_dirs_cache()
    narrow = ["trainer.epochs=1", "data.patches.num_patches=8", "data.patches.patch_size=16",
              "trainer.batch_size=2", "model.feature_map_channels=64", "+model.enc_channels=16",
              "model.mamba.num_layers=1", "model.mamba.expansion=2", "model.mamba.headdim=32",
              "model.mamba.d_state=16"]
    try:
        qc.run(tmp_path, out="seeds", legs=("1", "2b-s990820-d16", "4"), overrides=narrow,
               device="cpu", size=64, n_scenes=2, replay=True, log=lambda _: None)
    finally:
        torch.set_num_threads(n)
        reset_run_dirs_cache()
    leg = json.loads((tmp_path / "seeds" / "legs" / "2b-s990820-d16.json").read_text())
    rec = json.loads((tmp_path / "seeds" / "replay" / "2b-s990820-d16.json").read_text())
    assert rec["seed"] == leg["seed"] == 990820 and rec["checkpoint"] == leg["checkpoint"]
    assert rec["finite"] and rec["frames_rms_rel"] > 0
    assert rec["k7"]["replay_calls"] == 0 < rec["replay"]["replay_calls"]
    assert sorted(rec["k7"]["scenes"]) == sorted(leg["scene_psnr"]) == sorted(
        qc.TRAIN_SCENES[:2] + qc.HELDOUT_SCENES)
    assert rec["k7"]["full_frame_psnr"] == pytest.approx(leg["full_frame_psnr"], abs=1e-3)
    assert rec["delta"]["full_frame_psnr"] == (rec["replay"]["full_frame_psnr"]
                                               - rec["k7"]["full_frame_psnr"])
    assert rec["delta"]["val_psnr"] == rec["replay"]["val_psnr"] - rec["k7"]["val_psnr"]
    assert rec["h1_holds"] is tpu_rounding.h1_holds(rec["delta"]["full_frame_psnr"],
                                                    rec["delta"]["val_psnr"])

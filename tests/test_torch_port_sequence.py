"""PyTorch port: sequence-sharded Mamba serving against the JAX package.

A gloo world of 4 CPU ranks (`spawn_world`, one torch thread a rank,
`init_method=file://`) runs `tests/torch_port_parallel_workers.
sequence_rank`: a 2-block MambaDenoiserNet (weights from one seeded flax
tree through `params.mamba_state_from_flax`) in `seq_axis` mode over the
whole world and over a subgroup of 2; rank 0 saves the outputs. Bounds:
- float32 at 4 and 2 ranks against the JAX model unsharded, the JAX
  sequence-sharded apply under `shard_map` and the port's model unsharded:
  1e-4 relative and absolute (`tests/test_sequence_sharded.py`);
- `use_megakernel=True` under `seq_axis` takes the literal chain, as the
  JAX gate says: at a width and strip length the fused gate admits (d_inner
  128, 128 tokens a rank) its frame equals the literal model's to the bit,
  and the unsharded fused model's within 1e-4;
- bfloat16 at 2 ranks against the port's model unsharded: 3e-2 max, 4e-3
  rms relative to the largest output (chip_smoke's FRAME_TOL: bf16 values
  next to a rounding boundary may round the other way through convs of
  another shape);
- `denoise_frame_sequence` on a height of 30 over 4 ranks (edge-padded to
  32) pins the deviation as the JAX package does, with that test's model
  and weights (`init` at key 0, reflect padding): rows above the conv
  receptive band of 9 rows match the unsharded model (rtol 1e-4, atol
  1e-5), the band deviates by less than 0.15 of the largest output, and the
  whole frame matches the JAX `denoise_frame_sequence` (1e-4).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.inference import (  # noqa: E402
    denoise_frame_sequence as jdenoise_frame_sequence,
)
from pixel_heal_thyself_tpu.models.mamba import MambaDenoiserNet as JMamba  # noqa: E402
from pixel_heal_thyself_tpu.parallel.mesh import make_mesh  # noqa: E402
from pixel_heal_thyself_tpu.parallel.sequence import (  # noqa: E402
    make_seq_sharded_apply as jmake_seq_sharded_apply,
)
from pixel_heal_thyself_tpu_torch import inference  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel import distributed  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel.mesh import RowAxis  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel.sequence import make_seq_sharded_apply  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import mamba_state_from_flax  # noqa: E402

import torch_port_parallel_workers as workers  # noqa: E402

SMALL = dict(base_ch=16, enc_ch=16, num_blocks=2, d_state=8, headdim=8, expansion=2,
             num_gcp=1)
# the JAX package's pinned padded case (`tests/test_sequence_sharded.py:185`)
PINNED = dict(base_ch=16, enc_ch=16, num_blocks=2, d_state=8, headdim=8, expansion=2,
              num_gcp=0)
# widths the fused gate admits: d_inner 128; 64 × 8 frames give 128 tokens a rank
FUSED = dict(base_ch=32, enc_ch=16, num_blocks=1, d_state=16, headdim=32, expansion=4,
             num_gcp=0)
TOL = dict(rtol=1e-4, atol=1e-4)
FRAME_TOL = (3e-2, 4e-3)
# name → (ranks, port kwargs beyond SMALL)
MODELS = {"fp32": (4, {}), "fp32_r2": (2, {}), "bf16_r2": (2, {"dtype": torch.bfloat16})}


def _fill(rng):
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


@functools.lru_cache(maxsize=None)
def _flax_params() -> dict:
    shapes = jax.eval_shape(JMamba(**SMALL).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 8, 3)), jnp.zeros((1, 32, 8, 7)))["params"]
    return jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(7)), shapes)


def _port_model(**kw) -> MambaDenoiserNet:
    model = MambaDenoiserNet(**SMALL, **kw).eval()
    model.load_state_dict(mamba_state_from_flax(_flax_params()))
    return model


@functools.lru_cache(maxsize=None)
def _inputs() -> tuple:
    rng = np.random.default_rng(7)
    noisy = rng.uniform(0.05, 2.0, (1, 32, 8, 3)).astype(np.float32)
    aux = rng.uniform(-1, 1, (1, 32, 8, 7)).astype(np.float32)
    return noisy, aux


@functools.lru_cache(maxsize=None)
def _pinned() -> tuple:
    """The JAX test's frame (30 rows, edge-padded to 32 over 4 ranks) and
    its model's params, `init` at key 0 on the log-space inputs."""
    rng = np.random.default_rng(11)
    data = {"noisy": rng.uniform(0.05, 2.0, (30, 8, 3)).astype(np.float32),
            "aux": rng.uniform(-1, 1, (30, 8, 7)).astype(np.float32)}
    noisy_log, aux = inference._model_inputs(data)
    params = JMamba(**PINNED).init(jax.random.PRNGKey(0), noisy_log[None], aux[None])
    return data, params["params"]


def _fused_models() -> tuple:
    """The FUSED-width model (seeded torch weights) with the fused route on,
    and its literal twin."""
    fused = MambaDenoiserNet(**FUSED, use_megakernel=True,
                             generator=torch.Generator().manual_seed(3)).eval()
    literal = MambaDenoiserNet(**FUSED).eval()
    literal.load_state_dict(fused.state_dict())
    return fused, literal


def _fused_inputs() -> tuple:
    rng = np.random.default_rng(8)
    return (rng.uniform(0.05, 2.0, (1, 64, 8, 3)).astype(np.float32),
            rng.uniform(-1, 1, (1, 64, 8, 7)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory) -> dict:
    """The outputs of `workers.sequence_rank` over a gloo world of 4 CPU ranks."""
    out = tmp_path_factory.mktemp("sequence")
    noisy, aux = _inputs()
    state = {k: v.numpy() for k, v in mamba_state_from_flax(_flax_params()).items()}
    cases = {name: {"ranks": ranks, "kwargs": dict(SMALL, **kw), "state": state,
                    "noisy": noisy, "aux": aux} for name, (ranks, kw) in MODELS.items()}
    data, params = _pinned()
    cases["padded"] = {"ranks": 4, "kwargs": PINNED, "data": data, "state": {
        k: v.numpy() for k, v in mamba_state_from_flax(params).items()}}
    fused, _ = _fused_models()
    fused_noisy, fused_aux = _fused_inputs()
    for name, on in (("fused", True), ("fused_literal", False)):
        cases[name] = {"ranks": 4, "kwargs": dict(FUSED, use_megakernel=on),
                       "state": {k: v.numpy() for k, v in fused.state_dict().items()},
                       "noisy": fused_noisy, "aux": fused_aux}
    distributed.spawn_world(workers.sequence_rank, 4, f"file://{out}/init", "cpu",
                            args=(str(out), cases), threads=1)
    return torch.load(out / "outputs.pt", weights_only=False)


@functools.lru_cache(maxsize=None)
def _jax_unsharded() -> np.ndarray:
    noisy, aux = _inputs()
    return np.asarray(jax.jit(JMamba(**SMALL).apply)({"params": _flax_params()},
                                                     jnp.asarray(noisy), jnp.asarray(aux)))


@functools.lru_cache(maxsize=None)
def _port_unsharded(dtype=torch.float32) -> np.ndarray:
    noisy, aux = _inputs()
    with torch.no_grad():
        return _port_model(dtype=dtype)(torch.from_numpy(noisy), torch.from_numpy(aux)).numpy()


def test_ranks_import_no_jax(ranks_out):
    assert ranks_out["jax_loaded"] is False


@pytest.mark.parametrize("name", ["fp32", "fp32_r2"])
def test_sequence_sharded_matches_jax_unsharded(ranks_out, name):
    got, want = ranks_out[name], _jax_unsharded()
    assert got.shape == want.shape == (1, 32, 8, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["fp32", "fp32_r2"])
def test_sequence_sharded_matches_jax_sharded(ranks_out, name):
    noisy, aux = _inputs()
    ranks = MODELS[name][0]
    mesh = make_mesh(data_axis=ranks, model_axis=1, devices=jax.devices()[:ranks])
    apply = jmake_seq_sharded_apply(JMamba(**SMALL), {"params": _flax_params()}, mesh)
    np.testing.assert_allclose(ranks_out[name], np.asarray(apply(jnp.asarray(noisy),
                                                                 jnp.asarray(aux))), **TOL)


@pytest.mark.parametrize("name", ["fp32", "fp32_r2"])
def test_sequence_sharded_matches_port_unsharded(ranks_out, name):
    np.testing.assert_allclose(ranks_out[name], _port_unsharded(), **TOL)


def test_megakernel_off_under_seq_axis(ranks_out):
    """As in JAX, `seq_axis` turns the fused route off: the fused model's
    sharded frame is its literal twin's, to the bit, and within 1e-4 of the
    fused model on the whole frame."""
    fused, _ = _fused_models()
    layer = fused.blocks[0].mamba
    assert layer.fused_route(128) and not layer.fused_route(128, RowAxis(4, 0, None))
    np.testing.assert_array_equal(ranks_out["fused"], ranks_out["fused_literal"])
    with torch.no_grad():
        whole = fused(*(torch.from_numpy(a) for a in _fused_inputs())).numpy()
    np.testing.assert_allclose(ranks_out["fused"], whole, **TOL)


def test_bf16_sequence_sharded_within_frame_bound(ranks_out):
    got, want = ranks_out["bf16_r2"], _port_unsharded(torch.bfloat16)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert err.max() / scale <= FRAME_TOL[0] and np.sqrt((err**2).mean()) / scale <= FRAME_TOL[1]


def test_non_divisible_height_raises():
    apply = make_seq_sharded_apply(_port_model(), RowAxis(4, 0, None))
    with pytest.raises(ValueError, match="divisible"):
        apply(torch.zeros(1, 18, 8, 3), torch.zeros(1, 18, 8, 7))


def test_non_divisible_height_deviation_is_pinned(ranks_out):
    """`denoise_frame_sequence` edge-pads 30 rows to 32 over 4 ranks; the
    padded rows reach the bottom real rows through the conv FFNs: encoder
    5×5 (2 rows) + 2 blocks × 2 FFN 3×3 (4) + 3 decoder 3×3 (3) = 9 rows.
    Above the band the frame is the unsharded model's; inside, the
    deviation stays under 0.15 of the output scale; everywhere it is the
    JAX package's sharded frame."""
    data, params = _pinned()
    h, band = 30, 9
    got = ranks_out["padded"]
    noisy_log, aux = inference._model_inputs(data)
    want = inference.postprocess_specular(np.asarray(jax.jit(JMamba(**PINNED).apply)(
        {"params": params}, noisy_log[None], aux[None]))[0])
    assert got.shape == want.shape == (h, 8, 3)
    np.testing.assert_allclose(got[:h - band], want[:h - band], rtol=1e-4, atol=1e-5)
    assert np.abs(got - want).max() / np.abs(want).max() < 0.15
    mesh = make_mesh(data_axis=4, model_axis=1, devices=jax.devices()[:4])
    jfn = jmake_seq_sharded_apply(JMamba(**PINNED), {"params": params}, mesh)
    np.testing.assert_allclose(got, jdenoise_frame_sequence(jfn, data, 4), **TOL)

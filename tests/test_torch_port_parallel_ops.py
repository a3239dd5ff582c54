"""PyTorch port: the ops of sharded serving against the JAX package.

In this process: `ssd_naive` / `ssd_chunked` with `initial_state` and
`return_final_state`, `ssd_state_summary`, `causal_depthwise_conv1d` with
`initial_tokens`, `make_row_halo_pad` on one rank, `auto_data_axis`, the
backend rule and the bootstrap's refusals. Across ranks: one gloo world of
4 CPU ranks (`spawn_world`, one torch thread a rank, `init_method=file://`)
runs `tests/torch_port_parallel_workers.ops_rank` over the whole world and
over a subgroup of 2; rank 0 saves the outputs and the tests below hold
them against the JAX functions under `shard_map` on 2 and 4 of the 8
virtual CPU devices. Tolerances, as the JAX package's own tests:
- SSD: 2e-4 relative and absolute (`tests/test_sequence_sharded.py`);
- the halo pad and the conv1d: 1e-6 (the same values moved, one product
  per tap);
- the merged 5×5 encoder under halo padding against the JAX literal
  three-branch encoder under `shard_map` and the port's unsharded one:
  1e-5 of the largest output (the tap sums in another order).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from pixel_heal_thyself_tpu.models import afgsa as jafgsa  # noqa: E402
from pixel_heal_thyself_tpu.ops import conv as jconv  # noqa: E402
from pixel_heal_thyself_tpu.ops import padding as jpadding  # noqa: E402
from pixel_heal_thyself_tpu.ops import ssd as jssd  # noqa: E402
from pixel_heal_thyself_tpu.parallel.mesh import make_mesh  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import MultiScaleEncoder  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import ssd  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.conv import causal_depthwise_conv1d  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.padding import make_row_halo_pad, pad2d  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel import distributed, mesh  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel.spatial import make_sharded_apply_rows  # noqa: E402

import torch_port_parallel_workers as workers  # noqa: E402

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
# (ranks, chunk, l): 88 tokens give strips of 44 and 22, neither a chunk multiple
SSD_CASES = {"r2_l64": (2, 8, 64), "r4_l64": (4, 8, 64), "r2_l88": (2, 8, 88),
             "r4_l88": (4, 8, 88)}
HALO = [(ranks, mode, pad) for ranks in (2, 4) for mode in ("zeros", "reflect", "replicate")
        for pad in (1, 2)]
ENCODER = dict(features=8, slopes=(0.0, 0.2, 0.2))


def _ssd_inputs(seed, b=2, l=64, h=4, p=8, g=2, n=8) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((b, l, h, p)).astype(np.float32),
        "dt": rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32),
        "A": -rng.uniform(0.5, 4.0, (h,)).astype(np.float32),
        "B": rng.standard_normal((b, l, g, n)).astype(np.float32),
        "C": rng.standard_normal((b, l, g, n)).astype(np.float32),
        "D": rng.standard_normal((h,)).astype(np.float32),
    }


def _j(inp: dict, *keys) -> list:
    return [jnp.asarray(inp[k]) for k in keys]


def _t(inp: dict, *keys) -> list:
    return [torch.from_numpy(inp[k]) for k in keys]


def _mesh(n: int):
    return make_mesh(data_axis=n, model_axis=1, devices=jax.devices()[:n])


def _encoder_cases() -> dict:
    rng = np.random.default_rng(12)
    state = {}
    for i, k in enumerate((1, 3, 5)):
        state[f"branches.{i}.weight"] = (rng.standard_normal((8, 7, k, k)) / (7 * k)).astype(
            np.float32)
        state[f"branches.{i}.bias"] = (0.1 * rng.standard_normal(8)).astype(np.float32)
    x = rng.uniform(-1, 1, (1, 16, 12, 7)).astype(np.float32)
    return dict(ENCODER, state=state, x=x)


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    rng = np.random.default_rng(6)
    return {
        "ssd": {name: (ranks, chunk, _ssd_inputs(4 + i, l=l))
                for i, (name, (ranks, chunk, l)) in enumerate(SSD_CASES.items())},
        "image": rng.standard_normal((2, 16, 6, 3)).astype(np.float32),
        "conv1d": {"x": rng.standard_normal((2, 32, 6)).astype(np.float32),
                   "w": rng.standard_normal((4, 6)).astype(np.float32),
                   "b": rng.standard_normal((6,)).astype(np.float32)},
        "encoder": _encoder_cases(),
    }


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory) -> dict:
    """The outputs of `workers.ops_rank` over a gloo world of 4 CPU ranks."""
    out = tmp_path_factory.mktemp("parallel_ops")
    distributed.spawn_world(workers.ops_rank, 4, f"file://{out}/init", "cpu",
                            args=(str(out), _cases()), threads=1)
    return torch.load(out / "outputs.pt", weights_only=False)


# --- in this process ---------------------------------------------------------------


def test_ssd_naive_state_matches_jax():
    inp = _ssd_inputs(0)
    s0 = np.random.default_rng(9).standard_normal((2, 4, 8, 8)).astype(np.float32)
    want_y, want_st = jssd.ssd_naive(*_j(inp, "x", "dt", "A", "B", "C", "D"),
                                     initial_state=jnp.asarray(s0), return_final_state=True)
    y, st = ssd.ssd_naive(*_t(inp, "x", "dt", "A", "B", "C", "D"),
                          initial_state=torch.from_numpy(s0), return_final_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **SSD_TOL)


@pytest.mark.parametrize("l", [64, 40])  # 40: chunk 16 pads 8 tokens, with dt 0
def test_chunked_final_state_matches_naive_and_jax(l):
    inp = _ssd_inputs(1, l=l)
    _, want = jssd.ssd_naive(*_j(inp, "x", "dt", "A", "B", "C", "D"), return_final_state=True)
    y, st = ssd.ssd_chunked(*_t(inp, "x", "dt", "A", "B", "C", "D"), chunk=16,
                            return_final_state=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(want), **SSD_TOL)
    np.testing.assert_array_equal(y.numpy(), ssd.ssd_chunked(
        *_t(inp, "x", "dt", "A", "B", "C", "D"), chunk=16).numpy())


def test_initial_state_chaining_equals_full_scan():
    """Two halves chained through `initial_state` are the full scan."""
    inp = _ssd_inputs(2)
    want = np.asarray(jssd.ssd_naive(*_j(inp, "x", "dt", "A", "B", "C", "D")))
    x, dt, A, B, C, D = _t(inp, "x", "dt", "A", "B", "C", "D")
    y1, st = ssd.ssd_chunked(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], D, chunk=16,
                             return_final_state=True)
    y2 = ssd.ssd_chunked(x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:], D, chunk=16,
                         initial_state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), want, **SSD_TOL)


def test_state_summary_matches_jax_and_is_affine():
    inp = _ssd_inputs(3)
    want_a, want_s = jssd.ssd_state_summary(*_j(inp, "x", "dt", "A", "B", "C"), chunk=16)
    a_tot, s_fin = ssd.ssd_state_summary(*_t(inp, "x", "dt", "A", "B", "C"), chunk=16)
    np.testing.assert_allclose(a_tot.numpy(), np.asarray(want_a), **SSD_TOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), **SSD_TOL)
    s0 = torch.from_numpy(np.random.default_rng(9).standard_normal(s_fin.shape).astype(
        np.float32))
    _, st = ssd.ssd_chunked(*_t(inp, "x", "dt", "A", "B", "C", "D"), chunk=16,
                            initial_state=s0, return_final_state=True)
    np.testing.assert_allclose(st.numpy(), (a_tot[..., None, None] * s0 + s_fin).numpy(),
                               **SSD_TOL)


def test_conv1d_initial_tokens_matches_jax():
    conv = _cases()["conv1d"]
    x, w, b = conv["x"], conv["w"], conv["b"]
    want = jconv.causal_depthwise_conv1d(jnp.asarray(x[:, 16:]), jnp.asarray(w),
                                         jnp.asarray(b), initial_tokens=jnp.asarray(x[:, 13:16]))
    got = causal_depthwise_conv1d(torch.from_numpy(x[:, 16:]), torch.from_numpy(w),
                                  torch.from_numpy(b), initial_tokens=torch.from_numpy(x[:, 13:16]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="k-1"):
        causal_depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                initial_tokens=torch.from_numpy(x[:, :2]))


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
def test_row_halo_pad_one_rank_is_pad2d(mode):
    x = torch.from_numpy(_cases()["image"])
    pad_fn = make_row_halo_pad(mesh.RowAxis())
    assert torch.equal(pad_fn(x, 2, mode), pad2d(x, 2, mode))
    assert pad_fn(x, 0, mode) is x


def test_auto_data_axis():
    assert mesh.auto_data_axis(8, 1, 8) == 8
    assert mesh.auto_data_axis(8, 1, 2) == 2
    assert mesh.auto_data_axis(8, 2, 8) == 4
    assert mesh.auto_data_axis(1, 1, 8) == 1
    assert mesh.auto_data_axis(8, 1, 7) == 7  # ragged device use: 7 of 8
    assert mesh.auto_data_axis(8, 1, 3) == 3


def test_row_axis_without_process_group_and_refusals():
    assert mesh.row_axis() == mesh.RowAxis(1, 0, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh.row_axis(model_axis=2)
    with pytest.raises(ValueError, match="margin=0"):
        make_sharded_apply_rows(lambda n, a: n, 0)


def test_backend_rule_and_bootstrap_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend("cpu", 4) == "gloo"
    assert distributed.choose_backend("cuda", 1) == "nccl"
    assert distributed.choose_backend("cuda", 2) == "gloo"  # two ranks share the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        distributed.rank_device("cuda", 0)
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    for key in ("PHT_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    with pytest.raises(ValueError, match="RANK and WORLD_SIZE"):
        distributed.maybe_initialize_distributed(multihost=True, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="multihost=true"):
        distributed.maybe_initialize_distributed(device="cpu")
    assert distributed.is_main_process() and distributed.process_count() == 1


# --- across ranks ------------------------------------------------------------------


def test_ranks_import_no_jax(ranks_out):
    assert ranks_out["jax_loaded"] is False


def test_a_failing_rank_fails_the_world(tmp_path):
    """A rank's exception reaches the parent, and the rank left waiting in
    a collective is stopped rather than left to time out."""
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        distributed.spawn_world(workers.failing_rank, 2, f"file://{tmp_path}/init", "cpu",
                                args=(str(tmp_path),), threads=1)


@functools.lru_cache(maxsize=None)
def _jax_ssd_sharded(name: str) -> np.ndarray:
    ranks, chunk, inp = _cases()["ssd"][name]
    A, D = _j(inp, "A", "D")

    def f(x, dt, B, C):
        return jssd.ssd_sharded(x, dt, A, B, C, D, axis_name="data", chunk=chunk)

    sx, sdt = P(None, "data", None, None), P(None, "data", None)
    fn = jax.jit(jax.shard_map(f, mesh=_mesh(ranks), in_specs=(sx, sdt, sx, sx),
                               out_specs=sx))
    return np.asarray(fn(*_j(inp, "x", "dt", "B", "C")))


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_sharded_matches_jax_sharded(ranks_out, name):
    np.testing.assert_allclose(ranks_out[f"ssd/{name}"], _jax_ssd_sharded(name), **SSD_TOL)


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_sharded_matches_naive(ranks_out, name):
    inp = _cases()["ssd"][name][2]
    want = np.asarray(jssd.ssd_naive(*_j(inp, "x", "dt", "A", "B", "C", "D")))
    np.testing.assert_allclose(ranks_out[f"ssd/{name}"], want, **SSD_TOL)


@pytest.mark.parametrize("ranks,mode,pad", HALO)
def test_row_halo_pad_matches_jax(ranks_out, ranks, mode, pad):
    def f(x):
        return jpadding.make_row_halo_pad("data")(x, pad, mode)

    spec = P(None, "data", None, None)
    want = jax.jit(jax.shard_map(f, mesh=_mesh(ranks), in_specs=spec, out_specs=spec))(
        jnp.asarray(_cases()["image"]))
    np.testing.assert_allclose(ranks_out[f"halo/{ranks}/{mode}/{pad}"], np.asarray(want),
                               rtol=0, atol=1e-6)


def test_conv1d_across_ranks_matches_unsharded_jax(ranks_out):
    conv = _cases()["conv1d"]
    want = jconv.causal_depthwise_conv1d(*(jnp.asarray(conv[k]) for k in ("x", "w", "b")))
    np.testing.assert_allclose(ranks_out["conv1d"], np.asarray(want), rtol=0, atol=1e-6)


class _JaxLiteralEncoder(fnn.Module):
    """The JAX package's three-branch encoder, literal form (`fold=False`)."""

    mode: str
    pad_fn: object = None

    @fnn.compact
    def __call__(self, x):
        return jafgsa.multi_scale_encode(x, ENCODER["features"], ENCODER["slopes"], self.mode,
                                         False, jnp.float32, 0, pad_fn=self.pad_fn)


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_merged_encoder_exact_at_rank_boundaries(ranks_out, mode):
    """The port's merged 5×5 encoder conv under halo padding at 4 ranks (the
    pad-2 rows are the neighbours' rows; their inner ring the pad-1 rows)
    against the JAX literal encoder under `shard_map` with its halo pad, and
    against the port's encoder on the unsharded frame."""
    enc = _encoder_cases()
    params = {f"ConvBlock_{i}": {"Conv_0": {
        "kernel": jnp.asarray(enc["state"][f"branches.{i}.weight"].transpose(2, 3, 1, 0)),
        "bias": jnp.asarray(enc["state"][f"branches.{i}.bias"])}} for i in range(3)}
    module = _JaxLiteralEncoder(mode, jpadding.make_row_halo_pad("data"))
    spec = P(None, "data", None, None)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax.shard_map(
            lambda x: module.apply({"params": params}, x), mesh=_mesh(4), in_specs=spec,
            out_specs=spec))(jnp.asarray(enc["x"])))
    got = ranks_out[f"encoder/{mode}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    port = MultiScaleEncoder(7, ENCODER["features"], ENCODER["slopes"], mode, torch.float32,
                             None)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in enc["state"].items()})
    with torch.no_grad():
        whole = port(torch.from_numpy(enc["x"])).numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5 * np.abs(whole).max())

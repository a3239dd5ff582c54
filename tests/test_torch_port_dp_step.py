"""PyTorch port: the data-parallel GAN step over gloo CPU ranks against JAX.

Gloo worlds of 2 and 4 CPU ranks (`spawn_world`, one torch thread a rank,
`init_method=file://`) run `tests/torch_port_training_workers.step_rank`:
each rank feeds its `host_batch_bounds` rows of every global batch to the
port's `make_train_step(..., mesh=make_mesh(D, 1))`. The parent holds what
the ranks saved against the JAX `make_train_step` on a `make_mesh(D, 1)`
mesh of the virtual CPU devices and on one device (HIGHEST precision; the
port in float32), from one flax param tree (seeded values, through
`params.py`) and the JAX step's own GP draws:

- WGAN-GP at the geometry of `tests/test_parallel_trainer.py:42`
  (AFGSANet base 32, enc 32, 1 SA, 2 heads; DiscriminatorVGG base_nf 8;
  16² patches; global batch 8; two steps) at D = 2 and 4, on a batch
  alike on every rank and on one whose images double from each quarter of
  the rows to the next:
  losses within rtol 2e-4 / atol 2e-5 (that test's bound), parameters
  within atol 5e-4 (`test_six_step_trajectory_matches_jax_train_step`'s,
  with its exception: a conv bias that feeds a BatchNorm has a gradient of
  zero in exact arithmetic, which Adam turns into ±lr steps of rounding
  noise, so those are not compared). Every rank returns the same losses
  and holds the same parameters, to the bit.
- The multiscale RaHinge step with MS-SSIM and LPIPS (random weights) and
  FiLM, D = 2, global batch 4 of rows growing 16× a row (MS_GROW), against the JAX
  multiscale step: `tests/test_torch_port_multiscale_step.py`'s bounds
  (losses 1e-4 relative at step 0, ×10 per step; parameters 5e-4; `u`
  1e-5).
- The Mamba step (fused route through `MambaChainFn`'s plain versions)
  at `tests/test_torch_port_mamba_train_step.py`'s geometry, D = 2.
- Controls that must fail those bounds, which shows that the comparison
  sees each global reduction: per-rank BatchNorm statistics (the WGAN
  step), a per-rank RaHinge mean and a per-rank LPIPS max (the multiscale
  step), each on the growing rows.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.config import LossesConfig as JLossesConfig  # noqa: E402
from pixel_heal_thyself_tpu.models import lpips as jlpips  # noqa: E402
from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    MultiScaleDiscriminator as JMultiScaleDiscriminator,
)
from pixel_heal_thyself_tpu.models.mamba import MambaDenoiserNet as JMambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu.parallel.mesh import (  # noqa: E402
    batch_sharding,
    make_mesh,
    place_state,
    replicated,
)
from pixel_heal_thyself_tpu.training import train_step as jts  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    discriminator_state_from_flax,
    mamba_state_from_flax,
)
from pixel_heal_thyself_tpu_torch.parallel import distributed  # noqa: E402

import torch_port_training_workers as workers  # noqa: E402
from tests import test_torch_port_mamba_train_step as mamba_test  # noqa: E402
from tests.test_torch_port_multiscale_step import _port_d_state, _spectral  # noqa: E402
from tests.test_torch_port_train_step import _init_state  # noqa: E402

PATCH, BATCH, STEPS = 16, 8, 2
OPT = (1e-4, [2], 0.5, 4)
AFGSA = dict(base_ch=32, enc_ch=32, num_sa=1, num_gcp=0, num_heads=2, padding_mode="replicate")
MS_AFGSA = dict(AFGSA, use_film=True)
MS_BATCH = 4
# the critic's logits must cross RaHinge's hinge for a per-rank mean to
# matter: where 1 ∓ (logit − mean) stays positive, the hinge is linear and
# the ranks' shares of a per-rank mean sum to the global mean's
MS_GROW = 16.0
MS_LOSSES = dict(use_ssim_loss=True, use_lpips_loss=True)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 5e-4
DEADLINE = 300  # seconds for one spawned world


def _batches(seed: int, n: int, batch: int, grow: float = 1.0) -> list:
    """`n` global batches; the images of each quarter of the rows `grow`
    times those of the quarter before, so that per-rank statistics at 2
    and 4 ranks differ from the global ones."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"noisy": np.abs(rng.standard_normal((batch, PATCH, PATCH, 3))),
             "gt": np.abs(rng.standard_normal((batch, PATCH, PATCH, 3))),
             "aux": rng.uniform(-1, 1, (batch, PATCH, PATCH, 7))}
        if grow != 1.0:
            scale = grow ** np.repeat(np.arange(4), batch // 4)
            for key in ("noisy", "gt"):
                b[key] = b[key] * scale[:, None, None, None]
        out.append({k: v.astype(np.float32) for k, v in b.items()})
    return out


def _alphas(n: int, batch: int) -> list:
    """The JAX step's GP draws: uniform from fold_in(PRNGKey(7), step)."""
    rng = jax.random.PRNGKey(7)
    return [np.asarray(jax.random.uniform(jax.random.fold_in(rng, jnp.int32(i)),
                                          (batch, 1, 1, 1), jnp.float32)) for i in range(n)]


def _tree(x):
    return jax.tree.map(np.asarray, x)


def _numpy(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def _setups() -> dict:
    """Per model: the JAX modules, the initial JAX states and the port's
    case (state dicts, kwargs) for the workers."""
    z = jnp.zeros((BATCH, PATCH, PATCH, 3))
    za = jnp.zeros((BATCH, PATCH, PATCH, 7))
    tx = jts.make_optimizer(*OPT)
    out = {}
    g, d = JAFGSANet(**AFGSA), JDiscriminatorVGG(input_size=PATCH, base_nf=8)
    gs, ds = _init_state(g, tx, 0, z, za), _init_state(d, tx, 1, z)
    out["wgan"] = (g, d, gs, ds, dict(
        g="afgsa", g_kwargs=dict(AFGSA, use_kernels=True),
        g_state=_numpy(afgsa_state_from_flax(_tree(gs.params))),
        d_kwargs=dict(input_size=PATCH, base_nf=8),
        d_state=_numpy(discriminator_state_from_flax(_tree(ds.params))),
        multiscale=False, lpips=None, losses={}, opt=OPT))
    g, d = JAFGSANet(**MS_AFGSA), JMultiScaleDiscriminator(in_nc=3, patch_size=PATCH)
    gs, ds = _init_state(g, tx, 0, z, za), _init_state(d, tx, 1, z)
    ds = ds.replace(extra_vars={"spectral": _spectral(d, z, 2)})
    out["ms"] = (g, d, gs, ds, dict(
        g="afgsa", g_kwargs=dict(MS_AFGSA, use_kernels=True),
        g_state=_numpy(afgsa_state_from_flax(_tree(gs.params))),
        d_kwargs=dict(in_nc=3, patch_size=PATCH), d_state=_numpy(_port_d_state(ds)),
        multiscale=True, lpips=0, losses=MS_LOSSES, opt=OPT))
    mb = mamba_test.BATCH
    zm, zma = jnp.zeros((mb, PATCH, PATCH, 3)), jnp.zeros((mb, PATCH, PATCH, 7))
    g = JMambaDenoiserNet(**mamba_test.SMALL, num_gcp=0)
    d = JDiscriminatorVGG(input_size=PATCH, base_nf=mamba_test.D_NF)
    gs, ds = mamba_test._init_state(g, tx, 0, zm, zma), mamba_test._init_state(d, tx, 1, zm)
    out["mamba"] = (g, d, gs, ds, dict(
        g="mamba", g_kwargs=dict(mamba_test.SMALL, num_gcp=0, use_kernels=True,
                                 use_megakernel=True),
        g_state=_numpy(mamba_state_from_flax(_tree(gs.params))),
        d_kwargs=dict(input_size=PATCH, base_nf=mamba_test.D_NF),
        d_state=_numpy(discriminator_state_from_flax(_tree(ds.params))),
        multiscale=False, lpips=None, losses={}, opt=OPT))
    return out


def _data() -> dict:
    """Each comparison: (model, batches, alphas)."""
    return {
        "wgan": ("wgan", _batches(0, STEPS, BATCH), _alphas(STEPS, BATCH)),
        "wgan_grow": ("wgan", _batches(1, STEPS, BATCH, grow=2.0), _alphas(STEPS, BATCH)),
        "ms": ("ms", _batches(2, STEPS, MS_BATCH, grow=MS_GROW), None),
        "mamba": ("mamba", _batches(3, STEPS, mamba_test.BATCH), _alphas(STEPS, mamba_test.BATCH)),
    }


def _cases() -> dict:
    """The workers' cases: name → the port's case with its grid."""
    setups, data = _setups(), _data()
    cases = {}

    def add(name, key, grid, control=None):
        model, batches, alphas = data[key]
        cases[name] = dict(setups[model][4], mesh=grid, batches=batches, alphas=alphas,
                           control=control)

    for ranks in (2, 4):
        add(f"wgan/{ranks}", "wgan", (ranks, 1))
        add(f"wgan_grow/{ranks}", "wgan_grow", (ranks, 1))
        add(f"wgan_grow_bn/{ranks}", "wgan_grow", (ranks, 1), "bn")
    add("ms/2", "ms", (2, 1))
    add("ms_fake_mean/2", "ms", (2, 1), "fake_mean")
    add("ms_lpips_max/2", "ms", (2, 1), "lpips_max")
    add("mamba/2", "mamba", (2, 1))
    return cases


@functools.lru_cache(maxsize=None)
def _jax_run(key: str, data: int) -> dict:
    """The JAX step on a `make_mesh(data, 1)` mesh: losses of each step,
    the final params (and spectral vectors)."""
    model, batches, _ = _data()[key]
    g, d, gs, ds, case = _setups()[model]
    mesh = make_mesh(data_axis=data, model_axis=1, devices=jax.devices()[:data])
    lpips = jlpips.random_lpips_params(0) if case["lpips"] is not None else None
    tx = jts.make_optimizer(*OPT)
    step = jts.make_train_step(g, d, JLossesConfig(**case["losses"]), case["multiscale"], tx, tx,
                               lpips_params=lpips)
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        # copies: the jitted step donates its states
        gs, ds = (place_state(jax.tree.map(np.array, s), mesh) for s in (gs, ds))
        rng = jax.device_put(jax.random.PRNGKey(7), replicated(mesh))
        losses = []
        for batch in batches:
            gs, ds, m = step(gs, ds, {k: jax.device_put(v, batch_sharding(mesh))
                                      for k, v in batch.items()}, rng)
            losses.append([float(m[k]) for k in ("g_loss", "d_loss", "g_gan", "g_l1")])
    finally:
        jax.config.update("jax_default_matmul_precision", None)
    return {"losses": np.asarray(losses), "gs": gs, "ds": ds}


def _want_params(key: str, run: dict) -> tuple[dict, dict]:
    model = _data()[key][0]
    gp = _tree(run["gs"].params)
    if model == "mamba":
        return _numpy(mamba_state_from_flax(gp)), _numpy(
            discriminator_state_from_flax(_tree(run["ds"].params)))
    if model == "ms":
        return _numpy(afgsa_state_from_flax(gp)), _numpy(_port_d_state(run["ds"]))
    return _numpy(afgsa_state_from_flax(gp)), _numpy(
        discriminator_state_from_flax(_tree(run["ds"].params)))


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory) -> dict:
    """Every rank's results of every case, by world size."""
    cases = _cases()
    out = {}
    for ranks in (2, 4):
        tmp = tmp_path_factory.mktemp(f"dp{ranks}")
        mine = {k: v for k, v in cases.items() if v["mesh"][0] * v["mesh"][1] == ranks}
        distributed.spawn_world(workers.step_rank, ranks, f"file://{tmp}/init", "cpu",
                                args=(str(tmp), mine), threads=1, deadline=DEADLINE)
        out[ranks] = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(ranks)]
    return out


def _compared(name: str) -> bool:
    """Whether a parameter is held to the bound: not a conv bias feeding a
    BatchNorm (the module docstring)."""
    return not (name.startswith("blocks.") and name.endswith("conv.bias")
                and name != "blocks.0.conv.bias")


def _param_devs(got_g: dict, got_d: dict, want: tuple, bn_biases: bool) -> dict:
    """Each compared parameter's max abs deviation (`u` buffers apart)."""
    want_g, want_d = want
    devs = {f"g/{k}": float(np.abs(v - want_g[k]).max()) for k, v in got_g.items()}
    devs.update({f"d/{k}": float(np.abs(v - want_d[k]).max()) for k, v in got_d.items()
                 if not bn_biases or _compared(k)})
    return devs


def _check_against_jax(res: dict, key: str, data: int, loss_tol: dict | None = None,
                       u_atol: float = 1e-5) -> None:
    """`res` against the JAX step on a `make_mesh(data, 1)` mesh: the
    losses within `loss_tol` (when given), the parameters within
    PARAM_ATOL, the `u` vectors within `u_atol`."""
    run = _jax_run(key, data)
    if loss_tol is not None:
        np.testing.assert_allclose(res["losses"], run["losses"], **loss_tol)
    devs = _param_devs(res["g"], res["d"], _want_params(key, run), key.startswith("wgan"))
    params = {k: v for k, v in devs.items() if not k.endswith(".u")}
    worst = max(params, key=params.get)
    assert params[worst] <= PARAM_ATOL, f"{worst}: {params[worst]:.3e}"
    us = {k: v for k, v in devs.items() if k.endswith(".u")}
    assert all(v <= u_atol for v in us.values()), us


def test_ranks_import_no_jax(ranks_out):
    assert not any(rec["jax_loaded"] for recs in ranks_out.values() for rec in recs)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("key", ["wgan", "wgan_grow"])
def test_wgan_dp_step_matches_jax_mesh_and_one_device(ranks_out, ranks, key):
    res = ranks_out[ranks][0][f"{key}/{ranks}"]
    _check_against_jax(res, key, ranks, LOSS_TOL)
    _check_against_jax(res, key, 1, LOSS_TOL)


@pytest.mark.parametrize("name", ["wgan/2", "wgan/4", "wgan_grow/2", "wgan_grow/4", "ms/2",
                                  "mamba/2"])
def test_every_rank_returns_the_global_losses_and_holds_equal_params(ranks_out, name):
    recs = ranks_out[int(name.split("/")[1])]
    first = recs[0][name]
    for rec in recs[1:]:
        assert rec[name]["losses"] == first["losses"]
        for part in ("g", "d"):
            for key, value in first[part].items():
                assert np.array_equal(rec[name][part][key], value), f"{part}/{key}"


@pytest.mark.parametrize("ranks", [2, 4])
def test_per_rank_batchnorm_statistics_fail_the_bound(ranks_out, ranks):
    res = ranks_out[ranks][0][f"wgan_grow_bn/{ranks}"]
    run = _jax_run("wgan_grow", ranks)
    rel = np.abs(np.asarray(res["losses"]) - run["losses"]) / (
        LOSS_TOL["atol"] + LOSS_TOL["rtol"] * np.abs(run["losses"]))
    assert rel.max() > 10, f"per-rank statistics within {rel.max():.2f}× the loss bound"


def _ms_loss_tol(step: int) -> float:
    return 1e-4 * 10 ** min(step, 2)


def _ms_check(res: dict, run: dict) -> None:
    for i, (got, want) in enumerate(zip(res["losses"], run["losses"])):
        rel = np.abs(np.asarray(got) - want) / np.maximum(1.0, np.abs(want))
        assert rel.max() <= _ms_loss_tol(i), f"step {i}: {got} vs {want}"


def test_multiscale_dp_step_matches_jax(ranks_out):
    res = ranks_out[2][0]["ms/2"]
    run = _jax_run("ms", 2)
    _ms_check(res, run)
    _check_against_jax(res, "ms", 2)


@pytest.mark.parametrize("control", ["fake_mean", "lpips_max"])
def test_multiscale_per_rank_controls_fail_the_bound(ranks_out, control):
    res = ranks_out[2][0][f"ms_{control}/2"]
    with pytest.raises(AssertionError):
        _ms_check(res, _jax_run("ms", 2))


def test_mamba_dp_step_matches_jax(ranks_out):
    res = ranks_out[2][0]["mamba/2"]
    _check_against_jax(res, "mamba", 2, LOSS_TOL)

"""PyTorch port: tensor parallelism, `parallel.model_axis` > 1, on gloo CPU ranks.

The WGAN-GP step of tests/test_torch_port_dp_step.py (AFGSANet base 32,
1 SA; DiscriminatorVGG base_nf 8; 16² patches; global batch 8; two
steps; the JAX step's GP draws) runs in `tests/torch_port_training_workers.
step_rank` on a D × M grid of gloo CPU ranks (one torch thread a rank):
D=2 × M=1 and D=1 × M=2 in a world of 2 (with one process, no grid, on
rank 0), D=2 × M=2 in a world of 4.

- Each rank's Adam updates only its shards (`parallel.mesh.ParamShards`)
  and the replicated parameters, and holds only their moments: the
  element counts are the sharded parameters' over M plus the replicated.
- D=2 × M=2 equals D=2 × M=1, and D=1 × M=2 equals one process, to the
  bit: losses, parameters and the full Adam states (the moments gathered
  from the shards, as a checkpoint holds them). Adam is elementwise and
  the gathers copy, so sharding changes placement, not results, as GSPMD
  promises for the JAX step (`tests/test_parallel_trainer.py:82-87`).
- Cutting the gathered Adam state back into shards (a restore) gives each
  rank's moments back to the bit.
- D=2 × M=2 matches the JAX step on a 2 × 2 mesh within the DP bound
  (losses rtol 2e-4 / atol 2e-5; parameters 5e-4 but the conv biases that
  feed a BatchNorm).
- The sharding rule: for the AFGSA (FiLM) and Mamba generators and the
  VGG and multiscale critics, each port parameter is sharded, on the dim
  `parallel.mesh.shard_dim` names, exactly where the JAX
  `make_param_shardings` shards its flax leaf over 'model', the two
  mapped through `params.py`.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.config import LossesConfig as JLossesConfig  # noqa: E402
from pixel_heal_thyself_tpu.parallel.mesh import (  # noqa: E402
    batch_sharding,
    make_mesh,
    make_param_shardings,
    place_state,
    replicated,
)
from pixel_heal_thyself_tpu.training import train_step as jts  # noqa: E402
from pixel_heal_thyself_tpu_torch import params as bridge  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import (  # noqa: E402
    DiscriminatorVGG,
    MultiScaleDiscriminator,
)
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel import distributed  # noqa: E402
from pixel_heal_thyself_tpu_torch.parallel import mesh as pmesh  # noqa: E402

import torch_port_training_workers as workers  # noqa: E402
from tests import test_torch_port_dp_step as dp  # noqa: E402
from tests import test_torch_port_mamba_train_step as mamba_test  # noqa: E402

DEADLINE = 300


def _cases() -> dict:
    base = dict(dp._setups()["wgan"][4], batches=dp._batches(0, dp.STEPS, dp.BATCH),
                alphas=dp._alphas(dp.STEPS, dp.BATCH))
    return {"one": dict(base, mesh=None), "2x1": dict(base, mesh=(2, 1)),
            "1x2": dict(base, mesh=(1, 2)), "2x2": dict(base, mesh=(2, 2))}


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory) -> dict:
    cases = _cases()
    out = {}
    for ranks, names in ((2, ("one", "2x1", "1x2")), (4, ("2x2",))):
        tmp = tmp_path_factory.mktemp(f"tp{ranks}")
        distributed.spawn_world(workers.step_rank, ranks, f"file://{tmp}/init", "cpu",
                                args=(str(tmp), {n: cases[n] for n in names}), threads=1,
                                deadline=DEADLINE)
        for r in range(ranks):
            for name, res in torch.load(tmp / f"rank{r}.pt", weights_only=False).items():
                out.setdefault(name, {})[r] = res
    return out


def _equal(a: dict, b: dict) -> None:
    assert a["losses"] == b["losses"]
    for part in ("g", "d"):
        assert a[part].keys() == b[part].keys()
        for name, value in a[part].items():
            assert np.array_equal(b[part][name], value), f"{part}/{name}"
    for part in ("g", "d"):
        assert a["opt"][part].keys() == b["opt"][part].keys()
        for i, state in a["opt"][part].items():
            for key, value in state.items():
                assert np.array_equal(b["opt"][part][i][key], value), f"opt {part}/{i}/{key}"


def test_ranks_import_no_jax(ranks_out):
    assert ranks_out["jax_loaded"] == {0: False, 1: False, 2: False, 3: False}


def test_2x2_equals_2x1_to_the_bit(ranks_out):
    for r in range(4):
        _equal(ranks_out["2x1"][r // 2], ranks_out["2x2"][r])


def test_1x2_equals_one_process_to_the_bit(ranks_out):
    for r in range(2):
        _equal(ranks_out["one"][0], ranks_out["1x2"][r])


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_each_rank_holds_only_its_shards(ranks_out, grid):
    model_axis = int(grid[-1])
    g = AFGSANet(**dp._setups()["wgan"][4]["g_kwargs"])
    d = DiscriminatorVGG(**dp._setups()["wgan"][4]["d_kwargs"])
    for part, module in (("g", g), ("d", d)):
        shardings = pmesh.make_param_shardings(module.named_parameters(), model_axis)
        full = sum(p.numel() for p in module.parameters())
        sharded = sum(p.numel() for n, p in module.named_parameters() if shardings[n] is not None)
        assert sharded > full // 2  # most of the weights are in sharded kernels
        want = full - sharded + sharded // model_axis
        for r, res in ranks_out[grid].items():
            kept = res["kept"][part]
            assert kept["full"] == full
            assert kept["params"] == want, (part, r)
            assert kept["moments"] == 2 * want, (part, r)
            assert res["reloaded"]


def test_2x2_matches_the_jax_2x2_mesh(ranks_out):
    g, d, gs, ds, _ = dp._setups()["wgan"]
    case = _cases()["2x2"]
    mesh = make_mesh(data_axis=2, model_axis=2, devices=jax.devices()[:4])
    tx = jts.make_optimizer(*dp.OPT)
    step = jts.make_train_step(g, d, JLossesConfig(), False, tx, tx)
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        gs, ds = (place_state(jax.tree.map(np.array, s), mesh) for s in (gs, ds))
        rng = jax.device_put(jax.random.PRNGKey(7), replicated(mesh))
        losses = []
        for batch in case["batches"]:
            gs, ds, m = step(gs, ds, {k: jax.device_put(v, batch_sharding(mesh))
                                      for k, v in batch.items()}, rng)
            losses.append([float(m[k]) for k in ("g_loss", "d_loss", "g_gan", "g_l1")])
    finally:
        jax.config.update("jax_default_matmul_precision", None)
    res = ranks_out["2x2"][0]
    np.testing.assert_allclose(res["losses"], losses, **dp.LOSS_TOL)
    want = dp._want_params("wgan", {"gs": gs, "ds": ds})
    devs = dp._param_devs(res["g"], res["d"], want, bn_biases=True)
    worst = max(devs, key=devs.get)
    assert devs[worst] <= dp.PARAM_ATOL, f"{worst}: {devs[worst]:.3e}"


def _index_tree(shapes) -> dict:
    """A flax tree of `shapes` whose elements are 0, 1, 2, … across all
    leaves (float64 keeps every index exact)."""
    count = [0]

    def fill(leaf):
        n = int(np.prod(leaf.shape))
        out = np.arange(count[0], count[0] + n, dtype=np.float64).reshape(leaf.shape)
        count[0] += n
        return out

    return jax.tree.map(fill, shapes)


def _chunks(a: np.ndarray, dim: int, m: int) -> list:
    return [set(c.ravel().tolist()) for c in np.split(a, m, axis=dim)]


@functools.lru_cache(maxsize=None)
def _rule_cases() -> dict:
    """Per model: the flax index tree, JAX's sharded leaves, the port's
    state dict from the bridge and the port module."""
    z, za = jnp.zeros((2, 16, 16, 3)), jnp.zeros((2, 16, 16, 7))
    setups = dp._setups()
    out = {}
    for name, (jmodel, inputs, to_port, module) in {
        "afgsa_film": (setups["ms"][0], (z, za), bridge.afgsa_state_from_flax,
                       AFGSANet(**dp.MS_AFGSA)),
        "mamba": (setups["mamba"][0], (z, za), bridge.mamba_state_from_flax,
                  MambaDenoiserNet(**mamba_test.SMALL, num_gcp=0)),
        "vgg": (setups["wgan"][1], (z,), bridge.discriminator_state_from_flax,
                DiscriminatorVGG(input_size=16, base_nf=8)),
        "multiscale": (setups["ms"][1], (z,), None, MultiScaleDiscriminator(patch_size=16)),
    }.items():
        variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *inputs)
        tree = _index_tree(variables["params"])
        state = (to_port(tree) if to_port else bridge.multiscale_discriminator_state_from_flax(
            tree, jax.tree.map(lambda s: np.zeros(s.shape), variables["spectral"])))
        out[name] = (tree, state, module)
    return out


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("name", ["afgsa_film", "mamba", "vgg", "multiscale"])
def test_sharding_rule_matches_jax(name, model_axis):
    tree, state, module = _rule_cases()[name]
    jmesh = make_mesh(data_axis=1, model_axis=model_axis, devices=jax.devices()[:model_axis])
    specs = make_param_shardings(tree, jmesh)
    leaves = {}  # first index of each flax leaf → (leaf, sharded over 'model')
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(specs)):
        leaves[float(leaf.ravel()[0])] = (leaf, "model" in tuple(spec.spec))
    mine = pmesh.make_param_shardings(module.named_parameters(), model_axis)
    assert set(mine) == {k for k in state if not k.endswith(".u")}
    n_sharded = 0
    for pname, dim in mine.items():
        port = state[pname].numpy()
        leaf, sharded = leaves[float(port.min())]
        assert port.size == leaf.size, pname
        assert (dim is not None) == sharded, pname
        if sharded:
            n_sharded += 1
            assert _chunks(port, dim, model_axis) == _chunks(leaf, -1, model_axis), pname
    assert n_sharded > 0

"""PyTorch port: the GAN train step with the Mamba2 generator, on the CPU.

- The 4-step trajectory: the port's `make_train_step` with a tiny
  fused-route `MambaDenoiserNet` (base_ch 32, 2 blocks, d_state 16,
  headdim 32: d_inner 128, 16² patches: l 256 in chunks of 128, fp32), so
  every layer trains through `MambaChainFn` (the plain emit forward and
  plain backward that K7-emit and K8 are held against on the card),
  against the JAX `make_train_step` with the JAX model, which runs its
  literal chain on the CPU (`models/mamba.py:169-177`); one flax param
  tree for both (`params.mamba_state_from_flax`,
  `discriminator_state_from_flax`), the same batches and GP draws.
  Tolerances are tests/test_torch_port_train_step.py's: losses within 1e-4
  relative at step 0, ×10 per step to 1e-2; final weights within 5e-4.
- One bf16 step, fused route against literal route, from the same state
  with a float32 critic (a bf16 critic re-rolls the GP's rounding, PERF.md
  Findings): losses within 1e-2 relative; every generator gradient within rms
  5e-2 and total mass 5e-2 of its largest magnitude / total. The two routes
  round at different points in bf16: they read rms 3.4e-2, mass 3.9e-2
  here, while the fused route with its inputs one bf16 ulp up reads rms
  6.6e-2, mass 6.7e-2 against itself (per-head dt_bias, A_log and D
  gradients are sums of cancelling terms). chip_smoke.py's phase 8 holds
  the prod step to the same 5e-2 from its own witnesses.
- `num_gcp` 2 gives gradients exactly equal to `num_gcp` 0 (fp32: the
  Function's recompute is deterministic).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.config import LossesConfig as JLossesConfig  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.models.mamba import MambaDenoiserNet as JMambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu.training import train_step as jts  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    discriminator_state_from_flax,
    mamba_state_from_flax,
)
from pixel_heal_thyself_tpu_torch.training.train_step import (  # noqa: E402
    LossesConfig,
    make_optimizer,
    make_train_step,
    multistep_milestone_epochs,
)

PATCH, BATCH, D_NF, N_STEPS = 16, 2, 8, 4
LR, GAMMA, EPOCHS, LR_MILESTONE, STEPS_PER_EPOCH = 1e-4, 0.5, 4, 2, 2
SMALL = dict(base_ch=32, enc_ch=32, num_blocks=2, d_state=16, headdim=32, expansion=4,
             padding_mode="replicate")


def _batches(rng, n):
    return [{
        "noisy": np.abs(rng.standard_normal((BATCH, PATCH, PATCH, 3))).astype(np.float32),
        "gt": np.abs(rng.standard_normal((BATCH, PATCH, PATCH, 3))).astype(np.float32),
        "aux": rng.uniform(-1, 1, (BATCH, PATCH, PATCH, 7)).astype(np.float32),
    } for _ in range(n)]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _fill(rng):
    """Seeded values for a flax param leaf, scaled by its role (BatchNorm
    scale 1, bias 0)."""
    def fill(path, leaf):
        names = [str(k.key) for k in path]
        if names[-2].startswith("BatchNorm"):
            return np.full(leaf.shape, 1.0 if names[-1] == "scale" else 0.0, np.float32)
        if names[-1] == "A_log":
            return rng.uniform(0.0, 1.5, leaf.shape).astype(np.float32)
        if names[-1] == "dt_bias":
            return rng.uniform(-4.0, -1.0, leaf.shape).astype(np.float32)
        if names[-1] in ("scale", "weight", "D"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan = float(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 10.0
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(np.float32)
    return fill


def _init_state(model, tx, seed, *inputs):
    """A JAX `TrainState` whose params have the shapes of `model.init`
    (traced, not run) and seeded values."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)["params"]
    params = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), shapes)
    return jts.TrainState(params=params, opt_state=tx.init(params), extra_vars={},
                          step=jnp.zeros((), jnp.int32))


def test_four_step_trajectory_matches_jax_train_step():
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        milestones = multistep_milestone_epochs(EPOCHS, LR_MILESTONE)
        g_model = JMambaDenoiserNet(**SMALL, num_gcp=0)
        d_model = JDiscriminatorVGG(input_size=PATCH, base_nf=D_NF)
        g_tx = jts.make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        d_tx = jts.make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        zeros = jnp.zeros((BATCH, PATCH, PATCH, 3))
        gstate = _init_state(g_model, g_tx, 0, zeros, jnp.zeros((BATCH, PATCH, PATCH, 7)))
        dstate = _init_state(d_model, d_tx, 1, zeros)
        j_step = jts.make_train_step(g_model, d_model, JLossesConfig(), False, g_tx, d_tx)

        g = MambaDenoiserNet(**SMALL, num_gcp=0, use_kernels=True, use_megakernel=True)
        g.load_state_dict(mamba_state_from_flax(jax.tree.map(np.asarray, gstate.params)))
        assert all(blk.mamba.fused_route(PATCH * PATCH) for blk in g.blocks)
        d = DiscriminatorVGG(input_size=PATCH, base_nf=D_NF)
        d.load_state_dict(discriminator_state_from_flax(jax.tree.map(np.asarray, dstate.params)))
        spec = make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        step = make_train_step(g, d, LossesConfig(), False, spec, spec)

        base_rng = jax.random.PRNGKey(7)
        for i, batch in enumerate(_batches(np.random.default_rng(11), N_STEPS)):
            gstate, dstate, jm = j_step(gstate, dstate,
                                        {k: jnp.asarray(v) for k, v in batch.items()}, base_rng)
            # the jitted step draws alpha from fold_in(rng, gstate.step)
            alpha = np.asarray(jax.random.uniform(
                jax.random.fold_in(base_rng, jnp.int32(i)), (BATCH, 1, 1, 1), jnp.float32))
            tm = step(_torch_batch(batch), alpha=torch.from_numpy(alpha.copy()))
            tol = 1e-4 * 10 ** min(i, 2)
            for key in ("g_loss", "d_loss", "g_l1", "g_gan"):
                want, got = float(jm[key]), float(tm[key])
                rel = abs(got - want) / max(1.0, abs(want))
                assert rel <= tol, f"step {i} {key}: jax={want:.6g} port={got:.6g}"

        final = mamba_state_from_flax(jax.tree.map(np.asarray, gstate.params))
        for name, p in g.state_dict().items():
            np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0, atol=5e-4,
                                       err_msg=name)
    finally:
        jax.config.update("jax_default_matmul_precision", None)


def _one_step_grads(use_megakernel: bool):
    """One bf16 step with a float32 critic from a fixed state; returns
    (losses, G gradients)."""
    g = MambaDenoiserNet(**dict(SMALL, enc_ch=16), num_gcp=0, use_kernels=True,
                         use_megakernel=use_megakernel, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    assert all(blk.mamba.fused_route(PATCH * PATCH) is use_megakernel for blk in g.blocks)
    d = DiscriminatorVGG(input_size=PATCH, base_nf=D_NF, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(1))
    spec = make_optimizer(LR, [2], GAMMA, 100)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    metrics = step(_torch_batch(_batches(np.random.default_rng(3), 1)[0]),
                   alpha=torch.full((BATCH, 1, 1, 1), 0.25))
    # the aux encoder feeds no block and gets no gradient
    return metrics, {n: p.grad.clone() for n, p in g.named_parameters() if p.grad is not None}


def test_fused_route_step_matches_literal_route_bf16():
    m_fused, g_fused = _one_step_grads(True)
    m_lit, g_lit = _one_step_grads(False)
    for key in ("g_loss", "d_loss"):
        want, got = float(m_lit[key]), float(m_fused[key])
        assert abs(got - want) <= 1e-2 * max(1.0, abs(want)), key
    assert g_fused.keys() == g_lit.keys()
    for name, ref in g_lit.items():
        got, ref = g_fused[name].float(), ref.float()
        rms = (got - ref).pow(2).mean().sqrt().item() / (ref.abs().max().item() + 1e-12)
        assert rms < 5e-2, f"{name}: rel rms {rms:.3e}"
        total = ref.abs().sum().item()
        mass = abs(got.abs().sum().item() - total) / (total + 1e-12)
        assert mass < 5e-2, f"{name}: mass dev {mass:.3e}"


def test_num_gcp_gradients_equal_fused_route():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.abs(rng.standard_normal((2, 16, 16, 3))).astype(np.float32))
    a = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 7)).astype(np.float32))
    grads = []
    for num_gcp in (0, 2):
        g = MambaDenoiserNet(**SMALL, num_gcp=num_gcp, use_kernels=True, use_megakernel=True,
                             generator=torch.Generator().manual_seed(0))
        g(x, a).square().mean().backward()
        grads.append({n: p.grad for n, p in g.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    assert any(n.startswith("blocks.1.mamba.") for n in grads[0])
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name

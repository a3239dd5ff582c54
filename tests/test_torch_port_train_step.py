"""PyTorch port: the GAN train step against the JAX package.

- The 6-step trajectory: the port's `make_train_step` and the JAX
  `make_train_step` train the tiny-but-faithful AFGSA GAN of
  tests/test_reference_parity.py:52-68 (fp32, the literal route, replicate
  padding, DiscriminatorVGG with BatchNorm, WGAN-GP with its double
  backward, both Adams with the MultiStep schedule) from the same weights
  (through both bridges), the same batches and the same GP interpolation
  draws. Tolerances are that test's (:387-413): losses within 1e-4
  relative at step 0, loosening ×10 per step to 1e-2 as float32 rounding
  compounds through Adam; final weights within 5e-4. The port's literal
  route goes through `BlockHaloAttentionFn`, i.e. the plain backward that
  K4 is held against on the card.
- One bf16 step of the block route (`TransformerBlockFn`, the plain
  K4/K5/K6 chain on the CPU) against the literal route (autograd through
  plain bf16 ops) from the same state: losses within 1e-2 relative, the
  generator gradients within the rms-centric block-gradient bounds of
  tests/test_block_mega.py:238-260 (rms 2.5e-2, total mass 2e-2) — the two
  routes round at different points in bf16.
- `num_gcp` 2 gives gradients exactly equal to `num_gcp` 0 (fp32, CPU:
  the recompute is deterministic).
- The grad-mode guard of the non-differentiable dispatchers.
- The port's `LossesConfig` defaults equal the JAX schema's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.config import LossesConfig as JLossesConfig  # noqa: E402
from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu.training import train_step as jts  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.block_cuda import pointwise_gemm, weight_grad  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    discriminator_state_from_flax,
)
from pixel_heal_thyself_tpu_torch.training.train_step import (  # noqa: E402
    LossesConfig,
    make_eval_step,
    make_optimizer,
    make_train_step,
    multistep_milestone_epochs,
    multistep_schedule,
)

# tests/test_reference_parity.py:52-68
PATCH, BATCH, CH, HEADS, BLOCK, HALO, NUM_SA, D_NF = 16, 2, 16, 2, 8, 3, 2, 8
LR, GAMMA, EPOCHS, LR_MILESTONE, STEPS_PER_EPOCH, N_STEPS = 1e-4, 0.5, 4, 2, 2, 6
PAD_MODE = "replicate"
G_KW = dict(base_ch=CH, enc_ch=CH, num_sa=NUM_SA, num_gcp=0, num_heads=HEADS,
            block_size=BLOCK, halo_size=HALO, padding_mode=PAD_MODE)


def _batches(rng, n, batch=BATCH, patch=PATCH):
    return [{
        "noisy": np.abs(rng.standard_normal((batch, patch, patch, 3))).astype(np.float32),
        "gt": np.abs(rng.standard_normal((batch, patch, patch, 3))).astype(np.float32),
        "aux": rng.uniform(-1, 1, (batch, patch, patch, 7)).astype(np.float32),
    } for _ in range(n)]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _init_state(model, tx, seed, *inputs):
    """A JAX `TrainState` whose params have the names and shapes of
    `model.init` (traced, not run: running the flax init costs ~11 s on the
    CPU) and seeded values at the torch-default scale: kernels and biases
    U(±1/sqrt(fan_in)), rel-pos embeddings N(0, 1), BatchNorm scale 1 and
    bias 0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)["params"]
    fans = {  # a layer's fan-in, from its kernel
        tuple(str(k.key) for k in path[:-1]): float(np.prod(leaf.shape[:-1]))
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
        if str(path[-1].key) == "kernel"
    }

    def fill(path, leaf):
        names = [str(k.key) for k in path]
        if names[-1] in ("rel_h", "rel_w"):
            return rng.standard_normal(leaf.shape).astype(np.float32)
        if names[-2].startswith("BatchNorm"):
            return np.full(leaf.shape, 1.0 if names[-1] == "scale" else 0.0, np.float32)
        bound = fans[tuple(names[:-1])] ** -0.5
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return jts.TrainState(params=params, opt_state=tx.init(params), extra_vars={},
                          step=jnp.zeros((), jnp.int32))


def test_schedule_matches_jax():
    milestones = multistep_milestone_epochs(12, 3)
    assert milestones == jts.multistep_milestone_epochs(12, 3)
    mine = multistep_schedule(1e-4, milestones, 0.5, 10)
    ref = jts.multistep_schedule(1e-4, milestones, 0.5, 10)
    for count in (0, 19, 20, 21, 49, 50, 80, 200):
        assert mine(count) == pytest.approx(float(ref(count)), rel=1e-6)


def test_losses_config_defaults_match_jax_schema():
    ref = JLossesConfig()
    mine = LossesConfig()
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_six_step_trajectory_matches_jax_train_step():
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        milestones = multistep_milestone_epochs(EPOCHS, LR_MILESTONE)
        g_model = JAFGSANet(**G_KW)
        d_model = JDiscriminatorVGG(input_size=PATCH, base_nf=D_NF)
        g_tx = jts.make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        d_tx = jts.make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        zeros = jnp.zeros((BATCH, PATCH, PATCH, 3))
        gstate = _init_state(g_model, g_tx, 0, zeros, jnp.zeros((BATCH, PATCH, PATCH, 7)))
        dstate = _init_state(d_model, d_tx, 1, zeros)
        j_step = jts.make_train_step(g_model, d_model, JLossesConfig(), False, g_tx, d_tx)

        g = AFGSANet(**G_KW, use_kernels=True)
        g.load_state_dict(afgsa_state_from_flax(jax.tree.map(np.asarray, gstate.params)))
        d = DiscriminatorVGG(input_size=PATCH, base_nf=D_NF)
        d.load_state_dict(discriminator_state_from_flax(jax.tree.map(np.asarray, dstate.params)))
        spec = make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        step = make_train_step(g, d, LossesConfig(), False, spec, spec)

        base_rng = jax.random.PRNGKey(7)
        batches = _batches(np.random.default_rng(11), N_STEPS)
        for i, batch in enumerate(batches):
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

        final = afgsa_state_from_flax(jax.tree.map(np.asarray, gstate.params))
        for name, p in g.state_dict().items():
            np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0, atol=5e-4,
                                       err_msg=name)
        # a conv bias that feeds a BatchNorm has a gradient of exactly zero
        # in exact arithmetic (the norm removes the mean): Adam then
        # normalises float32 rounding noise into ±lr steps in either
        # framework, so those biases are not compared
        final_d = discriminator_state_from_flax(jax.tree.map(np.asarray, dstate.params))
        for name, p in d.state_dict().items():
            if name.endswith("conv.bias") and name != "blocks.0.conv.bias":
                continue
            np.testing.assert_allclose(p.numpy(), final_d[name].numpy(), rtol=0, atol=5e-4,
                                       err_msg=name)
    finally:
        jax.config.update("jax_default_matmul_precision", None)


def _one_step_grads(use_block_kernel: bool):
    """One bf16 train step from a fixed state; returns (losses, G grads)."""
    g = AFGSANet(base_ch=32, enc_ch=16, num_sa=2, num_gcp=0, num_heads=4, padding_mode=PAD_MODE,
                 use_kernels=True, use_block_kernel=use_block_kernel, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0))
    d = DiscriminatorVGG(input_size=16, base_nf=D_NF, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(1))
    assert g.block_route(BATCH, 16, 16) is use_block_kernel
    spec = make_optimizer(LR, [2], GAMMA, 100)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec)
    batch = _torch_batch(_batches(np.random.default_rng(3), 1)[0])
    alpha = torch.full((BATCH, 1, 1, 1), 0.25)
    metrics = step(batch, alpha=alpha)
    return metrics, {n: p.grad.clone() for n, p in g.named_parameters()}


def test_block_route_step_matches_literal_route_bf16():
    m_block, g_block = _one_step_grads(True)
    m_lit, g_lit = _one_step_grads(False)
    for key in ("g_loss", "d_loss"):
        want, got = float(m_lit[key]), float(m_block[key])
        assert abs(got - want) <= 1e-2 * max(1.0, abs(want)), key
    for name, ref in g_lit.items():
        got = g_block[name]
        scale = ref.abs().max().item() + 1e-12
        rms = (got - ref).pow(2).mean().sqrt().item() / scale
        assert rms < 2.5e-2, f"{name}: rel rms {rms:.3e}"
        fdev = abs(got.abs().sum().item() - ref.abs().sum().item()) / (ref.abs().sum().item() + 1e-12)
        assert fdev < 2e-2, f"{name}: fingerprint dev {fdev:.3e}"


@pytest.mark.parametrize("use_block_kernel,dtype", [(False, torch.float32),
                                                     (True, torch.bfloat16)])
def test_num_gcp_gradients_equal(use_block_kernel, dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.abs(rng.standard_normal((2, 16, 16, 3))).astype(np.float32))
    a = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 7)).astype(np.float32))
    grads = []
    for num_gcp in (0, 2):
        g = AFGSANet(base_ch=32, enc_ch=16, num_sa=2, num_gcp=num_gcp, num_heads=4,
                     padding_mode=PAD_MODE, use_kernels=True, dtype=dtype,
                     use_block_kernel=use_block_kernel,
                     generator=torch.Generator().manual_seed(0))
        g(x, a).square().mean().backward()
        grads.append({n: p.grad for n, p in g.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_eval_step_keeps_gt_linear():
    g = AFGSANet(**G_KW, generator=torch.Generator().manual_seed(0))
    batch = _torch_batch(_batches(np.random.default_rng(5), 1)[0])
    out, noisy, gt = make_eval_step(g)(batch)
    assert out.shape == (BATCH, PATCH, PATCH, 3) and out.grad_fn is None
    assert torch.equal(gt, batch["gt"])
    torch.testing.assert_close(noisy, torch.log1p(batch["noisy"]))


def test_dispatchers_refuse_autograd_in_grad_mode():
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    w = torch.randn(8, 8)
    with pytest.raises(RuntimeError, match="not differentiable"):
        pointwise_gemm(x, w)
    with pytest.raises(RuntimeError, match="not differentiable"):
        weight_grad(x, x)
    with torch.no_grad():
        assert pointwise_gemm(x, w).shape == (2, 4, 4, 8)


def test_multiscale_step_is_not_ported():
    """Once unported, the multiscale step builds and runs now: two steps of
    the RaHinge step against `MultiScaleDiscriminator` with MS-SSIM and
    LPIPS(random) give finite losses, train G and D and write every u
    once a step (tests/test_torch_port_multiscale_step.py holds the step
    against the JAX package)."""
    from pixel_heal_thyself_tpu_torch.models.discriminators import MultiScaleDiscriminator
    from pixel_heal_thyself_tpu_torch.models.lpips import random_lpips_params

    g = AFGSANet(**G_KW, generator=torch.Generator().manual_seed(0))
    d = MultiScaleDiscriminator(patch_size=PATCH, generator=torch.Generator().manual_seed(1))
    spec = make_optimizer(LR, [2], GAMMA, 100)
    cfg = LossesConfig(use_ssim_loss=True, use_lpips_loss=True)
    step = make_train_step(g, d, cfg, True, spec, spec, lpips_params=random_lpips_params())
    u0 = {k: v.clone() for k, v in d.state_dict().items() if k.endswith(".u")}
    g0 = {k: v.clone() for k, v in g.state_dict().items()}
    for batch in _batches(np.random.default_rng(9), 2):
        metrics = step(_torch_batch(batch))
        assert all(torch.isfinite(v) for v in metrics.values())
    # (a 1-channel head's u is ±1 and stays so)
    moved = [not torch.equal(d.state_dict()[k], u) for k, u in u0.items() if u.numel() > 1]
    assert len(u0) == 6 and len(moved) == 3 and all(moved)
    assert any(not torch.equal(g.state_dict()[k], v) for k, v in g0.items())

"""PyTorch port: the multiscale GAN step with MS-SSIM and LPIPS against JAX.

A 4-step trajectory: the port's `make_train_step` and the JAX
`make_train_step` with `use_multiscale=True`, `use_ssim_loss` and
`use_lpips_loss` (random LPIPS weights, `random_lpips_params(0)`, the same
arrays in both) train the tiny AFGSA generator of
tests/test_torch_port_train_step.py with FiLM on (fp32, the literal route
through `BlockHaloAttentionFn`, replicate padding) against
`MultiScaleDiscriminator` (three spectral-norm PatchGANs; RaHinge for D
and G, no GP), from the same weights and spectral-norm vectors (through
`params.py`) on the same batches. Tolerances are that test's: losses
within 1e-4 relative at step 0, loosening ×10 per step to 1e-2; after
every step every G and D parameter within 5e-4, and every SNConv's `u`,
written once a step by the D step's fake forward alone, within 1e-5 (a
unit vector from one power iteration).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.config import LossesConfig as JLossesConfig  # noqa: E402
from pixel_heal_thyself_tpu.models import lpips as jlpips  # noqa: E402
from pixel_heal_thyself_tpu.models.afgsa import AFGSANet as JAFGSANet  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    MultiScaleDiscriminator as JMultiScaleDiscriminator,
)
from pixel_heal_thyself_tpu.training import train_step as jts  # noqa: E402
from pixel_heal_thyself_tpu_torch.models import lpips  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.discriminators import (  # noqa: E402
    MultiScaleDiscriminator,
)
from pixel_heal_thyself_tpu_torch.params import (  # noqa: E402
    afgsa_state_from_flax,
    multiscale_discriminator_state_from_flax,
)
from pixel_heal_thyself_tpu_torch.training.train_step import (  # noqa: E402
    LossesConfig,
    make_optimizer,
    make_train_step,
    multistep_milestone_epochs,
)
from tests.test_torch_port_train_step import (  # noqa: E402
    BATCH,
    EPOCHS,
    G_KW,
    GAMMA,
    LR,
    LR_MILESTONE,
    PATCH,
    STEPS_PER_EPOCH,
    _batches,
    _init_state,
    _torch_batch,
)

N_STEPS = 4


def _spectral(dmodel, x, seed) -> dict:
    """The `spectral` collection of `dmodel`, each u a seeded unit vector."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(dmodel.init, jax.random.PRNGKey(0), x)["spectral"]

    def unit(leaf):
        u = rng.standard_normal(leaf.shape)
        return (u / np.linalg.norm(u)).astype(np.float32)

    return jax.tree.map(unit, shapes)


def _port_d_state(dstate) -> dict:
    return multiscale_discriminator_state_from_flax(
        jax.tree.map(np.asarray, dstate.params),
        jax.tree.map(np.asarray, dstate.extra_vars["spectral"]))


def test_four_step_multiscale_ssim_lpips_trajectory_matches_jax():
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        milestones = multistep_milestone_epochs(EPOCHS, LR_MILESTONE)
        g_model = JAFGSANet(**G_KW, use_film=True)
        d_model = JMultiScaleDiscriminator(in_nc=3, patch_size=PATCH)
        g_tx = jts.make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        d_tx = jts.make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        zeros = jnp.zeros((BATCH, PATCH, PATCH, 3))
        gstate = _init_state(g_model, g_tx, 0, zeros, jnp.zeros((BATCH, PATCH, PATCH, 7)))
        dstate = _init_state(d_model, d_tx, 1, zeros)
        dstate = dstate.replace(extra_vars={"spectral": _spectral(d_model, zeros, 2)})
        j_cfg = JLossesConfig(use_ssim_loss=True, use_lpips_loss=True)
        j_step = jts.make_train_step(g_model, d_model, j_cfg, True, g_tx, d_tx,
                                     lpips_params=jlpips.random_lpips_params(0))

        g = AFGSANet(**G_KW, use_film=True, use_kernels=True)
        g.load_state_dict(afgsa_state_from_flax(jax.tree.map(np.asarray, gstate.params)))
        d = MultiScaleDiscriminator(in_nc=3, patch_size=PATCH)
        d.load_state_dict(_port_d_state(dstate))
        spec = make_optimizer(LR, milestones, GAMMA, STEPS_PER_EPOCH)
        step = make_train_step(g, d, LossesConfig(use_ssim_loss=True, use_lpips_loss=True),
                               True, spec, spec, lpips_params=lpips.random_lpips_params(0))

        rng = jax.random.PRNGKey(7)
        u_prev = {k: v.clone() for k, v in d.state_dict().items() if k.endswith(".u")}
        for i, batch in enumerate(_batches(np.random.default_rng(13), N_STEPS)):
            gstate, dstate, jm = j_step(gstate, dstate,
                                        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
            tm = step(_torch_batch(batch))
            tol = 1e-4 * 10 ** min(i, 2)
            for key in ("g_loss", "d_loss", "g_l1", "g_gan"):
                want, got = float(jm[key]), float(tm[key])
                assert abs(got - want) / max(1.0, abs(want)) <= tol, (
                    f"step {i} {key}: jax={want:.6g} port={got:.6g}")
            want_g = afgsa_state_from_flax(jax.tree.map(np.asarray, gstate.params))
            for name, p in g.state_dict().items():
                np.testing.assert_allclose(p.numpy(), want_g[name].numpy(), rtol=0, atol=5e-4,
                                           err_msg=f"step {i} {name}")
            want_d = _port_d_state(dstate)
            for name, p in d.state_dict().items():
                atol = 1e-5 if name.endswith(".u") else 5e-4
                np.testing.assert_allclose(p.numpy(), want_d[name].numpy(), rtol=0, atol=atol,
                                           err_msg=f"step {i} {name}")
            # every u was written (those of more than one channel moved)
            for name, u in u_prev.items():
                assert u.numel() == 1 or not torch.equal(d.state_dict()[name], u), name
            u_prev = {k: d.state_dict()[k].clone() for k in u_prev}
    finally:
        jax.config.update("jax_default_matmul_precision", None)


def test_d_step_writes_u_once_from_the_old_u():
    """One step's u is one power iteration from the u before the step
    with the weights before the D update (the fake forward's), not two
    (the real forward must not write) and not from the updated weights."""
    torch.manual_seed(0)
    g = AFGSANet(**G_KW, generator=torch.Generator().manual_seed(0))
    d = MultiScaleDiscriminator(patch_size=PATCH, generator=torch.Generator().manual_seed(1))
    spec = make_optimizer(LR, [2], GAMMA, 100)
    step = make_train_step(g, d, LossesConfig(), True, spec, spec)
    convs = dict(d.named_modules())
    before = {name: (m.weight.detach().clone(), m.u.clone())
              for name, m in convs.items() if hasattr(m, "update_u")}
    step(_torch_batch(_batches(np.random.default_rng(3), 1)[0]))
    for name, (w, u) in before.items():
        w = w.reshape(w.shape[0], -1)
        v = w.t() @ u
        v = v / v.norm().clamp(min=1e-12)
        u_new = w @ v
        u_new = u_new / u_new.norm().clamp(min=1e-12)
        torch.testing.assert_close(convs[name].u, u_new, rtol=0, atol=1e-6, msg=name)

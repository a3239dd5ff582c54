"""The port's bf16 WGAN-GP critic step against the JAX package's, on the CPU.

One flax parameter set of a narrow `DiscriminatorVGG` (input 32, base_nf
16; flax's own init at a seed) reaches the port through the bridge; the
same `gt`, `fake` and `alpha` (numpy, from the seed) go through the D step
of each package twice, with the critic in bf16 and in float32
(`tests/torch_port_critic_yardstick.py` for JAX, `tools.critic_numerics`
for the port). Over 4 seeds, the port's bf16-vs-f32 deviation must be at
most 2× the JAX package's for the GP's input-gradient norms (mean relative
error), the D-loss parts (the rms over loss_real, loss_fake, gp and d_loss
of each part's relative error: one rounding can move a single scalar
either way), D's parameter gradient (rms relative over all leaves) and the
adversarial gradient to G. This is what caught PyTorch's own conv double
backward in bf16 (oneDNN: the GP's weight term of every stride-1 conv lost
whole, D's gradient rms 33% from float32 against JAX's 14%), which the
critic now avoids through `models.layers.Conv2dFn`.

Also: `Conv2dFn` against `F.conv2d` to first and second order in float32;
the JAX helper's GP norms against the JAX `gradient_penalty`;
`critic_numerics.run(device="cpu")` against a hand computation on one tiny
critic; and the trainer's TF32 switch, set both ways by precision, and its
float32 WGAN-GP critic.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pixel_heal_thyself_tpu.losses import gradient_penalty as jgradient_penalty  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG  # noqa: E402
from pixel_heal_thyself_tpu_torch.models.layers import Conv2dFn  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops.transforms import prepare_batch  # noqa: E402
from pixel_heal_thyself_tpu_torch.params import discriminator_state_from_flax  # noqa: E402
from pixel_heal_thyself_tpu_torch.tools import critic_numerics as cn  # noqa: E402
from pixel_heal_thyself_tpu_torch.training import trainer as trainer_mod  # noqa: E402
from tests.torch_port_critic_yardstick import (  # noqa: E402
    flax_params_from_port,
    jax_deviation,
    jax_gp_norms,
)

SIZE, NF, BATCH = 32, 16, 8
PARTS = ("loss_real", "loss_fake", "gp", "d_loss")


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


@pytest.fixture(autouse=True)
def _two_threads():
    """torch on 2 threads: the bf16 convs' double backward on all cores
    of each of the tier-1 run's workers oversubscribes the CPU ~50×."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    gt = np.abs(rng.standard_normal((BATCH, SIZE, SIZE, 3))).astype(np.float32)
    fake = (gt + 0.2 * rng.standard_normal(gt.shape)).astype(np.float32)
    alpha = rng.uniform(size=(BATCH, 1, 1, 1)).astype(np.float32)
    return {"gt": gt, "fake": fake, "alpha": alpha}


def _summary(dev: dict) -> dict:
    parts = np.array([dev["losses"][k]["rel_err"] for k in PARTS])
    return {"gp_norm": dev["gp_norm"]["mean_rel_err"],
            "loss_parts": float(np.sqrt(np.mean(parts**2))),
            "d_grad": dev["d_grad"]["overall"], "g_grad": dev["g_grad"]}


@pytest.mark.parametrize("seed", range(4))
def test_bf16_critic_deviation_within_twice_jax(seed):
    inputs = _inputs(seed)
    jmodel = JDiscriminatorVGG(input_size=SIZE, base_nf=NF)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(inputs["gt"]))["params"]
    want = _summary(jax_deviation(params, inputs, SIZE, NF))
    critic = DiscriminatorVGG(3, NF, SIZE, dtype=torch.bfloat16)
    critic.load_state_dict(discriminator_state_from_flax(params))
    rows = cn.measure(critic, {k: torch.from_numpy(v) for k, v in inputs.items()}, ("trainer",))
    got = _summary(rows["rows"]["trainer"])
    for key, value in got.items():
        assert 0 < want[key] and value <= 2 * want[key], (key, got, want)
    # the bf16 critic does round: the comparison is not between zeros
    assert want["d_grad"] > 1e-2


def test_flax_params_from_port_inverts_the_bridge():
    critic = DiscriminatorVGG(3, NF, SIZE, generator=torch.Generator().manual_seed(3))
    back = discriminator_state_from_flax(flax_params_from_port(critic.state_dict()))
    for name, val in critic.state_dict().items():
        assert torch.equal(back[name], val), name


def test_jax_gp_norms_is_the_jax_gradient_penalty():
    inputs = _inputs(7)
    jmodel = JDiscriminatorVGG(input_size=SIZE, base_nf=NF)
    params = jmodel.init(jax.random.PRNGKey(7), jnp.asarray(inputs["gt"]))["params"]
    key = jax.random.PRNGKey(11)
    alpha = jax.random.uniform(key, (BATCH, 1, 1, 1), jnp.float32)  # as the JAX GP draws it

    def d_apply(x):
        return jmodel.apply({"params": params}, x)

    gt, fake = jnp.asarray(inputs["gt"]), jnp.asarray(inputs["fake"])
    norms = jax_gp_norms(d_apply, gt, fake, alpha)
    np.testing.assert_allclose(float(jnp.mean((norms - 1.0) ** 2)),
                               float(jgradient_penalty(d_apply, gt, fake, key)), rtol=1e-6)


@pytest.mark.parametrize("stride,size,k", [(1, 11, 3), (2, 12, 4), (2, 11, 4)])
def test_conv2d_fn_matches_conv2d_to_second_order(stride, size, k):
    rng = np.random.default_rng(stride + size)
    x0 = torch.from_numpy(rng.standard_normal((2, 5, size, size)))
    w0 = torch.from_numpy(rng.standard_normal((6, 5, k, k)) * 0.2)
    v = None
    results = []
    for conv in (lambda x, w: F.conv2d(x, w, stride=stride),
                 lambda x, w: Conv2dFn.apply(x, w, F.conv2d(x.detach(), w, stride=stride), stride)):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y = conv(x, w)
        if v is None:
            v = torch.from_numpy(rng.standard_normal(y.shape))
        (gx,) = torch.autograd.grad((y.tanh() * v).sum(), x, create_graph=True)
        loss = (gx.square().sum() - 1) ** 2 + (y * v).sum()
        gw_first = torch.autograd.grad((y * v).sum(), w, retain_graph=True)[0]
        loss.backward()
        results.append((y.detach(), gx.detach(), gw_first, x.grad, w.grad))
    for want, got in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_critic_numerics_run_matches_hand_computation():
    critic = DiscriminatorVGG(3, 4, 16, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(2)
    batch = {"noisy": np.abs(rng.standard_normal((4, 16, 16, 3))).astype(np.float32),
             "gt": np.abs(rng.standard_normal((4, 16, 16, 3))).astype(np.float32),
             "aux": rng.standard_normal((4, 16, 16, 7)).astype(np.float32)}

    def gen(noisy, aux):
        return noisy * 0.9 + 0.1 * aux[..., :3]

    result = cn.run(critic=critic, gen=gen, batch=batch, device="cpu", log=lambda _: None)
    assert set(result["rows"]) == {"f32_critic_tf32", "repeat", "trainer", "trainer_critic"}
    # the critic itself, in its own dtype: bf16 here, float32 as the trainer builds it
    assert result["rows"]["trainer_critic"] == result["rows"]["trainer"]
    assert result["critic"]["dtype"] == "bfloat16"
    as_trained = cn.run(critic=cn.with_dtype(critic, torch.float32), gen=gen, batch=batch,
                        device="cpu", log=lambda _: None)
    assert as_trained["rows"]["trainer_critic"] == as_trained["rows"]["f32_critic_tf32"]
    assert result["rows"]["repeat"]["d_grad"]["overall"] == 0.0  # the CPU repeats its bits

    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    noisy, gt, aux = prepare_batch(t["noisy"], t["gt"], t["aux"])
    fake = gen(noisy, aux)
    alpha = torch.rand((4, 1, 1, 1), generator=torch.Generator().manual_seed(cn.SEED))
    assert result["inputs"]["alpha"] == alpha.flatten().tolist()

    def by_hand(dtype):
        d = DiscriminatorVGG(3, 4, 16, dtype=dtype)
        d.load_state_dict(critic.state_dict())
        loss_real, loss_fake = -d(gt).mean(), d(fake).mean()
        interp = (alpha * fake + (1 - alpha) * gt).requires_grad_(True)
        (g,) = torch.autograd.grad(d(interp).sum(), interp, create_graph=True)
        norms = g.reshape(4, -1).norm(dim=1)
        gp = ((norms - 1) ** 2).mean()
        d_loss = (loss_fake + loss_real) / 2 + 10.0 * gp
        d_loss.backward()
        return norms.detach(), {"loss_real": loss_real.item(), "loss_fake": loss_fake.item(),
                                "gp": gp.item(), "d_loss": d_loss.item()}, \
            {n: p.grad for n, p in d.named_parameters()}

    n16, l16, g16 = by_hand(torch.bfloat16)
    n32, l32, g32 = by_hand(torch.float32)
    row = result["rows"]["trainer"]
    rel = (n16.double() - n32.double()).abs() / n32.double()
    assert row["gp_norm"]["mean_rel_err"] == pytest.approx(rel.mean().item(), rel=1e-9)
    assert row["gp_norm"]["max_rel_err"] == pytest.approx(rel.max().item(), rel=1e-9)
    for k in PARTS:
        assert row["losses"][k]["value"] == pytest.approx(l16[k], rel=1e-9), k
        assert row["losses"][k]["ref"] == pytest.approx(l32[k], rel=1e-9), k
    num = sum((g16[k].double() - g32[k].double()).square().sum() for k in g32)
    den = sum(g32[k].double().square().sum() for k in g32)
    assert row["d_grad"]["overall"] == pytest.approx((num / den).sqrt().item(), rel=1e-9)


@pytest.mark.parametrize("precision,tf32", [("bf16", True), ("fp32", False)])
def test_card_arithmetic_set_both_ways(tmp_cwd, precision, tf32):
    from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
    from pixel_heal_thyself_tpu_torch.config.run_dirs import register_run_dirs_resolver
    from pixel_heal_thyself_tpu_torch.models.discriminators import GP_CRITIC_DTYPE

    register_run_dirs_resolver()
    cfg = ConfigRegistry.create_config(compose("ci", [
        f"trainer.precision={precision}", "data.patches.patch_size=16",
        f"paths.output_dir={tmp_cwd}"]))
    before = cn.switches_now()
    try:
        cn.set_switches({"tf32": not tf32})
        trainer = trainer_mod.AFGSATrainer(cfg, device="cpu")
        assert cn.switches_now()["tf32"] is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert GP_CRITIC_DTYPE == torch.float32
        assert trainer.create_discriminator().dtype == torch.float32
        # a diagnostic run's arguments replace both
        trainer = trainer_mod.AFGSATrainer(cfg, device="cpu", critic_dtype=torch.bfloat16,
                                           tf32=not tf32)
        assert cn.switches_now()["tf32"] is (not tf32)
        assert trainer.create_discriminator().dtype == torch.bfloat16
    finally:
        cn.set_switches(before)

"""The JAX package's bf16-vs-f32 deviation of the WGAN-GP critic step: the
yardstick for the port's (`pixel_heal_thyself_tpu_torch.tools.
critic_numerics`), on the CPU.

`jax_d_step_parts` runs the JAX package's D step parts (its
`DiscriminatorVGG`, `gan_loss`, and `gradient_penalty`'s norms with a given
interpolation draw) in the structure of `critic_numerics.d_step_parts`, so
that `critic_numerics.deviation` compares either package's bf16 critic with
its own float32 critic. `tests/test_torch_port_critic_bf16.py` uses it on
narrow critics; as a script it measures the prod critic:

    JAX_PLATFORMS=cpu python tests/torch_port_critic_yardstick.py INPUTS.npz \\
        [--checkpoint RUN/model_epochN/state] [--out F.json]

INPUTS.npz holds `gt`, `fake` and `alpha` as `critic_numerics
--save-inputs` writes them; the critic is the port's prod critic at the
trainer's seeded init (or the checkpoint's D), bridged to flax parameters.
It prints the JAX package's deviation beside the port's on the CPU for the
same critic and inputs, as one JSON object.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pixel_heal_thyself_tpu.losses import gan_loss as jgan_loss  # noqa: E402
from pixel_heal_thyself_tpu.models.discriminators import (  # noqa: E402
    DiscriminatorVGG as JDiscriminatorVGG,
)
from pixel_heal_thyself_tpu_torch.params import discriminator_state_from_flax  # noqa: E402
from pixel_heal_thyself_tpu_torch.tools import critic_numerics  # noqa: E402


def flax_params_from_port(state: dict) -> dict:
    """A port `DiscriminatorVGG` state dict → the flax `params` tree
    (the inverse of `params.discriminator_state_from_flax`)."""
    tree: dict = {}
    for key, val in state.items():
        a = val.detach().float().cpu().numpy()
        parts = key.split(".")
        if parts[0] == "blocks":
            node = tree.setdefault(f"ConvBlock_{parts[1]}", {})
            if parts[2] == "conv":
                conv = node.setdefault("Conv_0", {})
                conv["kernel" if parts[3] == "weight" else "bias"] = (
                    np.transpose(a, (2, 3, 1, 0)) if parts[3] == "weight" else a)
            else:
                node.setdefault("BatchNorm2d_0", {})[parts[3]] = a
        else:
            dense = tree.setdefault(f"Dense_{parts[0][-1]}", {})
            dense["kernel" if parts[1] == "weight" else "bias"] = a.T if parts[1] == "weight" else a
    return tree


def jax_gp_norms(d_apply, real_data, fake_data, alpha):
    """The per-sample norms of the JAX `gradient_penalty`
    (`pixel_heal_thyself_tpu/losses.py`), with the interpolation weights
    `alpha` given instead of drawn: the same lines, stopped before the
    mean."""
    interp = alpha * jax.lax.stop_gradient(fake_data) + (1 - alpha) * real_data

    def critic_sum(x):
        return jnp.sum(d_apply(x).astype(jnp.float32))

    grads = jax.grad(critic_sum)(interp)
    grads = grads.reshape(grads.shape[0], -1).astype(jnp.float32)
    return jnp.linalg.norm(grads, axis=1)


@functools.lru_cache(maxsize=None)
def make_jax_d_step(input_size: int, base_nf: int, dtype, gp_w: float = 10.0):
    """A jitted `(params, gt, fake, alpha) → (losses, norms, d_grads,
    g_grad)` of the JAX package's WGAN-GP D step (as its train step's
    `d_loss_fn`) and G's adversarial gradient through the same critic."""
    model = JDiscriminatorVGG(input_size=input_size, base_nf=base_nf, dtype=dtype)

    def d_apply(params, x):
        return model.apply({"params": params}, x)

    def d_loss_fn(params, gt, fake, alpha):
        pred_fake = d_apply(params, fake)
        pred_real = d_apply(params, gt)
        loss_real = jgan_loss(pred_real, True, "wgan")
        loss_fake = jgan_loss(pred_fake, False, "wgan")
        norms = jax_gp_norms(lambda x: d_apply(params, x), gt, fake, alpha)
        gp = jnp.mean((norms - 1.0) ** 2)
        d_loss = (loss_fake + loss_real) / 2.0 + gp_w * gp
        gap = jnp.mean(pred_real.astype(jnp.float32)) - jnp.mean(pred_fake.astype(jnp.float32))
        return d_loss, {"loss_real": loss_real, "loss_fake": loss_fake, "gp": gp,
                        "d_loss": d_loss, "gap": gap, "norms": norms}

    @jax.jit
    def step(params, gt, fake, alpha):
        (_, aux), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(params, gt, fake, alpha)
        g_grad = jax.grad(lambda out: jgan_loss(d_apply(params, out), True, "wgan"))(fake)
        return aux, d_grads, g_grad

    return step


def jax_d_step_parts(step, params: dict, inputs: dict) -> dict:
    """`step`'s outputs in `critic_numerics.d_step_parts`' structure (port
    parameter names, OIHW gradients), from numpy or torch `inputs`."""
    args = [jnp.asarray(np.asarray(inputs[k], np.float32)) for k in ("gt", "fake", "alpha")]
    aux, d_grads, g_grad = step(params, *args)
    grads = {k: v.double() for k, v in discriminator_state_from_flax(d_grads).items()}
    return {"losses": {k: float(aux[k]) for k in ("loss_real", "loss_fake", "gp", "d_loss", "gap")},
            "norms": torch.from_numpy(np.array(aux["norms"], np.float64)),
            "d_grad": grads, "g_grad": torch.from_numpy(np.array(g_grad, np.float32))}


def jax_deviation(params: dict, inputs: dict, input_size: int, base_nf: int) -> dict:
    """The JAX package's bf16 critic against its float32 critic
    (`critic_numerics.deviation`) for `params` and `inputs`."""
    ref = jax_d_step_parts(make_jax_d_step(input_size, base_nf, jnp.float32), params, inputs)
    got = jax_d_step_parts(make_jax_d_step(input_size, base_nf, jnp.bfloat16), params, inputs)
    return critic_numerics.deviation(got, ref)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("inputs", help="npz of gt, fake, alpha (critic_numerics --save-inputs)")
    parser.add_argument("--checkpoint", default=None, help="a trainer checkpoint directory: its D")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    with np.load(args.inputs) as f:
        inputs = {k: f[k] for k in ("gt", "fake", "alpha")}
    state = None
    if args.checkpoint:
        state = torch.load(Path(args.checkpoint) / "checkpoint.pt", map_location="cpu",
                           weights_only=True)["d"]
    critic = critic_numerics.prod_critic("cpu", state)
    params = flax_params_from_port(critic.state_dict())
    size, nf = critic_numerics.PATCH, 64
    tinputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    result = {
        "inputs": args.inputs, "checkpoint": args.checkpoint,
        "critic_checksum": float(sum(p.double().sum().item() for p in critic.parameters())),
        "jax": jax_deviation(params, inputs, size, nf),
        "port_cpu": critic_numerics.measure(critic, tinputs, ("trainer",))["rows"]["trainer"],
    }
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    for name in ("jax", "port_cpu"):
        row = result[name]
        gp, losses = row["gp_norm"], row["losses"]
        print(f"{name}: gp norms mean {gp['mean_rel_err']:.4e} max {gp['max_rel_err']:.4e}; "
              f"d_loss rel {losses['d_loss']['rel_err']:.4e}; gap abs "
              f"{losses['gap']['abs_err']:.4e}; D grad {row['d_grad']['overall']:.4e}; "
              f"G grad {row['g_grad']:.4e}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()

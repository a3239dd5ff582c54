"""Import trained reference checkpoints (`G.pt`, `D.pt`) into the port.

    python -m pixel_heal_thyself_tpu_torch.tools.import_torch_checkpoint \
        --model {afgsa,mamba,discriminator_vgg} --g G.pt --out PATH [--use-film]

Port of the JAX package's `tools/import_torch_checkpoint.py`. The
reference saves `torch.save(model.state_dict(), ".../G.pt")` (and `D.pt`)
each epoch. This tool maps such a state dict onto the port's modules and
writes it with `training.checkpoints.save_params`, the params file that
`trainer.model_path=PATH` takes in `python -m
pixel_heal_thyself_tpu_torch.inference` and `tools.export_model`. It is a
file conversion on the host: nothing runs on a device.

The mapping is the JAX tool's, in two steps: the reference state dict →
the flax param tree (`convert_*`, copies of the JAX tool's converters,
numpy only) → the port's state dict through the weights bridge the tests
hold against the JAX models (`params.afgsa_state_from_flax`,
`mamba_state_from_flax`, `discriminator_state_from_flax`). Reference keys
with no counterpart are dropped (`_DROPPED`): the curve buffers (a
numerical no-op), `pos_encoder.pe` (recomputed), BatchNorm running stats
(the critic's BatchNorm is per-batch) and `attention.alpha` (dead in the
reference). Any other key the mapping does not take raises `KeyError`.
The critic's first Linear is permuted from the reference's NCHW flatten
order to NHWC.

`--num-gcp` only names flax subtrees (`Checkpoint*Block_i`); the port's
names do not depend on it, so it is accepted and ignored.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np


def _conv_w(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [Co, Ci, kh, kw] → flax Conv [kh, kw, Ci, Co]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value, np.float32)


# the AFGSANet / MambaDenoiserNet skeleton shared by both generators
_ENCODER_DECODER = {
    "conv1": "ConvBlock_0",
    "conv3": "ConvBlock_1",
    "conv5": "ConvBlock_2",
    "conv_map": "ConvBlock_3",
    "conv_a1": "ConvBlock_4",
    "conv_a3": "ConvBlock_5",
    "conv_a5": "ConvBlock_6",
    "conv_aenc1": "ConvBlock_7",
    "conv_aenc2": "ConvBlock_8",
    "decoder.0": "ConvBlock_9",
    "decoder.1": "ConvBlock_10",
    "decoder.2": "ConvBlock_11",
}

_DROPPED = re.compile(
    r"\.(curve_indices|inv_curve_indices)$|^pos_encoder\.pe$"
    r"|\.(running_mean|running_var|num_batches_tracked)$"
    r"|\.attention\.alpha$",
)


def _blocks(sd: dict, prefix: str) -> list[int]:
    return sorted({int(m.group(1)) for k in sd if (m := re.match(prefix + r"\.(\d+)\.", k))})


def _encoder_decoder(sd: dict, params: dict, handled: set) -> None:
    for tk, fk in _ENCODER_DECODER.items():
        _set(params, f"{fk}/Conv_0/kernel", _conv_w(sd[f"{tk}.0.weight"]))
        _set(params, f"{fk}/Conv_0/bias", sd[f"{tk}.0.bias"])
        handled |= {f"{tk}.0.weight", f"{tk}.0.bias"}


def _feed_forward(sd: dict, params: dict, t: str, f: str) -> None:
    for ff_t, ff_f in (("feed_forward.0.0", "ConvBlock_0"), ("feed_forward.1.0", "ConvBlock_1")):
        _set(params, f"{f}/{ff_f}/Conv_0/kernel", _conv_w(sd[f"{t}.{ff_t}.weight"]))
        _set(params, f"{f}/{ff_f}/Conv_0/bias", sd[f"{t}.{ff_t}.bias"])


def convert_afgsa_generator(sd: dict, use_film: bool = False) -> dict:
    """Reference AFGSANet state dict → flax param tree (layouts only)."""
    params: dict = {}
    handled: set = set()
    _encoder_decoder(sd, params, handled)
    for i in _blocks(sd, r"transformer_blocks"):
        t, f = f"transformer_blocks.{i}", f"TransformerBlock_{i}"
        if not use_film:  # FiLM replaces the noisy + aux fusion conv
            _set(params, f"{f}/attention/ConvBlock_0/Conv_0/kernel",
                 _conv_w(sd[f"{t}.attention.conv_map.0.weight"]))
            _set(params, f"{f}/attention/ConvBlock_0/Conv_0/bias",
                 sd[f"{t}.attention.conv_map.0.bias"])
        for proj in ("q_conv", "k_conv", "v_conv"):
            _set(params, f"{f}/attention/{proj}/kernel",
                 _conv_w(sd[f"{t}.attention.{proj}.weight"]))
        # rel_h [1, win, 1, half] / rel_w [1, 1, win, half] → [win, half]
        rel_h, rel_w = sd[f"{t}.attention.rel_h"], sd[f"{t}.attention.rel_w"]
        _set(params, f"{f}/attention/rel_h", rel_h.reshape(rel_h.shape[1], -1))
        _set(params, f"{f}/attention/rel_w", rel_w.reshape(rel_w.shape[2], -1))
        if use_film:
            for j, k in ((0, 0), (1, 2)):
                _set(params, f"{f}/attention/FiLM_0/Conv_{j}/kernel",
                     _conv_w(sd[f"{t}.attention.film.affine.{k}.weight"]))
                _set(params, f"{f}/attention/FiLM_0/Conv_{j}/bias",
                     sd[f"{t}.attention.film.affine.{k}.bias"])
        _feed_forward(sd, params, t, f)
        handled |= {k for k in sd if k.startswith(t + ".")}
    _check_leftovers(sd, handled)
    return params


def convert_mamba_generator(sd: dict) -> dict:
    """Reference MambaDenoiserNet state dict → flax param tree: LayerNorm,
    `mamba_ssm.Mamba2` (Linear [out, in] → Dense [in, out], depthwise
    conv1d [C, 1, k] → [k, C]) and feed-forward convs per block."""
    params: dict = {}
    handled: set = set()
    _encoder_decoder(sd, params, handled)
    for i in _blocks(sd, r"mamba_blocks"):
        t, f = f"mamba_blocks.{i}", f"MambaBlock_{i}"
        _set(params, f"{f}/norm1/scale", sd[f"{t}.norm1.weight"])
        _set(params, f"{f}/norm1/bias", sd[f"{t}.norm1.bias"])
        _set(params, f"{f}/mamba/in_proj/kernel", sd[f"{t}.mamba.in_proj.weight"].T)
        _set(params, f"{f}/mamba/conv1d_weight",
             np.squeeze(sd[f"{t}.mamba.conv1d.weight"], axis=1).T)
        _set(params, f"{f}/mamba/conv1d_bias", sd[f"{t}.mamba.conv1d.bias"])
        for name in ("dt_bias", "A_log", "D"):
            _set(params, f"{f}/mamba/{name}", sd[f"{t}.mamba.{name}"])
        _set(params, f"{f}/mamba/norm/weight", sd[f"{t}.mamba.norm.weight"])
        _set(params, f"{f}/mamba/out_proj/kernel", sd[f"{t}.mamba.out_proj.weight"].T)
        _feed_forward(sd, params, t, f)
        handled |= {k for k in sd if k.startswith(t + ".")}
    _check_leftovers(sd, handled)
    return params


def convert_discriminator_vgg(sd: dict) -> dict:
    """Reference DiscriminatorVGG state dict → flax param tree. The first
    Linear reads the flattened 4×4 feature map in (C, H, W) order in the
    reference and (H, W, C) here: its input axis is permuted."""
    params: dict = {}
    handled: set = set()
    for i in _blocks(sd, r"features"):
        _set(params, f"ConvBlock_{i}/Conv_0/kernel", _conv_w(sd[f"features.{i}.0.weight"]))
        _set(params, f"ConvBlock_{i}/Conv_0/bias", sd[f"features.{i}.0.bias"])
        handled |= {f"features.{i}.0.weight", f"features.{i}.0.bias"}
        if f"features.{i}.1.weight" in sd:  # a BatchNorm stage
            _set(params, f"ConvBlock_{i}/BatchNorm2d_0/scale", sd[f"features.{i}.1.weight"])
            _set(params, f"ConvBlock_{i}/BatchNorm2d_0/bias", sd[f"features.{i}.1.bias"])
            handled |= {f"features.{i}.1.weight", f"features.{i}.1.bias"}
    w = sd["classifier.0.weight"]  # [100, C·4·4] in (C, H, W) order
    ch = w.shape[1] // 16
    w_nhwc = w.reshape(w.shape[0], ch, 4, 4).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
    _set(params, "Dense_0/kernel", w_nhwc.T)
    _set(params, "Dense_0/bias", sd["classifier.0.bias"])
    _set(params, "Dense_1/kernel", sd["classifier.2.weight"].T)
    _set(params, "Dense_1/bias", sd["classifier.2.bias"])
    handled |= {"classifier.0.weight", "classifier.0.bias", "classifier.2.weight",
                "classifier.2.bias"}
    _check_leftovers(sd, handled)
    return params


def _check_leftovers(sd: dict, handled: set) -> None:
    leftovers = [k for k in sd if k not in handled and not _DROPPED.search(k)]
    if leftovers:
        raise KeyError(
            f"unmapped reference state_dict keys (unsupported variant?): "
            f"{sorted(leftovers)[:8]}{'…' if len(leftovers) > 8 else ''}",
        )


def convert(model: str, sd: dict, use_film: bool = False) -> dict:
    """A reference state dict (numpy values) → the port's state dict for
    `models.afgsa.AFGSANet`, `models.mamba.MambaDenoiserNet` or
    `models.discriminators.DiscriminatorVGG`."""
    from pixel_heal_thyself_tpu_torch import params

    if model == "afgsa":
        return params.afgsa_state_from_flax(convert_afgsa_generator(sd, use_film))
    if model == "mamba":
        return params.mamba_state_from_flax(convert_mamba_generator(sd))
    if model == "discriminator_vgg":
        return params.discriminator_state_from_flax(convert_discriminator_vgg(sd))
    raise ValueError(f"unknown model {model!r}")


def load_state_dict(path: str) -> dict:
    """A `torch.save`d state dict → numpy float32 arrays."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v.detach().float().numpy(), np.float32) for k, v in sd.items()}


def main(argv=None) -> None:
    from pixel_heal_thyself_tpu_torch.training import checkpoints

    ap = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.import_torch_checkpoint",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("afgsa", "mamba", "discriminator_vgg"), required=True)
    ap.add_argument("--g", required=True, help="path to the reference .pt state_dict")
    ap.add_argument("--out", required=True, help="params file to write (save_params)")
    ap.add_argument("--num-gcp", type=int, default=2,
                    help="accepted for the JAX tool's command line; the port's names do "
                         "not depend on it")
    ap.add_argument("--use-film", action="store_true",
                    help="the checkpoint was trained with model.use_film=true")
    args = ap.parse_args(argv)

    sd = load_state_dict(args.g)
    state = convert(args.model, sd, args.use_film)
    checkpoints.save_params(args.out, state)
    n = sum(t.numel() for t in state.values())
    print(f"imported {len(sd)} reference tensors -> {args.out} ({n:,} params)")


if __name__ == "__main__":
    main(sys.argv[1:])

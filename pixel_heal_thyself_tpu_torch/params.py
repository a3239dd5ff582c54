"""Weights bridge: the JAX package's flax params → the port's state_dicts.

`afgsa_state_from_flax(tree)` takes the flax param tree (nested dicts of
numpy arrays, the `params` collection of `AFGSANet.init`) and returns a
`state_dict` for `models.afgsa.AFGSANet`; `discriminator_state_from_flax`
does the same for `models.discriminators.DiscriminatorVGG` (BatchNorm
`scale`/`bias` as they are, Dense kernels `[in, out]` transposed to the
torch Linear layout). Conv kernels are transposed from
flax's HWIO to torch's OIHW (`transpose(3, 2, 0, 1)`); the block route
re-lays them out for its kernels at call time (`TransformerBlock.
kernel_weights`). rel_h/rel_w `[window, head_ch//2]` map as they are.

flax names the last `num_gcp` blocks `CheckpointTransformerBlock_<j>`
(`nn.remat` prefixes the class name and counts separately), after the
plain `TransformerBlock_<i>`s — see tools/import_torch_checkpoint.py
`_block_name`. Both map onto `blocks.<n>` in model order.

`mamba_state_from_flax` maps a MambaDenoiserNet tree onto
`models.mamba.MambaDenoiserNet` (Dense kernels transposed, the rest of
the Mamba2 layer as it is).

`load_params_npz(path)` reads the flat `.npz` that
`tools/export_params_npz.py` writes (keys such as
`"ConvBlock_0/Conv_0/kernel"`) back into the nested tree.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# flax ConvBlock name → port module path (outside the TransformerBlocks)
_CONV_BLOCKS = {
    "ConvBlock_0": "noisy_enc.branches.0",
    "ConvBlock_1": "noisy_enc.branches.1",
    "ConvBlock_2": "noisy_enc.branches.2",
    "ConvBlock_3": "noisy_proj.conv",
    "ConvBlock_4": "aux_enc.branches.0",
    "ConvBlock_5": "aux_enc.branches.1",
    "ConvBlock_6": "aux_enc.branches.2",
    "ConvBlock_7": "aux_proj1.conv",
    "ConvBlock_8": "aux_proj2.conv",
    "ConvBlock_9": "decoder.0.conv",
    "ConvBlock_10": "decoder.1.conv",
    "ConvBlock_11": "decoder.2.conv",
}
# inside a TransformerBlock: flax name → port module path
_FFN = {"ConvBlock_0": "ffn1.conv", "ConvBlock_1": "ffn2.conv"}
_PROJ = {"q_conv": "q_weight", "k_conv": "k_weight", "v_conv": "v_weight"}
_BLOCK_NAME = re.compile(r"^(Checkpoint)?TransformerBlock_(\d+)$")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(dst: dict, prefix: str, node: dict) -> None:
    """A flax Conv {kernel HWIO, bias} → `<prefix>.weight` OIHW, `.bias`."""
    for name, val in node.items():
        if name == "kernel":
            dst[f"{prefix}.weight"] = _tensor(np.transpose(val, (3, 2, 0, 1)))
        elif name == "bias":
            dst[f"{prefix}.bias"] = _tensor(val)
        else:
            raise KeyError(f"unexpected conv param {prefix}/{name}")


def _block(dst: dict, prefix: str, node: dict) -> None:
    for name, sub in node.items():
        if name == "attention":
            for aname, aval in sub.items():
                if aname in _PROJ:
                    dst[f"{prefix}attention.{_PROJ[aname]}"] = _tensor(
                        np.transpose(aval["kernel"], (3, 2, 0, 1)),
                    )
                elif aname in ("rel_h", "rel_w"):
                    dst[f"{prefix}attention.{aname}"] = _tensor(aval)
                elif aname == "ConvBlock_0":
                    _conv(dst, prefix + "attention.fuse.conv", aval["Conv_0"])
                else:
                    raise KeyError(f"unexpected attention param {aname}")
        elif name in _FFN:
            _conv(dst, prefix + _FFN[name], sub["Conv_0"])
        else:
            raise KeyError(f"unexpected TransformerBlock param {name}")


def afgsa_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """flax AFGSANet `params` tree → port `state_dict` (float32 tensors)."""
    tree = tree.get("params", tree)
    state: dict[str, torch.Tensor] = {}
    plain, remat = {}, {}
    for name, node in tree.items():
        if name in _CONV_BLOCKS:
            _conv(state, _CONV_BLOCKS[name], node["Conv_0"])
            continue
        m = _BLOCK_NAME.match(name)
        if m is None:
            raise KeyError(f"unexpected AFGSANet param {name}")
        (remat if m.group(1) else plain)[int(m.group(2))] = node
    blocks = [plain[i] for i in sorted(plain)] + [remat[j] for j in sorted(remat)]
    if sorted(plain) != list(range(len(plain))) or sorted(remat) != list(range(len(remat))):
        raise KeyError(f"non-contiguous TransformerBlock names: {sorted(plain)} {sorted(remat)}")
    for n, node in enumerate(blocks):
        _block(state, f"blocks.{n}.", node)
    return state


_DENSE = {"Dense_0": "dense0", "Dense_1": "dense1"}
_CONV_BLOCK_NAME = re.compile(r"^ConvBlock_(\d+)$")


def discriminator_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """flax DiscriminatorVGG `params` tree → port `state_dict`."""
    tree = tree.get("params", tree)
    state: dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        m = _CONV_BLOCK_NAME.match(name)
        if m is not None:
            prefix = f"blocks.{m.group(1)}"
            for sub, val in node.items():
                if sub == "Conv_0":
                    _conv(state, prefix + ".conv", val)
                elif sub == "BatchNorm2d_0":
                    state[f"{prefix}.norm.scale"] = _tensor(val["scale"])
                    state[f"{prefix}.norm.bias"] = _tensor(val["bias"])
                else:
                    raise KeyError(f"unexpected ConvBlock param {name}/{sub}")
        elif name in _DENSE:
            state[f"{_DENSE[name]}.weight"] = _tensor(np.asarray(node["kernel"]).T)
            state[f"{_DENSE[name]}.bias"] = _tensor(node["bias"])
        else:
            raise KeyError(f"unexpected DiscriminatorVGG param {name}")
    return state


_MAMBA_BLOCK_NAME = re.compile(r"^(Checkpoint)?MambaBlock_(\d+)$")
# Mamba2Layer params kept as they are: conv1d_weight [k, c] stays in the
# JAX layout, which is the one the port's conv and kernel take
_MAMBA_AS_IS = ("conv1d_weight", "conv1d_bias", "dt_bias", "A_log", "D")


def _mamba_block(dst: dict, prefix: str, node: dict) -> None:
    for name, sub in node.items():
        if name == "norm1":
            dst[f"{prefix}norm1.scale"] = _tensor(sub["scale"])
            dst[f"{prefix}norm1.bias"] = _tensor(sub["bias"])
        elif name == "mamba":
            for mname, mval in sub.items():
                if mname in ("in_proj", "out_proj"):  # Dense [in, out] → Linear [out, in]
                    dst[f"{prefix}mamba.{mname}.weight"] = _tensor(np.asarray(mval["kernel"]).T)
                elif mname == "norm":  # RMSNormGated or the fused route's holder
                    dst[f"{prefix}mamba.norm.weight"] = _tensor(mval["weight"])
                elif mname in _MAMBA_AS_IS:
                    dst[f"{prefix}mamba.{mname}"] = _tensor(mval)
                else:
                    raise KeyError(f"unexpected Mamba2Layer param {mname}")
        elif name in _FFN:
            _conv(dst, prefix + _FFN[name], sub["Conv_0"])
        else:
            raise KeyError(f"unexpected MambaBlock param {name}")


def mamba_state_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """flax MambaDenoiserNet `params` tree → port `state_dict`. The encoder
    and decoder ConvBlocks are named as AFGSANet's; the blocks are
    `MambaBlock_<i>`, then the `nn.remat` ones `CheckpointMambaBlock_<j>`,
    in model order."""
    tree = tree.get("params", tree)
    state: dict[str, torch.Tensor] = {}
    plain, remat = {}, {}
    for name, node in tree.items():
        if name in _CONV_BLOCKS:
            _conv(state, _CONV_BLOCKS[name], node["Conv_0"])
            continue
        m = _MAMBA_BLOCK_NAME.match(name)
        if m is None:
            raise KeyError(f"unexpected MambaDenoiserNet param {name}")
        (remat if m.group(1) else plain)[int(m.group(2))] = node
    if sorted(plain) != list(range(len(plain))) or sorted(remat) != list(range(len(remat))):
        raise KeyError(f"non-contiguous MambaBlock names: {sorted(plain)} {sorted(remat)}")
    blocks = [plain[i] for i in sorted(plain)] + [remat[j] for j in sorted(remat)]
    for n, node in enumerate(blocks):
        _mamba_block(state, f"blocks.{n}.", node)
    return state


def load_params_npz(path: str) -> dict:
    """Flat `.npz` keyed `"a/b/c"` → nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree

"""The benchmark's plain reference: float32 PyTorch, no kernels, no cache.

Imports neither the program under test nor anything of JAX. `generator`
and `critic` build the models a configuration file names, with empty
parameters that `benchmark/weights.py` fills from the seed.
"""

from __future__ import annotations

from benchmark.reference.afgsa import AFGSANet
from benchmark.reference.critic import DiscriminatorVGG
from benchmark.reference.mamba import MambaDenoiserNet


def generator(config: dict, device):
    """The configuration's generator (`config["widths"]`), on `device`."""
    w = dict(config["widths"])
    kind = w.pop("model")
    net = {"afgsa": AFGSANet, "mamba": MambaDenoiserNet}[kind]
    return net(**w, padding_mode=config["padding_mode"]).to(device)


def critic(config: dict, device):
    c = config["critic"]
    return DiscriminatorVGG(c["in_nc"], c["base_nf"], c["input_size"]).to(device)

"""pixel_heal_thyself_tpu_torch — the PyTorch/CUDA port of the PHT denoiser.

The JAX package `pixel_heal_thyself_tpu` is the reference: every module
here mirrors the module of the same name there and is held against it in
`tests/test_torch_port_*.py`. Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path is a hand-written CUDA kernel for Hopper
(`csrc/`, built by `_build.py` on first use).

Ported so far: the tiled full-frame AFGSA inference path
(`inference.py`) and the prod GAN training step
(`training/train_step.py`), with the block-halo attention kernels,
forward and backward (`ops/attention_cuda.py`), and the whole
TransformerBlock, forward and backward (`ops/block_cuda.py`). Host-side
code (config, EXR IO, preprocessing, metrics) is shared with the JAX
package, whose modules of those names import no JAX.

This package imports `torch`, `numpy` and `scipy`, never `jax` or `flax`.
"""

__version__ = "0.1.0"

"""pixel_heal_thyself_tpu_torch — the PyTorch/CUDA port of the PHT denoiser.

The JAX package `pixel_heal_thyself_tpu` is the reference: every module
here mirrors the module of the same name there and is held against it in
`tests/test_torch_port_*.py`. Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path is a hand-written CUDA kernel for Hopper
(`csrc/`, built by `_build.py` on first use).

Ported so far: tiled full-frame inference of the AFGSA and Mamba
generators (`inference.py`); their GAN training step
(`training/train_step.py`) with every option of the JAX trainer — FiLM,
the multiscale spectral-norm critic with the relativistic hinge, the
MS-SSIM (`ops/msssim.py`) and LPIPS (`models/lpips.py`) terms; and the
trainer that drives it
(`python -m pixel_heal_thyself_tpu_torch.train`, `training/trainer.py`:
the importance-sampled patch store of `data/store.py` built on first
run, the loaders of `data/dataset.py`, validation with its logs and PNG
panels, and checkpoints with resume, `training/checkpoints.py`);
exported serving artifacts (`serving.py`: `torch.export` programs with
the weights inside, written by `python -m
pixel_heal_thyself_tpu_torch.tools.export_model` and served by
`inference.from_export`), whose kernels stay in the graph as the
`torch.library` ops of `ops/library.py`; the import of the
reference's `G.pt`/`D.pt` (`tools/import_torch_checkpoint.py`); and
full frames served sharded over the ranks of a `torch.distributed`
process group (`parallel/`: AFGSA row-sharded with halo exchange, Mamba
sequence-sharded with its scan state chained across ranks). The
kernels: the block-halo attention, forward and backward
(`ops/attention_cuda.py`), the whole TransformerBlock, forward and
backward (`ops/block_cuda.py`), the fused Mamba2 layer interior, forward
and backward (`ops/ssd_mega_cuda.py`), the fused causal conv1d + SiLU
(`ops/conv_cuda.py`) and the chunked SSD scan (`ops/ssd_cuda.py`). The
host-side modules (config and its YAML tree, EXR IO, preprocessing,
synthetic data, metrics, logger, the native sampler's binding) are the
port's own copies.

This package imports `torch`, `numpy` and `scipy`, never `jax`, `flax` or
the JAX package.
"""

__version__ = "0.1.0"

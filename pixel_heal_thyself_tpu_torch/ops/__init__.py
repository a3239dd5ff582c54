"""Tensor ops of the PyTorch port: padding, block-halo attention and the
CUDA kernel wrappers."""

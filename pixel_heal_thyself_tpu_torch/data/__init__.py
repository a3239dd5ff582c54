"""Host-side data of the PyTorch port: EXR IO, preprocessing, synthetic
scenes (copies of the JAX package's modules of the same names)."""

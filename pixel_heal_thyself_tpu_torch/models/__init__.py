"""Model building blocks of the PyTorch port."""

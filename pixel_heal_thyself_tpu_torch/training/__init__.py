"""Training of the PyTorch port: the GAN train step (`train_step.py`)."""

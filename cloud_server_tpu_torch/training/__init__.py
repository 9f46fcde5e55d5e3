"""training of the PyTorch port."""

"""models of the PyTorch port."""

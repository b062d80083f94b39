"""training layer of the PyTorch port."""

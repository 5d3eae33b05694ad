"""Training data of the PyTorch port."""

"""Training and serving steps of the PyTorch port, and the optimizers."""

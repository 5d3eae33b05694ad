"""Step functions of the PyTorch port (serving only so far)."""

"""Fault tolerance of the PyTorch port's training loop."""

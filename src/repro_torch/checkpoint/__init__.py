"""Checkpoints of the PyTorch port's training state."""

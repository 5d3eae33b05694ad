"""Serving of the PyTorch port: the continuous-batching LM ``Engine`` and
its clocks."""
from repro_torch.serving.graph_frontend import Clock, FakeClock
from repro_torch.serving.server import Engine, Request

__all__ = ["Clock", "FakeClock", "Engine", "Request"]

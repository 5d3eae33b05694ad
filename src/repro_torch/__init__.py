"""PyTorch/CUDA port of the PB/COBRA reproduction.

Mirrors ``repro`` by path (``repro_torch/core/pagerank.py`` is held
against ``repro/core/pagerank.py``) and imports neither JAX nor ``repro``.
Data-creating functions default to the CUDA card (``repro_torch.device``);
functions on tensors run where their tensors are. The kernels in
``repro_torch.kernels`` are CUDA C++ for Hopper (sm_90a), built with
``nvcc`` at first use.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

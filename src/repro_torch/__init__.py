"""PyTorch/CUDA port of the PB/COBRA reproduction.

Mirrors ``repro`` by path (``repro_torch/core/pagerank.py`` is held
against ``repro/core/pagerank.py``) and imports neither JAX nor ``repro``.
Data-creating functions default to the CUDA card (``repro_torch.device``);
functions on tensors run where their tensors are. The kernels in
``repro_torch.kernels`` are CUDA C++ for Hopper (sm_90a), built with
``nvcc`` at first use.

The package itself imports nothing (``resolve_device`` resolves on first
use), so ``python -m repro_torch.analysis.lint`` runs without ``torch``.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from repro_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

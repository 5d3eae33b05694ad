"""The port's one device rule.

Functions that create data (the graph generators, ``graph_suite``,
``cached_graph``, the converters in ``repro_torch.convert``) take
``device=None``, which means the CUDA card. When CUDA is unavailable they
raise unless the caller asked for the CPU explicitly (``device="cpu"``,
as the CPU tests do): nothing quietly carries on on the CPU. Functions
that take tensors run where their tensors are.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the chosen CUDA device is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch paths on the CPU"
        )
    return dev

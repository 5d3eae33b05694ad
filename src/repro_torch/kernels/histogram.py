"""Histogram kernel wrapper (port of ``repro/kernels/histogram.py``).

``histogram`` runs the CUDA kernel in ``csrc/histogram.cu`` on a CUDA
tensor and its plain version (``ref.histogram_ref``) on a CPU tensor.
There is no other fallback: on any other device, or without ``nvcc``,
it raises. ``histogram.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import histogram_ref


def histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int32 counts of each key in [0, num_bins); other keys are ignored."""
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    if keys.device.type == "cpu":
        return histogram_ref(keys, num_bins)
    _lib.require_cuda(keys, torch.int32, "keys")
    m = keys.shape[0]
    _lib.check_int32_size(m, "stream length")
    counts = torch.zeros(num_bins, dtype=torch.int32, device=keys.device)
    if m == 0:
        return counts
    lib = _lib.load()
    _lib.check(
        lib.pb_histogram(keys.data_ptr(), m, counts.data_ptr(), num_bins, _lib.stream(keys)),
        "histogram kernel",
    )
    _lib.count_launch(histogram, (m, num_bins))
    return counts


histogram.launches, histogram.shapes = 0, {}

"""Counting-positions kernel wrapper (port of ``repro/kernels/binning.py``).

``counting_positions`` gives each key its destination under a stable
counting sort whose bin b region begins at ``starts[b]``; keys outside
``[0, num_bins)`` get -1. On a CUDA tensor it runs the three-phase kernel
of ``csrc/positions.cu`` (the wrapper allocates its (tiles, bins) count
matrix); on a CPU tensor its plain version ``ref.counting_positions_ref``.
``counting_positions.launches`` counts kernel launches.

The COBRA pass (``cobra_binning_pass_pallas``) is not ported yet; see
ROADMAP.md, Queue 2.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import counting_positions_ref


def counting_positions(
    keys: torch.Tensor, starts: torch.Tensor, num_bins: int
) -> torch.Tensor:
    """pos[i] = starts[k_i] + #{j < i : k_j == k_i}; -1 for an out-of-range key."""
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    if starts.shape != (num_bins,):
        raise ValueError(f"starts must have shape ({num_bins},), got {tuple(starts.shape)}")
    if keys.device.type == "cpu":
        return counting_positions_ref(keys, starts, num_bins)
    _lib.require_cuda(keys, torch.int32, "keys")
    _lib.require_cuda(starts, torch.int32, "starts")
    m = keys.shape[0]
    _lib.check_int32_size(m, "stream length")
    pos = torch.empty(m, dtype=torch.int32, device=keys.device)
    if m == 0:
        return pos
    lib = _lib.load()
    scratch = torch.empty(
        lib.pb_positions_scratch(m, num_bins), dtype=torch.int32, device=keys.device
    )
    _lib.check(
        lib.pb_counting_positions(
            keys.data_ptr(), m, starts.data_ptr(), num_bins, pos.data_ptr(),
            scratch.data_ptr(), _lib.stream(keys),
        ),
        "counting_positions kernel",
    )
    counting_positions.launches += 1
    return pos


counting_positions.launches = 0

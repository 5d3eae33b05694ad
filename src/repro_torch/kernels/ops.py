"""Kernel compositions (port of the slice's part of ``repro/kernels/ops.py``).

``pb_binning`` is software-PB binning built from the two kernels:
histogram -> starts -> counting positions -> a plain torch permutation
apply. Each kernel runs on CUDA tensors and its plain version on CPU
tensors. ``cobra_binning_pass``, ``cobra_binning``, ``padded_bin_layout``,
``binread_scatter_add``, ``scatter_rows`` and ``pb_scatter_add_full`` are
not ported yet (ROADMAP.md, Queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.core import pb as pb_core
from repro_torch.kernels.binning import counting_positions
from repro_torch.kernels.histogram import histogram

__all__ = ["histogram", "pb_binning"]


def pb_binning(
    idx: torch.Tensor, val: torch.Tensor, *, bin_range: int, num_bins: int
) -> pb_core.Bins:
    """Stable binning of ``(idx, val)`` by ``idx // bin_range``; every index
    must lie in ``[0, num_bins * bin_range)``."""
    keys = pb_core.bin_ids(idx, bin_range)
    counts = histogram(keys, num_bins)
    starts = pb_core.starts_from_counts(counts)
    pos = counting_positions(keys, starts[:-1], num_bins).long()
    out_idx = torch.empty_like(idx)
    out_val = torch.empty_like(val)
    out_idx[pos] = idx
    out_val[pos] = val
    return pb_core.Bins(idx=out_idx, val=out_val, starts=starts, bin_range=bin_range)

"""COBRA hierarchical binning (port of ``repro/core/cobra.py``).

Pass k re-partitions the whole stream by the key ``idx // range_k``;
ranges are nested multiples of the final range, so the composition of
stable passes equals one stable partition at the finest range. The
reference realises a pass either by a blocked counting sort or by a
stable argsort, depending on a TPU VMEM cut-off (``nb <= 4096``). Both
are stable partitions, so the port realises every pass the same way, as
a stable argsort, and its output is identical.
"""
from __future__ import annotations

import torch

from repro_torch.core import pb
from repro_torch.core.plan import CobraPlan


def hierarchical_binning(
    indices: torch.Tensor, values: torch.Tensor, plan: CobraPlan
) -> pb.Bins:
    """Run the multi-pass COBRA binning; returns bins at the final range."""
    idx, val = indices, values
    for rng in plan.level_ranges():
        perm = torch.argsort(pb.bin_ids(idx, rng), stable=True)
        idx, val = idx[perm], val[perm]
    final_key = pb.bin_ids(idx, plan.final_bin_range)
    return pb.Bins(
        idx=idx,
        val=val,
        starts=pb.starts_from_counts(pb.bincount(final_key, plan.num_bins)),
        bin_range=plan.final_bin_range,
    )


def cobra_scatter_add(
    indices: torch.Tensor, values: torch.Tensor, out_size: int, plan: CobraPlan
) -> torch.Tensor:
    bins = hierarchical_binning(indices, values, plan)
    return pb.bin_read_scatter_add(bins, out_size, out_dtype=values.dtype)

"""Kernel compositions (port of ``repro/kernels/ops.py``).

Each kernel runs on CUDA tensors and its plain version on CPU tensors;
what joins them here is plain torch.

``pb_binning``          software-PB binning: histogram -> starts ->
                        counting positions -> a permutation apply;
``cobra_binning_pass``  one COBRA C-Buffer pass: histogram -> starts ->
                        the pass kernel;
``cobra_binning``       one pass per ``plan.level_ranges()``, coarse to
                        fine (the paper's multi-level C-Buffer hierarchy);
``padded_bin_layout``   a binned stream -> the (B, L) padded layout;
``pb_scatter_add_full`` the embedding-gradient scatter-add: histogram ->
                        positions -> ``scatter_rows`` -> padded layout ->
                        ``binread_scatter_add``.
"""
from __future__ import annotations

import torch

from repro_torch.core import pb as pb_core
from repro_torch.core.plan import CobraPlan
from repro_torch.kernels import binning
from repro_torch.kernels.binning import counting_positions
from repro_torch.kernels.binread import binread_scatter_add
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.scatter_rows import scatter_rows

__all__ = [
    "histogram",
    "pb_binning",
    "cobra_binning_pass",
    "cobra_binning",
    "padded_bin_layout",
    "binread_scatter_add",
    "scatter_rows",
    "pb_scatter_add_full",
]


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


def cobra_binning_pass(
    idx: torch.Tensor, val: torch.Tensor, *, bin_range: int, num_bins: int
) -> pb_core.Bins:
    """One COBRA C-Buffer pass by ``idx // bin_range``; every index must lie
    in ``[0, num_bins * bin_range)``. Values keep their dtype."""
    keys = pb_core.bin_ids(idx, bin_range)
    starts = pb_core.starts_from_counts(histogram(keys, num_bins))
    out_idx, out_val = binning.cobra_binning_pass(
        keys, idx, val, starts[:-1].contiguous(), num_bins
    )
    return pb_core.Bins(idx=out_idx, val=out_val, starts=starts, bin_range=bin_range)


def cobra_binning(
    idx: torch.Tensor,
    val: torch.Tensor,
    plan: CobraPlan,
    *,
    max_bins_per_pass: int = 4096,
) -> pb_core.Bins:
    """Hierarchical COBRA binning: one pass per plan level, coarse to fine.
    A pass may have at most ``max_bins_per_pass`` bins, as in the
    reference."""
    n = plan.num_indices
    out = None
    for rng in plan.level_ranges():
        nb = -(-n // rng)
        if nb > max_bins_per_pass:
            raise ValueError(
                f"pass at range {rng} needs {nb} bins > {max_bins_per_pass}; "
                "use a plan with fewer levels or larger final range"
            )
        out = cobra_binning_pass(idx, val, bin_range=rng, num_bins=nb)
        idx, val = out.idx, out.val
    assert out is not None
    return out


def padded_bin_layout(bins: pb_core.Bins, num_bins: int, max_per_bin: int):
    """A compact binned stream -> ``(B, L)`` indices (-1 padding) and
    ``(B, L, ...)`` values (zero padding). Bins longer than ``max_per_bin``
    are truncated (callers size L from the histogram)."""
    B, L = num_bins, max_per_bin
    dev = bins.idx.device
    m = bins.idx.shape[0]
    st = bins.starts.to(dev)
    cols = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    valid = cols < (st[1:] - st[:-1]).long()[:, None]
    if m == 0:
        idx_p = torch.full((B, L), -1, dtype=bins.idx.dtype, device=dev)
        val_p = torch.zeros((B, L) + tuple(bins.val.shape[1:]), dtype=bins.val.dtype, device=dev)
        return idx_p, val_p
    src = (st[:-1].long()[:, None] + cols).clamp_(0, m - 1)
    idx_p = torch.where(valid, bins.idx[src], -1).to(bins.idx.dtype)
    val_p = bins.val[src.reshape(-1)].reshape((B, L) + tuple(bins.val.shape[1:]))
    val_p[~valid] = 0  # in place: the layout is B*L rows, the largest tensor here
    return idx_p, val_p


def pb_scatter_add_full(
    idx: torch.Tensor, updates: torch.Tensor, out_size: int, *, bin_range: int
) -> torch.Tensor:
    """End-to-end PB scatter-add of ``(m, d)`` updates through the kernels:
    histogram -> positions -> row scatter -> per-bin apply. L, the padded
    bin length, is read back to the host (one sync), rounded up to a
    multiple of 8 and at least 8, as in the reference."""
    num_bins = -(-out_size // bin_range)
    keys = pb_core.bin_ids(idx, bin_range)
    counts = histogram(keys, num_bins)
    starts = pb_core.starts_from_counts(counts)
    pos = counting_positions(keys, starts[:-1].contiguous(), num_bins)
    keep = pos >= 0
    binned_idx = torch.zeros_like(idx)
    binned_idx[pos[keep].long()] = idx[keep]
    binned_upd = scatter_rows(updates, pos, idx.shape[0])
    L = int(counts.max()) if num_bins else 0  # host sync: sizes the padded layout
    L = max(8, -(-L // 8) * 8)
    bins = pb_core.Bins(binned_idx, binned_upd, starts, bin_range)
    idx_p, val_p = padded_bin_layout(bins, num_bins, L)
    out = binread_scatter_add(idx_p, val_p, bin_range)
    return out[:out_size]

"""Plain PyTorch oracles (port of ``repro/kernels/ref.py``).

Each is also the **plain version** of one of the port's kernels:
``histogram_ref`` (kernels/histogram.py), ``counting_positions_ref`` and
``binned_stream_ref`` (kernels/binning.py: positions, COBRA pass),
``scatter_reduce_ref`` (kernels/fused.py: flat and row-block),
``binread_scatter_add_ref`` (kernels/binread.py) and
``scatter_rows_ref`` (kernels/scatter_rows.py); the flash kernel's,
``flash_attention_ref``, lives beside its wrapper in kernels/flashattn.py. A
kernel wrapper runs its plain version only for CPU tensors; the tests and
``chip_smoke.py`` hold each kernel against it. They follow the Pallas
kernels' treatment of out-of-range keys: ignored by the histogram, -1 in
positions, dropped (negative indices included) by the fused reduce.
"""
from __future__ import annotations

import torch

from repro_torch.core.pb import reduce_identity, scatter_reduce_into


def histogram_ref(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int32 counts of keys in [0, num_bins); other keys ignored."""
    k = keys[(keys >= 0) & (keys < num_bins)]
    return torch.bincount(k, minlength=num_bins).to(torch.int32)


def counting_positions_ref(
    keys: torch.Tensor, starts: torch.Tensor, num_bins: int
) -> torch.Tensor:
    """dest[i] = starts[keys[i]] + #{j < i : keys[j] == keys[i]}; -1 for a
    key outside [0, num_bins)."""
    m = keys.shape[0]
    dev = keys.device
    valid = (keys >= 0) & (keys < num_bins)
    k = torch.where(valid, keys, num_bins).to(torch.int32)
    order = torch.argsort(k, stable=True)
    ks = k[order]
    counts = torch.bincount(k, minlength=num_bins + 1).to(torch.int32)
    tight = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = torch.arange(m, dtype=torch.int32, device=dev) - tight[ks]
    base = starts.to(torch.int32)[ks.clamp(max=num_bins - 1)]
    dest_sorted = torch.where(ks < num_bins, base + rank, -1).to(torch.int32)
    dest = torch.empty(m, dtype=torch.int32, device=dev)
    dest[order] = dest_sorted
    return dest


def binned_stream_ref(keys, idx, val, num_bins):
    """Stable sort by key: the semantic result of any binning pass."""
    del num_bins
    perm = torch.argsort(keys, stable=True)
    return idx[perm], val[perm]


def binread_scatter_add_ref(idx_padded, val_padded, bin_range):
    """(B * bin_range, d) sums of the padded rows at their indices, padding
    (-1) and other out-of-range indices dropped; summed in float32 and
    stored in the input dtype, as the Pallas kernel's float32 dot is."""
    B, L = idx_padded.shape
    d = val_padded.shape[-1]
    out = torch.zeros((B * bin_range, d), dtype=torch.float32, device=val_padded.device)
    out = scatter_reduce_into(out, idx_padded.reshape(-1), val_padded.reshape(-1, d), "add")
    return out.to(val_padded.dtype)


def scatter_reduce_ref(idx, val, num_indices, op="add"):
    """Dense commutative scatter-reduce; untouched indices hold the op's
    identity and indices outside [0, num_indices) are dropped. bfloat16
    values are reduced in float32 and rounded once, as the rows kernel
    does."""
    acc = torch.float32 if val.dtype == torch.bfloat16 else val.dtype
    out = torch.full(
        (num_indices,) + tuple(val.shape[1:]),
        reduce_identity(op, val.dtype),
        dtype=acc,
        device=val.device,
    )
    return scatter_reduce_into(out, idx, val, op).to(val.dtype)


def scatter_rows_ref(x, pos, out_rows):
    out = torch.zeros((out_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    keep = (pos >= 0) & (pos < out_rows)
    out[pos[keep].long()] = x[keep]
    return out

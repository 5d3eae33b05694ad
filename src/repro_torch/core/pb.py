"""Propagation Blocking primitives (port of ``repro/core/pb.py``).

Binning is a **stable partition by bin id** (``index // bin_range``):
tuples within a bin keep stream order, which is what keeps
non-commutative consumers correct. Every layout is int32 at the public
functions; tensors are converted to int64 only where a torch op demands
it (``scatter_reduce_`` and advanced-index assignment).

``counting_permutation`` is a ``lax.scan`` over blocks with per-bin
cursors in the reference. A Python loop over blocks would crawl on the
card, so the port computes the same destinations in one stable pass: the
inverse of a stable argsort by bin id. For every element with a bin id in
``[0, num_bins)`` the destination is bit-identical to the reference's.
Values are single tensors, rank 1 (scalar lane) or rank 2 (row block).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Bins(NamedTuple):
    """A binned tuple stream: idx/val reordered bin 0 first (stable within
    each bin); ``starts`` has length num_bins+1."""

    idx: torch.Tensor
    val: torch.Tensor
    starts: torch.Tensor
    bin_range: int

    @property
    def num_bins(self) -> int:
        return int(self.starts.shape[0]) - 1


def bin_ids(indices: torch.Tensor, bin_range: int) -> torch.Tensor:
    return torch.div(indices, bin_range, rounding_mode="floor").to(torch.int32)


def reduce_identity(op: str, dtype: torch.dtype):
    """Identity of a commutative reduce op, as a Python number: 0 for add,
    the dtype's largest finite value for min and its smallest for max
    (``finfo``/``iinfo`` bounds, never infinities)."""
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    if op == "add":
        return 0
    if op == "min":
        return info.max
    if op == "max":
        return info.min
    raise ValueError(f"unknown reduce op: {op!r} (want 'add', 'min' or 'max')")


def starts_from_counts(counts: torch.Tensor) -> torch.Tensor:
    z = torch.zeros(1, dtype=torch.int32, device=counts.device)
    return torch.cat([z, torch.cumsum(counts, 0, dtype=torch.int32)])


def value_block_shape(values) -> Tuple[int, ...]:
    """``()`` for a scalar lane (rank 1), ``(F,)`` for a row block (rank 2);
    any other rank raises."""
    ndim = getattr(values, "ndim", None)
    if ndim is None:
        raise TypeError(f"stream values must be a tensor, got {type(values).__name__}")
    if ndim == 1:
        return ()
    if ndim == 2:
        return (int(values.shape[1]),)
    raise ValueError(
        "stream values must be rank-1 (scalar lane) or rank-2 (row "
        f"block, one dense feature row per tuple); got rank {ndim} with "
        f"shape {tuple(values.shape)}"
    )


def bincount(keys: torch.Tensor, length: int) -> torch.Tensor:
    """int32 counts of ``keys`` in ``[0, length)``; keys at or above
    ``length`` are dropped (``jnp.bincount(..., length=)`` semantics)."""
    if keys.numel() == 0:
        return torch.zeros(length, dtype=torch.int32, device=keys.device)
    return torch.bincount(keys, minlength=length)[:length].to(torch.int32)


def binning_sort(
    indices: torch.Tensor, values: torch.Tensor, bin_range: int, num_bins: int
) -> Bins:
    """Reference binning: stable sort by bin id."""
    bids = bin_ids(indices, bin_range)
    perm = torch.argsort(bids, stable=True)
    return Bins(
        idx=indices[perm],
        val=values[perm],
        starts=starts_from_counts(bincount(bids, num_bins)),
        bin_range=bin_range,
    )


def counting_permutation(bids: torch.Tensor, num_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination of every element under a stable counting sort by
    ``bids`` (int32, in ``[0, num_bins)``), plus per-bin counts."""
    m = bids.shape[0]
    counts = bincount(bids, num_bins)
    order = torch.argsort(bids, stable=True)
    dest = torch.empty(m, dtype=torch.int32, device=bids.device)
    dest[order] = torch.arange(m, dtype=torch.int32, device=bids.device)
    return dest, counts


def inverse_permutation(dest: torch.Tensor) -> torch.Tensor:
    """inv with inv[dest[i]] = i, via one int32 scatter."""
    m = dest.shape[0]
    inv = torch.zeros(m, dtype=torch.int32, device=dest.device)
    inv[dest.long()] = torch.arange(m, dtype=torch.int32, device=dest.device)
    return inv


def binning_counting(
    indices: torch.Tensor,
    values: torch.Tensor,
    bin_range: int,
    num_bins: int,
) -> Bins:
    bids = bin_ids(indices, bin_range)
    dest, counts = counting_permutation(bids, num_bins)
    inv = inverse_permutation(dest)
    return Bins(
        idx=indices[inv],
        val=values[inv],
        starts=starts_from_counts(counts),
        bin_range=bin_range,
    )


def binning(
    indices: torch.Tensor,
    values: torch.Tensor,
    bin_range: int,
    num_bins: int,
    method: str = "sort",
) -> Bins:
    if method == "sort":
        return binning_sort(indices, values, bin_range, num_bins)
    if method == "counting":
        return binning_counting(indices, values, bin_range, num_bins)
    raise ValueError(f"unknown binning method: {method}")


# ---------------------------------------------------------------------------
# Bin-Read helpers.
# ---------------------------------------------------------------------------


def scatter_reduce_into(
    out: torch.Tensor, indices: torch.Tensor, values: torch.Tensor, op: str
) -> torch.Tensor:
    """Reduce ``values`` into ``out`` (pre-filled with the op's identity) at
    ``indices``, in place, with one vectorised torch call. Indices outside
    ``[0, out.shape[0])``, negative ones included, are dropped."""
    n = out.shape[0]
    keep = (indices >= 0) & (indices < n)
    if not bool(keep.all()):
        indices, values = indices[keep], values[keep]
    values = values.to(out.dtype)
    if op == "add":
        return out.index_add_(0, indices, values)
    if op not in ("min", "max"):
        reduce_identity(op, out.dtype)  # raises the canonical error
    idx = indices.long()
    if values.ndim == 2:
        idx = idx[:, None].expand(-1, values.shape[1])
    return out.scatter_reduce_(
        0, idx, values, reduce="amin" if op == "min" else "amax", include_self=True
    )


def bin_read_reduce(
    bins: Bins,
    out_size: int,
    op: str = "add",
    out_dtype=None,
) -> torch.Tensor:
    """Commutative Bin-Read (add | min | max) into a dense output whose
    untouched indices hold the op's identity."""
    v = bins.val
    dt = out_dtype or v.dtype
    out = torch.full(
        (out_size,) + tuple(v.shape[1:]), reduce_identity(op, dt), dtype=dt, device=v.device
    )
    return scatter_reduce_into(out, bins.idx, v, op)


def bin_read_scatter_add(bins: Bins, out_size: int, out_dtype=torch.float32) -> torch.Tensor:
    return bin_read_reduce(bins, out_size, op="add", out_dtype=out_dtype)

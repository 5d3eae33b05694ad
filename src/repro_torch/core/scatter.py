"""Scatter-add primitives of the LM integrations (port of
``repro/core/scatter.py:19-62``), plain torch as the reference is plain
jnp.

The backward of an embedding lookup is an irregular scatter-add over the
vocabulary, the update stream PB targets. ``scatter_add_baseline`` is the
direct random scatter; ``pb_scatter_add`` sorts by index (a stable
argsort, the functional counterpart of binning at range 1), optionally
coalesces runs of equal indices with a cumulative sum, then scatters in
index order. Both follow jnp's ``.at[].add``: a negative index counts
from the end and one still outside ``[0, out_size)`` is dropped.
"""
from __future__ import annotations

import torch


def _add_at(out: torch.Tensor, indices: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``out.at[indices].add(updates)`` with jnp's index rule."""
    n = out.shape[0]
    idx = torch.where(indices < 0, indices + n, indices)
    keep = (idx >= 0) & (idx < n)
    if not bool(keep.all()):
        idx, updates = idx[keep], updates[keep]
    return out.index_add_(0, idx.long(), updates)


def scatter_add_baseline(indices: torch.Tensor, updates: torch.Tensor, out_size: int) -> torch.Tensor:
    """Direct random scatter-add (the no-PB baseline), in updates' dtype."""
    out = torch.zeros((out_size,) + tuple(updates.shape[1:]), dtype=updates.dtype,
                      device=updates.device)
    return _add_at(out, indices, updates)


def pb_scatter_add(indices: torch.Tensor, updates: torch.Tensor, out_size: int,
                   coalesce: bool = True) -> torch.Tensor:
    """PB scatter-add: stable sort by index, then a scatter in index order.
    With ``coalesce`` each run of equal indices is summed first, as the
    difference of a float32 inclusive cumulative sum at the run's end and
    before its start, and only the run's last entry is scattered (float32
    accumulator, cast to updates' dtype)."""
    order = torch.argsort(indices, stable=True)
    idx_s = indices[order]
    upd_s = updates[order]
    shape = (out_size,) + tuple(updates.shape[1:])
    if not coalesce:
        return _add_at(torch.zeros(shape, dtype=updates.dtype, device=updates.device),
                       idx_s, upd_s)
    m = idx_s.shape[0]
    out = torch.zeros(shape, dtype=torch.float32, device=updates.device)
    if m == 0:
        return out.to(updates.dtype)
    csum = torch.cumsum(upd_s.float(), dim=0)
    change = idx_s[1:] != idx_s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=idx_s.device)
    is_last = torch.cat([change, one])
    run_prev = torch.where(torch.cat([one, change]),
                           torch.arange(m, device=idx_s.device), 0)
    run_start = torch.cummax(run_prev, dim=0).values
    lead = (...,) + (None,) * (upd_s.ndim - 1)
    prev_total = torch.where((run_start > 0)[lead],
                             csum[torch.clamp(run_start - 1, min=0)], 0.0)
    contrib = torch.where(is_last[lead], csum - prev_total, 0.0)
    return _add_at(out, idx_s, contrib).to(updates.dtype)

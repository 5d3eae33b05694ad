"""Counting-positions kernel wrapper (port of ``repro/kernels/binning.py``).

``counting_positions`` gives each key its destination under a stable
counting sort whose bin b region begins at ``starts[b]``; keys outside
``[0, num_bins)`` get -1. On a CUDA tensor it runs the three-phase kernel
of ``csrc/positions.cu`` (the wrapper allocates its (tiles, bins) count
matrix); on a CPU tensor its plain version ``ref.counting_positions_ref``.
``counting_positions.launches`` counts kernel launches.

``cobra_binning_pass`` is one COBRA C-Buffer pass (port of
``cobra_binning_pass_pallas``): the ``(idx, val)`` stream stably
partitioned by ``keys`` into regions that begin at ``starts``. On a CUDA
tensor it runs ``csrc/cobra_pass.cu`` (tile counts, a column scan, then
per-tile C-Buffers in shared memory flushed as contiguous runs); on a CPU
tensor its plain version ``ref.binned_stream_ref``.
``cobra_binning_pass.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import binned_stream_ref, counting_positions_ref


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


_PAYLOAD_DTYPES = (torch.int32, torch.float32)
COBRA_MAX_BINS = 12288  # csrc/cobra_pass.cu: per-bin counters in 48 KB of shared memory


def cobra_binning_pass(
    keys: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    starts: torch.Tensor,
    num_bins: int,
):
    """Binned ``(idx, val)``, exactly m long, stable within each bin;
    ``starts`` (num_bins,) are the exclusive bin starts of the key counts.

    Every key must lie in ``[0, num_bins)``, as ``ops.cobra_binning_pass``
    guarantees. Values keep their dtype (int32 or float32); the reference
    declares its value output int32 whatever came in (ROADMAP.md, Queue 3).
    """
    if not 1 <= num_bins <= COBRA_MAX_BINS:
        raise ValueError(f"num_bins must be in [1, {COBRA_MAX_BINS}], got {num_bins}")
    if starts.shape != (num_bins,):
        raise ValueError(f"starts must have shape ({num_bins},), got {tuple(starts.shape)}")
    if not (keys.ndim == idx.ndim == val.ndim == 1 and keys.shape == idx.shape == val.shape):
        raise ValueError(
            f"keys, idx and val must be one shape (m,), got {tuple(keys.shape)}, "
            f"{tuple(idx.shape)}, {tuple(val.shape)}"
        )
    if keys.device.type == "cpu":
        return binned_stream_ref(keys, idx, val, num_bins)
    for t, name in ((keys, "keys"), (idx, "idx"), (starts, "starts")):
        _lib.require_cuda(t, torch.int32, name)
    if val.dtype not in _PAYLOAD_DTYPES:
        raise ValueError(f"COBRA pass takes int32 or float32 values, got {val.dtype}")
    _lib.require_cuda(val, val.dtype, "val")
    m = keys.shape[0]
    _lib.check_int32_size(m, "stream length")
    out_idx = torch.empty_like(idx)
    out_val = torch.empty_like(val)
    if m == 0:
        return out_idx, out_val
    lib = _lib.load()
    scratch = torch.empty(
        lib.pb_cobra_pass_scratch(m, num_bins), dtype=torch.int32, device=keys.device
    )
    _lib.check(
        lib.pb_cobra_pass(
            keys.data_ptr(), idx.data_ptr(), val.data_ptr(), m, starts.data_ptr(),
            num_bins, out_idx.data_ptr(), out_val.data_ptr(), scratch.data_ptr(),
            _lib.stream(keys),
        ),
        "cobra_binning_pass kernel",
    )
    cobra_binning_pass.launches += 1
    return out_idx, out_val


cobra_binning_pass.launches = 0

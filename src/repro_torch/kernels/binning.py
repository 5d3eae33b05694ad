"""Counting-positions kernel wrapper (port of ``repro/kernels/binning.py``).

``counting_positions`` gives each key its destination under a stable
counting sort whose bin b region begins at ``starts[b]``; keys outside
``[0, num_bins)`` get -1. On a CPU tensor it runs its plain version
``ref.counting_positions_ref``; on a CUDA tensor one of the two designs
of ``csrc/positions.cu`` (``positions_design``):

- ``"onesweep"`` for ``num_bins <= ONESWEEP_MAX_BINS`` (2048): one kernel
  that reads each key once, with a decoupled look-back across tiles of
  16384 keys (``csrc/pb_onesweep.cuh``); the switch point is its per-warp
  counters, 16 warps x ``num_bins`` int32 in shared memory (128 KB at
  2048);
- ``"three-phase"`` above it: tile counts, a column scan, a stable warp
  rank (the keys read three times).

The wrapper allocates the design's scratch (the zeroed status words, or
the (tiles, bins) count matrix) for each call. Both designs are exact:
the result equals the plain version bit for bit.
``counting_positions.launches`` counts kernel launches.

``cobra_binning_pass`` is one COBRA C-Buffer pass (port of
``cobra_binning_pass_pallas``): the ``(idx, val)`` stream stably
partitioned by ``keys`` into regions that begin at ``starts``. On a CPU
tensor it runs its plain version ``ref.binned_stream_ref``; on a CUDA
tensor one of the two designs of ``csrc/cobra_pass.cu``
(``cobra_pass_design``):

- ``"onesweep"`` for ``num_bins <= COBRA_ONESWEEP_MAX_BINS`` (4096, every
  pass ``ops.cobra_binning`` makes): one kernel on the look-back core
  that reads keys, idx and val once, stages each tile of 8192 tuples in
  shared memory grouped by bin (the C-Buffers) and writes each bin's run
  at its destination; the switch point is its per-warp 16-bit counters,
  16 warps x ``num_bins`` in shared memory (128 KB at 4096);
- ``"three-phase"`` above it, up to ``COBRA_MAX_BINS``: tile counts, a
  column scan, then a per-tile radix sort whose runs gather idx and val.

Both are exact. ``cobra_binning_pass.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import binned_stream_ref, counting_positions_ref


POSITIONS_DESIGNS = ("onesweep", "three-phase")
_POSITIONS_CODE = {"three-phase": 0, "onesweep": 1}
ONESWEEP_MAX_BINS = 2048  # csrc/pb_onesweep.cuh: kMaxBins


def positions_design(num_bins: int) -> str:
    """The design ``counting_positions`` runs on the card for ``num_bins``."""
    return "onesweep" if num_bins <= ONESWEEP_MAX_BINS else "three-phase"


def counting_positions(
    keys: torch.Tensor, starts: torch.Tensor, num_bins: int, design: str | None = None
) -> torch.Tensor:
    """pos[i] = starts[k_i] + #{j < i : k_j == k_i}; -1 for an out-of-range key.

    ``design`` (``POSITIONS_DESIGNS``) forces a kernel on the card; None
    takes ``positions_design(num_bins)``.
    """
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    if starts.shape != (num_bins,):
        raise ValueError(f"starts must have shape ({num_bins},), got {tuple(starts.shape)}")
    design = positions_design(num_bins) if design is None else design
    if design not in POSITIONS_DESIGNS:
        raise ValueError(f"design must be one of {POSITIONS_DESIGNS}, got {design!r}")
    if design == "onesweep" and num_bins > ONESWEEP_MAX_BINS:
        raise ValueError(f"the onesweep design takes at most {ONESWEEP_MAX_BINS} bins, got {num_bins}")
    if keys.device.type == "cpu":
        return counting_positions_ref(keys, starts, num_bins)
    if keys.device.type == "meta":  # the dry run's shape-only route (_lib.meta_call)
        m = keys.shape[0]
        _lib.meta_call(counting_positions, 0, 8 * m + 4 * num_bins)
        return torch.empty(m, dtype=torch.int32, device=keys.device)
    _lib.require_cuda(keys, torch.int32, "keys")
    _lib.require_cuda(starts, torch.int32, "starts")
    m = keys.shape[0]
    _lib.check_int32_size(m, "stream length")
    pos = torch.empty(m, dtype=torch.int32, device=keys.device)
    if m == 0:
        return pos
    lib = _lib.load()
    code = _POSITIONS_CODE[design]
    scratch = torch.empty(
        lib.pb_positions_scratch(m, num_bins, code), dtype=torch.int32, device=keys.device
    )
    _lib.check(
        lib.pb_counting_positions(
            keys.data_ptr(), m, starts.data_ptr(), num_bins, pos.data_ptr(),
            scratch.data_ptr(), code, _lib.stream(keys),
        ),
        "counting_positions kernel",
    )
    _lib.count_launch(counting_positions, (m, num_bins))
    return pos


counting_positions.launches, counting_positions.shapes = 0, {}


_PAYLOAD_DTYPES = (torch.int32, torch.float32)
COBRA_MAX_BINS = 12288  # csrc/cobra_pass.cu: per-bin counters in 48 KB of shared memory
COBRA_PASS_DESIGNS = ("onesweep", "three-phase")
_COBRA_CODE = {"three-phase": 0, "onesweep": 1}
COBRA_ONESWEEP_MAX_BINS = 4096  # csrc/pb_onesweep.cuh: kMaxBins16


def cobra_pass_design(num_bins: int) -> str:
    """The design ``cobra_binning_pass`` runs on the card for ``num_bins``."""
    return "onesweep" if num_bins <= COBRA_ONESWEEP_MAX_BINS else "three-phase"


def cobra_binning_pass(
    keys: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    starts: torch.Tensor,
    num_bins: int,
    design: str | None = None,
):
    """Binned ``(idx, val)``, exactly m long, stable within each bin;
    ``starts`` (num_bins,) are the exclusive bin starts of the key counts.

    Every key must lie in ``[0, num_bins)``, as ``ops.cobra_binning_pass``
    guarantees. Values keep their dtype (int32 or float32); the reference
    declares its value output int32 whatever came in (ROADMAP.md, Queue 3).
    ``design`` (``COBRA_PASS_DESIGNS``) forces a kernel on the card; None
    takes ``cobra_pass_design(num_bins)``.
    """
    if not 1 <= num_bins <= COBRA_MAX_BINS:
        raise ValueError(f"num_bins must be in [1, {COBRA_MAX_BINS}], got {num_bins}")
    design = cobra_pass_design(num_bins) if design is None else design
    if design not in COBRA_PASS_DESIGNS:
        raise ValueError(f"design must be one of {COBRA_PASS_DESIGNS}, got {design!r}")
    if design == "onesweep" and num_bins > COBRA_ONESWEEP_MAX_BINS:
        raise ValueError(
            f"the onesweep design takes at most {COBRA_ONESWEEP_MAX_BINS} bins, got {num_bins}")
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
    code = _COBRA_CODE[design]
    scratch = torch.empty(
        lib.pb_cobra_pass_scratch(m, num_bins, code), dtype=torch.int32, device=keys.device
    )
    _lib.check(
        lib.pb_cobra_pass(
            keys.data_ptr(), idx.data_ptr(), val.data_ptr(), m, starts.data_ptr(),
            num_bins, out_idx.data_ptr(), out_val.data_ptr(), scratch.data_ptr(), code,
            _lib.stream(keys),
        ),
        "cobra_binning_pass kernel",
    )
    _lib.count_launch(cobra_binning_pass, (m, num_bins))
    return out_idx, out_val


cobra_binning_pass.launches, cobra_binning_pass.shapes = 0, {}

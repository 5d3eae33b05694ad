"""Bin-Read kernel wrapper (port of ``repro/kernels/binread.py``).

``binread_scatter_add`` adds the rows of a padded bin layout — indices
``(B, L)`` with -1 padding, values ``(B, L, d)`` — into a ``(B * R, d)``
output, R = ``bin_range``; duplicates coalesce. On a CUDA tensor it runs
``csrc/binread.cu`` (each block counting-sorts a 4096-position tile of one
bin row by index in shared memory and applies each run of equal indices
with one 16-byte reduction per 4 columns); on a CPU tensor its plain version
``ref.binread_scatter_add_ref``. Both sum in float32 and store the input
dtype (float32 or bfloat16), as the Pallas kernel's float32 dot does, and
both add an index at its global row wherever it lies in ``[0, B * R)``
(the plain oracle's rule; the Pallas kernel drops an index outside its own
bin's range, which a layout from ``ops.padded_bin_layout`` never holds).
``binread_scatter_add.launches`` counts kernel launches.

Tolerance: float32 sums run in the order the atomics land; bfloat16
results are compared with atol 1e-1, as ``tests/test_kernels.py`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import binread_scatter_add_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def binread_scatter_add(
    idx_padded: torch.Tensor, val_padded: torch.Tensor, bin_range: int
) -> torch.Tensor:
    """``(B * bin_range, d)`` sums of ``val_padded`` rows at their indices."""
    if idx_padded.ndim != 2 or val_padded.ndim != 3 or val_padded.shape[:2] != idx_padded.shape:
        raise ValueError(
            f"binread wants idx (B, L) and val (B, L, d), got {tuple(idx_padded.shape)} "
            f"and {tuple(val_padded.shape)}"
        )
    if bin_range < 1:
        raise ValueError(f"bin_range must be >= 1, got {bin_range}")
    if idx_padded.device.type == "cpu":
        return binread_scatter_add_ref(idx_padded, val_padded, bin_range)
    _lib.require_cuda(idx_padded, torch.int32, "idx_padded")
    if val_padded.dtype not in _DTYPE_CODE:
        raise ValueError(f"binread takes float32 or bfloat16 values, got {val_padded.dtype}")
    _lib.require_cuda(val_padded, val_padded.dtype, "val_padded")
    B, L, d = val_padded.shape
    out_rows = B * bin_range
    _lib.check_int32_size(B * L, "padded layout length B * L")
    _lib.check_int32_size(out_rows, "output rows B * bin_range")
    _lib.check_int32_size(d, "row width")
    acc = torch.zeros((out_rows, d), dtype=torch.float32, device=val_padded.device)
    out = acc if val_padded.dtype == torch.float32 else torch.empty(
        (out_rows, d), dtype=val_padded.dtype, device=val_padded.device
    )
    lib = _lib.load()
    _lib.check(
        lib.pb_binread_scatter_add(
            idx_padded.data_ptr(), val_padded.data_ptr(), B, L, d, bin_range,
            acc.data_ptr(), out.data_ptr(), _DTYPE_CODE[val_padded.dtype],
            _lib.stream(idx_padded),
        ),
        "binread_scatter_add kernel",
    )
    _lib.count_launch(binread_scatter_add, (B, L, d))
    return out


binread_scatter_add.launches, binread_scatter_add.shapes = 0, {}

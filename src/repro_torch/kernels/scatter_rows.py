"""Row-scatter kernel wrapper (port of ``repro/kernels/scatter_rows.py``).

``scatter_rows`` writes ``out[pos[i]] = x[i]`` for every ``pos[i]`` in
``[0, out_rows)``; ``pos = -1`` drops the row and unwritten rows are zero.
On a CUDA tensor it runs ``csrc/scatter_rows.cu`` (a coalesced copy of
16-byte words); on a CPU tensor its plain version ``ref.scatter_rows_ref``.
Rows are float32, bfloat16 or int32, copied as bits, so the result is
exact. Positions are meant to be distinct (the reference writes distinct
counting-sort destinations): where two rows name one position the kernel
keeps, word by word, whichever write lands last.
``scatter_rows.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import scatter_rows_ref

ROW_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def scatter_rows(x: torch.Tensor, pos: torch.Tensor, out_rows: int) -> torch.Tensor:
    """``(out_rows, d)``: row ``pos[i]`` holds ``x[i]``, the rest zero."""
    if x.ndim != 2 or pos.shape != (x.shape[0],):
        raise ValueError(
            f"scatter_rows wants x (m, d) and pos (m,), got {tuple(x.shape)} and "
            f"{tuple(pos.shape)}"
        )
    if pos.device.type == "cpu":
        return scatter_rows_ref(x, pos, out_rows)
    if x.dtype not in ROW_DTYPES:
        raise ValueError(f"scatter_rows takes {ROW_DTYPES} rows, got {x.dtype}")
    _lib.require_cuda(x, x.dtype, "x")
    _lib.require_cuda(pos, torch.int32, "pos")
    m, d = x.shape
    _lib.check_int32_size(m, "rows")
    _lib.check_int32_size(out_rows, "out_rows")
    out = torch.zeros((out_rows, d), dtype=x.dtype, device=x.device)
    if m == 0 or d == 0 or out_rows == 0:
        return out
    lib = _lib.load()
    _lib.check(
        lib.pb_scatter_rows(
            x.data_ptr(), pos.data_ptr(), m, d * x.element_size(), out.data_ptr(),
            out_rows, _lib.stream(x),
        ),
        "scatter_rows kernel",
    )
    _lib.count_launch(scatter_rows, (m, d))
    return out


scatter_rows.launches, scatter_rows.shapes = 0, {}

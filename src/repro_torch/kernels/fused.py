"""Fused bin-and-accumulate wrapper (port of ``repro/kernels/fused.py``).

``cobra_bin_accumulate`` reduces one flat ``(idx, val)`` stream by add,
min or max into a dense ``(num_indices,)`` output in a single sweep, the
binned stream never written out. On a CUDA tensor it runs
``csrc/fused.cu``; on a CPU tensor its plain version
``ref.scatter_reduce_ref``. Both drop indices outside
``[0, num_indices)``, negative ones included, as the Pallas kernel does.

Fit rule: the kernel's accumulator is global memory, so the only limits
are int32 addressing of the output and the stream. (The reference's
32 MiB / 4096-bin limits are TPU VMEM facts and do not apply.)

Tolerance: int32 results and every min/max result are exact. A float32
add sums in the order the atomics land, which changes from run to run;
against a sequential sum the difference is bounded by about
``(k - 1) * eps * sum(|v|)`` for an index that receives k tuples
(eps = 2**-24), so comparisons allow 1e-5 * sum(|v|) per index: with
cancelling signs the result itself can be far smaller than that sum.

``cobra_bin_accumulate_rows`` is the row-block (SpMM) form: ``(m, F)``
values reduced into ``(num_indices, F)`` by ``csrc/fused_rows.cu`` on a
CUDA tensor, by the same plain version on a CPU tensor, with the same
index rule and tolerances (per column). Row offsets are 64-bit, so only
m and num_indices, not m * F, must fit int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.pb import reduce_identity
from repro_torch.kernels import _lib
from repro_torch.kernels.ref import scatter_reduce_ref

FUSED_OPS = ("add", "min", "max")
_OP_CODE = {"add": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}


def cobra_bin_accumulate(
    idx: torch.Tensor,
    val: torch.Tensor,
    num_indices: int,
    bin_range: int,
    num_bins: int,
    op: str = "add",
) -> torch.Tensor:
    """Dense ``(num_indices,)`` reduction of a flat stream; untouched
    indices hold ``reduce_identity(op, val.dtype)``."""
    if op not in FUSED_OPS:
        raise ValueError(f"fused accumulate needs a commutative op, got {op!r}")
    if val.ndim != 1 or idx.shape != val.shape:
        raise ValueError(
            f"flat accumulate wants idx and val of one shape (m,), got "
            f"{tuple(idx.shape)} and {tuple(val.shape)}"
        )
    ident = reduce_identity(op, val.dtype)
    m = idx.shape[0]
    if m == 0:
        return torch.full((num_indices,), ident, dtype=val.dtype, device=val.device)
    if num_bins * bin_range < num_indices:
        raise ValueError("accumulator must cover the domain: num_bins * bin_range < num_indices")
    if idx.device.type == "cpu":
        return scatter_reduce_ref(idx, val, num_indices, op=op)
    _lib.require_cuda(idx, torch.int32, "idx")
    if val.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused kernel takes float32 or int32 values, got {val.dtype}")
    _lib.require_cuda(val, val.dtype, "val")
    _lib.check_int32_size(m, "stream length")
    _lib.check_int32_size(num_indices, "num_indices")
    out = torch.full((num_indices,), ident, dtype=val.dtype, device=val.device)
    lib = _lib.load()
    _lib.check(
        lib.pb_fused_accumulate(
            idx.data_ptr(), val.data_ptr(), m, out.data_ptr(), num_indices,
            bin_range, num_bins, _OP_CODE[op], _DTYPE_CODE[val.dtype],
            _lib.stream(idx),
        ),
        "cobra_bin_accumulate kernel",
    )
    cobra_bin_accumulate.launches += 1
    return out


cobra_bin_accumulate.launches = 0


def cobra_bin_accumulate_rows(
    idx: torch.Tensor,
    val: torch.Tensor,
    num_indices: int,
    bin_range: int,
    num_bins: int,
    op: str = "add",
    f_tile: int | None = None,
) -> torch.Tensor:
    """Dense ``(num_indices, F)`` reduction of a row-block stream; untouched
    rows hold ``reduce_identity(op, val.dtype)``.

    ``f_tile`` is the reference's feature-tile width (a TPU VMEM fit). It
    is checked (``1 <= f_tile <= F``) and otherwise has no effect: the
    kernel reads each row once, whole, with as many lanes as the row needs
    (``csrc/fused_rows.cu``). ``bin_range`` and ``num_bins`` are checked
    to cover the domain, as the reference asserts, and play no other part
    (the accumulator is global memory).
    """
    if op not in FUSED_OPS:
        raise ValueError(f"fused accumulate needs a commutative op, got {op!r}")
    if val.ndim != 2 or idx.ndim != 1 or idx.shape[0] != val.shape[0]:
        raise ValueError(
            f"row-block accumulate wants idx (m,) and val (m, F), got "
            f"{tuple(idx.shape)} and {tuple(val.shape)}"
        )
    m, F = val.shape
    ident = reduce_identity(op, val.dtype)
    if m == 0 or F == 0:
        return torch.full((num_indices, F), ident, dtype=val.dtype, device=val.device)
    if num_bins * bin_range < num_indices:
        raise ValueError("accumulator must cover the domain: num_bins * bin_range < num_indices")
    if f_tile is not None and not 1 <= int(f_tile) <= F:
        raise ValueError(f"f_tile {f_tile} out of range for F={F}")
    if idx.device.type == "cpu":
        return scatter_reduce_ref(idx, val, num_indices, op=op)
    _lib.require_cuda(idx, torch.int32, "idx")
    if val.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused kernel takes float32 or int32 values, got {val.dtype}")
    _lib.require_cuda(val, val.dtype, "val")
    _lib.check_int32_size(m, "stream length")
    _lib.check_int32_size(num_indices, "num_indices")
    _lib.check_int32_size(F, "feature width")
    out = torch.full((num_indices, F), ident, dtype=val.dtype, device=val.device)
    lib = _lib.load()
    _lib.check(
        lib.pb_fused_accumulate_rows(
            idx.data_ptr(), val.data_ptr(), m, F, out.data_ptr(), num_indices,
            _OP_CODE[op], _DTYPE_CODE[val.dtype], _lib.stream(idx),
        ),
        "cobra_bin_accumulate_rows kernel",
    )
    cobra_bin_accumulate_rows.launches += 1
    return out


cobra_bin_accumulate_rows.launches = 0

"""Fused bin-and-accumulate wrapper (port of ``repro/kernels/fused.py``).

``cobra_bin_accumulate`` reduces one flat ``(idx, val)`` stream by add,
min or max into a dense ``(num_indices,)`` output. On a CPU tensor it
runs its plain version ``ref.scatter_reduce_ref``; on a CUDA tensor one
of the two designs of ``csrc/fused.cu`` (``fused_design``). Both drop
indices outside ``[0, num_indices)``, negative ones included, as the
Pallas kernel does.

- ``"two-pass"``: propagation blocking on the card. The index range is
  cut into slabs of ``2^shift`` entries (``fused_plan``: about two slabs
  per SM, at most ``SLAB_MAX`` = 32768 so a slab's accumulator fits in
  128 KB of shared memory and an offset in 16 bits). A binning pass
  groups the tuples by slab (a slab count, then the one-pass look-back
  core of ``csrc/pb_onesweep.cuh``) into a scratch stream of 6 bytes a
  tuple; an accumulate pass reduces each slab in shared memory and
  writes it out with coalesced stores. A slab that holds more than
  ``chunk`` tuples (twice the mean) is cut into chunks, each reduced by
  its own block and merged into ``out``. No global atomic per tuple.
- ``"single-sweep"``: one kernel that groups each 2048-tuple tile by bin
  in shared memory and applies one atomic per distinct index to an
  L2-resident ``out``.

Design rule: two-pass when ``m >= TWO_PASS_MIN_M`` and ``num_indices <=
TWO_PASS_MAX_INDICES`` (2048 slabs of 32768, the look-back core's bin
limit); single sweep otherwise. TWO_PASS_MIN_M = 2^22 is the measured
crossover on the H100 (PERF.md; ``scripts/torch_pb_kernels.py``):
on uniform streams of m tuples into m / 8 indices the two designs tie at
2^21 and the two-pass design wins by 16-44% from 2^22 to 2^24; fig5's S1
graphs (2^21 tuples, KRON and DBP skew) run 2.4-2.7 times faster in the
single sweep, whose L2-resident output absorbs the hubs.

Fit rule: ``bin_range`` and ``num_bins`` must cover the domain, as the
reference asserts; the single sweep groups by them, the two-pass design
picks its own slab (a fact of shared memory, as the reference's bin range
is a fact of VMEM). Otherwise the only limits are int32 addressing of the
output and the stream. (The reference's 32 MiB / 4096-bin limits are TPU
VMEM facts and do not apply.)

Tolerance: int32 results and every min/max result are exact in both
designs. A float32 add sums in an order that changes from run to run
(shared-memory atomics within a slab, warp shuffles where a warp's
tuples share an index, global atomics where a split slab's chunks merge,
L2 atomics in the single sweep); against a sequential sum the difference
is bounded by about ``(k - 1) * eps * sum(|v|)`` for an index that
receives k tuples (eps = 2**-24), so comparisons allow 1e-5 * sum(|v|)
per index: with cancelling signs the result itself can be far smaller
than that sum.

``cobra_bin_accumulate_rows`` is the row-block (SpMM) form: ``(m, F)``
values reduced into ``(num_indices, F)`` by ``csrc/fused_rows.cu`` on a
CUDA tensor, in one of the two walks of ``csrc/pb_rows.cuh``
(``rows_design``): ``"narrow"``, a warp-cooperative segmented scan for
rows of at most four lanes (F <= 16 with 16-byte rows), and ``"tile"``
for wider rows (a block stages a 512-row tile's indices, sorts them by
destination unless they already are, and applies each run with float4
reductions for a float32 add). On a CPU tensor the same plain version
runs, with the same index rule and tolerances (per column). Row offsets
are 64-bit, so only
m and num_indices, not m * F, must fit int32. bfloat16 rows (the MoE
combine) are read as bfloat16, reduced in float32 into a float32
accumulator and rounded once to bfloat16 (round to nearest even); the
plain version does the same. So a bfloat16 result is the float32 result's
rounding: it differs from the plain one by at most one bfloat16 step
(at most 2^-7 relative) where the float32 sums differ by the add tolerance above
across a rounding boundary, and is exact for min and max.
"""
from __future__ import annotations

import torch

from repro_torch.core.pb import reduce_identity
from repro_torch.kernels import _lib
from repro_torch.kernels.ref import scatter_reduce_ref

FUSED_OPS = ("add", "min", "max")
_OP_CODE = {"add": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}
ROW_DTYPES = (torch.float32, torch.int32, torch.bfloat16)  # bfloat16: the rows kernel only
ROWS_NARROW_MAX_LANES = 4  # csrc/pb_rows.cuh: kSegMaxLpr


FUSED_DESIGNS = ("two-pass", "single-sweep")
_FUSED_CODE = {"single-sweep": 0, "two-pass": 1}
TWO_PASS_MIN_M = 1 << 22  # the measured crossover (PERF.md)
SLAB_MIN, SLAB_MAX = 256, 32768  # csrc/fused.cu: 16-bit offsets, 128 KB accumulator
TWO_PASS_MAX_SLABS = 2048  # csrc/pb_onesweep.cuh: kMaxBins
TWO_PASS_MAX_INDICES = SLAB_MAX * TWO_PASS_MAX_SLABS
CHUNK_MIN = 4096


def fused_design(m: int, num_indices: int) -> str:
    """The design ``cobra_bin_accumulate`` runs on the card for m tuples."""
    if m >= TWO_PASS_MIN_M and num_indices <= TWO_PASS_MAX_INDICES:
        return "two-pass"
    return "single-sweep"


def fused_plan(m: int, num_indices: int, sms: int) -> tuple:
    """``(shift, num_slabs, chunk)`` of the two-pass design: slabs of
    ``2^shift`` indices, about two per SM, within [SLAB_MIN, SLAB_MAX];
    a slab holding more than ``chunk`` tuples (twice the mean, at least
    CHUNK_MIN) is reduced in chunks of that many."""
    want = max(1, -(-num_indices // (2 * sms)))
    shift = min(max((want - 1).bit_length(), SLAB_MIN.bit_length() - 1),
                SLAB_MAX.bit_length() - 1)
    slabs = -(-num_indices // (1 << shift))
    chunk = max(2 * -(-m // slabs), CHUNK_MIN)
    return shift, slabs, chunk


def cobra_bin_accumulate(
    idx: torch.Tensor,
    val: torch.Tensor,
    num_indices: int,
    bin_range: int,
    num_bins: int,
    op: str = "add",
    design: str | None = None,
) -> torch.Tensor:
    """Dense ``(num_indices,)`` reduction of a flat stream; untouched
    indices hold ``reduce_identity(op, val.dtype)``. ``design``
    (``FUSED_DESIGNS``) forces a kernel on the card; None takes
    ``fused_design(m, num_indices)``."""
    if op not in FUSED_OPS:
        raise ValueError(f"fused accumulate needs a commutative op, got {op!r}")
    if val.ndim != 1 or idx.shape != val.shape:
        raise ValueError(
            f"flat accumulate wants idx and val of one shape (m,), got "
            f"{tuple(idx.shape)} and {tuple(val.shape)}"
        )
    ident = reduce_identity(op, val.dtype)
    m = idx.shape[0]
    design = fused_design(m, num_indices) if design is None else design
    if design not in FUSED_DESIGNS:
        raise ValueError(f"design must be one of {FUSED_DESIGNS}, got {design!r}")
    if design == "two-pass" and num_indices > TWO_PASS_MAX_INDICES:
        raise ValueError(
            f"the two-pass design takes at most {TWO_PASS_MAX_INDICES} indices, got {num_indices}")
    if m == 0:
        return torch.full((num_indices,), ident, dtype=val.dtype, device=val.device)
    if num_bins * bin_range < num_indices:
        raise ValueError("accumulator must cover the domain: num_bins * bin_range < num_indices")
    if idx.device.type == "cpu":
        return scatter_reduce_ref(idx, val, num_indices, op=op)
    if idx.device.type == "meta":  # the dry run's shape-only route (_lib.meta_call)
        _lib.meta_call(cobra_bin_accumulate, m, 4 * m + val.element_size() * (m + num_indices))
        return torch.empty((num_indices,), dtype=val.dtype, device=val.device)
    _lib.require_cuda(idx, torch.int32, "idx")
    if val.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused kernel takes float32 or int32 values, got {val.dtype}")
    _lib.require_cuda(val, val.dtype, "val")
    _lib.check_int32_size(m, "stream length")
    _lib.check_int32_size(num_indices, "num_indices")
    lib = _lib.load()
    shift, chunk, scratch = 0, 0, None  # the single sweep needs no scratch
    if design == "two-pass":
        shift, _, chunk = fused_plan(m, num_indices, _lib.num_sms(val.device.index or 0))
        out = torch.empty((num_indices,), dtype=val.dtype, device=val.device)
        scratch = torch.empty(lib.pb_fused_scratch(m, num_indices, shift), dtype=torch.uint8,
                              device=val.device)
    else:
        out = torch.full((num_indices,), ident, dtype=val.dtype, device=val.device)
    _lib.check(
        lib.pb_fused_accumulate(
            idx.data_ptr(), val.data_ptr(), m, out.data_ptr(), num_indices,
            bin_range, num_bins, _OP_CODE[op], _DTYPE_CODE[val.dtype], _FUSED_CODE[design],
            shift, chunk, None if scratch is None else scratch.data_ptr(), _lib.stream(idx),
        ),
        "cobra_bin_accumulate kernel",
    )
    _lib.count_launch(cobra_bin_accumulate, (m, num_indices))
    return out


cobra_bin_accumulate.launches, cobra_bin_accumulate.shapes = 0, {}


def rows_design(F: int, aligned: bool = True) -> str:
    """The walk ``csrc/pb_rows.cuh``'s ``launch_rows`` takes for rows of F
    columns: 4 columns a lane where F % 4 == 0 and the rows are ``aligned``
    (16 bytes for float32 and int32, 8 for bfloat16), else 1; lanes a row
    the next power of two of a row's lane-columns, at most 32; the narrow
    walk up to ROWS_NARROW_MAX_LANES lanes, the tile walk above."""
    cols = F // 4 if F % 4 == 0 and aligned else F
    lanes = 1
    while lanes < cols and lanes < 32:
        lanes <<= 1
    return "narrow" if lanes <= ROWS_NARROW_MAX_LANES else "tile"


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
    if val.dtype not in ROW_DTYPES:
        raise ValueError(f"the rows kernel takes {ROW_DTYPES} values, got {val.dtype}")
    _lib.check_int32_size(m, "stream length")
    _lib.check_int32_size(num_indices, "num_indices")
    _lib.check_int32_size(F, "feature width")
    if idx.device.type == "meta":  # the dry run's shape-only route (_lib.meta_call)
        esize = val.element_size()
        _lib.meta_call(cobra_bin_accumulate_rows, m * F, 4 * m + esize * (m + num_indices) * F)
        # the bfloat16 kernel's float32 accumulator lives beside its output
        acc = (torch.empty((num_indices, F), dtype=torch.float32, device=val.device)
               if val.dtype == torch.bfloat16 else None)
        out = torch.empty((num_indices, F), dtype=val.dtype, device=val.device)
        del acc
        return out
    _lib.require_cuda(idx, torch.int32, "idx")
    _lib.require_cuda(val, val.dtype, "val")
    lib = _lib.load()
    if val.dtype == torch.bfloat16:
        acc = torch.full((num_indices, F), ident, dtype=torch.float32, device=val.device)
        out = torch.empty((num_indices, F), dtype=torch.bfloat16, device=val.device)
        status = lib.pb_fused_accumulate_rows_bf16(
            idx.data_ptr(), val.data_ptr(), m, F, acc.data_ptr(), out.data_ptr(), num_indices,
            _OP_CODE[op], _lib.stream(idx),
        )
    else:
        out = torch.full((num_indices, F), ident, dtype=val.dtype, device=val.device)
        status = lib.pb_fused_accumulate_rows(
            idx.data_ptr(), val.data_ptr(), m, F, out.data_ptr(), num_indices,
            _OP_CODE[op], _DTYPE_CODE[val.dtype], _lib.stream(idx),
        )
    _lib.check(status, "cobra_bin_accumulate_rows kernel")
    _lib.count_launch(cobra_bin_accumulate_rows, (m, F, num_indices))
    return out


cobra_bin_accumulate_rows.launches, cobra_bin_accumulate_rows.shapes = 0, {}

"""PBExecutor — the slice's part of ``repro/core/executor.py``.

Every irregular-update stream goes through here, and the executor picks
the *method*:

  ``sort``          stable sort by bin id (``pb.binning_sort``);
  ``counting``      stable counting sort (``pb.binning_counting``);
  ``pallas``        the kernel-backed counting method: histogram +
                    positions kernels + a permutation apply
                    (``kernels.ops.pb_binning``); the name is kept so
                    decisions match the reference's;
  ``hierarchical``  multi-pass COBRA (``core.cobra``) driven by a
                    ``CobraPlan``;
  ``fused``         (reductions only) single-sweep bin-and-accumulate,
                    ``kernels.fused.cobra_bin_accumulate``.

Kernels run because the tensors are on CUDA: the reference's gate,
``interpret = jax.default_backend() != "tpu"``, has no counterpart. On CPU
tensors each kernel's plain version runs. Decisions follow the
reference's priority (cache -> fallback table -> analytic model) under an
H100 ``HardwareModel`` by default.

Not ported in this slice (ROADMAP.md, Queue 1 item 3): the autotuner
(``autotune=True`` raises), batched streams, the sharded path, the
``update`` decision kind, the stream-contract check and
``dispatch_permutation``; the row-block fused kernel (Queue 2).
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, replace as _dc_replace
from typing import Optional, Tuple

import torch

from repro_torch.core import pb
from repro_torch.core.cobra import hierarchical_binning
from repro_torch.core.plan import (
    CobraPlan,
    HardwareModel,
    binning_optimal_num_bins,
    compromise_bin_range,
    num_bins_for_range,
)

METHODS = ("sort", "counting", "pallas", "hierarchical")
REDUCE_METHODS = METHODS + ("fused",)
REDUCE_OPS = ("add", "min", "max")

# Below this stream length a stable sort is latency-bound and wins.
_SORT_THRESHOLD = 4096

# decision_log is a bounded trace, not an audit trail.
_DECISION_LOG_CAP = 512

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1 item 3)"


# ---------------------------------------------------------------------------
# Functional core: method chosen by the caller.
# ---------------------------------------------------------------------------


def execute_binning(
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    bin_range: int,
    num_bins: int,
    method: str = "sort",
    plan: Optional[CobraPlan] = None,
) -> pb.Bins:
    """Bin one (indices, values) stream with the given method. Every
    method is a stable partition by ``indices // bin_range``, so all four
    give the same stream."""
    if method not in METHODS:
        raise ValueError(f"unknown binning method: {method!r} (want one of {METHODS})")
    if indices.shape[0] == 0:
        nb = plan.num_bins if (method == "hierarchical" and plan) else num_bins
        return pb.Bins(
            idx=indices,
            val=values,
            starts=torch.zeros(nb + 1, dtype=torch.int32, device=indices.device),
            bin_range=bin_range,
        )
    if method == "sort":
        return pb.binning_sort(indices, values, bin_range, num_bins)
    if method == "counting":
        return pb.binning_counting(indices, values, bin_range, num_bins)
    if method == "pallas":
        if not (isinstance(values, torch.Tensor) and values.ndim == 1):
            raise ValueError("pallas binning supports a single 1-D value array")
        from repro_torch.kernels import ops  # deferred: kernels import core.pb

        return ops.pb_binning(indices, values, bin_range=bin_range, num_bins=num_bins)
    if plan is None:
        raise ValueError("hierarchical binning needs a CobraPlan")
    return hierarchical_binning(indices, values, plan)


def _fused_reduce_plain(
    indices: torch.Tensor, values: torch.Tensor, out_size: int, op: str
) -> torch.Tensor:
    """The plain counterpart of the reference's ``_fused_reduce_jnp`` for
    CPU tensors: one vectorised ``index_add_`` / ``scatter_reduce_`` into
    an identity-filled output; indices outside ``[0, out_size)`` dropped."""
    vshape = pb.value_block_shape(values)
    out = torch.full(
        (out_size,) + vshape,
        pb.reduce_identity(op, values.dtype),
        dtype=values.dtype,
        device=values.device,
    )
    if indices.shape[0] == 0:
        return out
    return pb.scatter_reduce_into(out, indices, values, op)


def execute_reduce(
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    out_size: int,
    op: str = "add",
    method: str = "fused",
    bin_range: Optional[int] = None,
    num_bins: Optional[int] = None,
    plan: Optional[CobraPlan] = None,
) -> torch.Tensor:
    """Reduce one (indices, values) stream to a dense (out_size, ...) tensor.

    The binning methods run two-phase (``execute_binning`` then
    ``pb.bin_read_reduce``). ``fused`` launches the fused kernel when the
    tensors are on CUDA (flat values; the row-block kernel is not ported
    and raises) and runs the plain single call on CPU tensors.
    """
    if op not in REDUCE_OPS:
        raise ValueError(
            f"reduce_stream only serves commutative reductions {REDUCE_OPS}; "
            f"got op={op!r}. Non-commutative consumers need the stable "
            "two-phase path: bin_stream() + an order-aware Bin-Read."
        )
    if method not in REDUCE_METHODS:
        raise ValueError(f"unknown reduce method: {method!r} (want one of {REDUCE_METHODS})")
    r = bin_range or max(1, min(512, out_size))
    nb = num_bins or -(-out_size // r)
    if method == "fused":
        vshape = pb.value_block_shape(values)
        if indices.device.type != "cuda":
            return _fused_reduce_plain(indices, values, out_size, op)
        if vshape != ():
            raise NotImplementedError(
                "fused reduce of row-block (m, F) values on CUDA: the rows kernel "
                "(cobra_bin_accumulate_rows_pallas) is not ported yet "
                "(ROADMAP.md, Queue 2 item 5)"
            )
        from repro_torch.kernels.fused import cobra_bin_accumulate

        return cobra_bin_accumulate(
            indices, values, num_indices=out_size, bin_range=r, num_bins=nb, op=op
        )
    bins = execute_binning(
        indices, values, bin_range=r, num_bins=nb, method=method, plan=plan
    )
    if bins.idx.shape[0] == 0:
        return torch.full(
            (out_size,) + tuple(values.shape[1:]),
            pb.reduce_identity(op, values.dtype),
            dtype=values.dtype,
            device=values.device,
        )
    return pb.bin_read_reduce(bins, out_size, op=op, out_dtype=values.dtype)


# ---------------------------------------------------------------------------
# Decisions, fallback table, decision cache.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BinningDecision:
    """What the executor chose for one stream shape, and why."""

    method: str
    bin_range: int
    num_bins: int
    plan: Optional[CobraPlan]
    source: str  # analytic | fallback-table | cache | caller
    f_tile: int = 0

    def describe(self) -> str:
        ft = f"/f{self.f_tile}" if self.f_tile else ""
        return f"{self.method}@r{self.bin_range}{ft}[{self.source}]"


def _bucket(x: int) -> int:
    return max(0, int(math.log2(x))) if x > 0 else 0


# (log2 num_indices, log2 stream_len) -> method. Copied from the
# reference so decisions match; it was measured on a CPU (interpret-mode
# JAX) and is to be re-measured on the card (ROADMAP.md, Queue 1).
_FALLBACK_TABLE = {
    (8, 10): "sort",
    (8, 12): "sort",
    (10, 12): "sort",
    (10, 14): "counting",
    (12, 14): "counting",
    (12, 16): "counting",
    (14, 16): "hierarchical",
    (14, 18): "hierarchical",
    (16, 17): "hierarchical",
    (16, 18): "hierarchical",
    (16, 20): "hierarchical",
    (18, 20): "hierarchical",
    (20, 22): "hierarchical",
}

_CACHE_SCHEMA_VERSION = 1


class _DecisionCache:
    """Measured decisions, read from ``<cache_dir>/autotune.json``.

    The port's own namespace (``REPRO_TORCH_CACHE_DIR`` or
    ``~/.cache/repro_torch``), never the reference's, so a decision made
    by JAX on a CPU is never replayed on the card. The autotuner that
    writes entries is not ported yet, so this slice only reads.
    """

    def __init__(self, cache_dir: Optional[str] = None):
        self.dir = (
            cache_dir
            or os.environ.get("REPRO_TORCH_CACHE_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache", "repro_torch")
        )
        self.path = os.path.join(self.dir, "autotune.json")
        self.mem: dict = {}
        try:
            with open(self.path) as f:
                blob = json.load(f)
            if isinstance(blob, dict) and blob.get("version") == _CACHE_SCHEMA_VERSION:
                self.mem.update(blob.get("entries", {}))
        except (OSError, ValueError):
            pass  # no cache yet, or a torn file: decide without it

    def get(self, key: str) -> Optional[dict]:
        return self.mem.get(key)


def _device_tag(device: torch.device) -> str:
    """``torch:<type>:<name>`` — the device part of a cache key."""
    if device.type == "cuda" and torch.cuda.is_available():
        return f"torch:cuda:{torch.cuda.get_device_name(device)}"
    return f"torch:{device.type}"


# ---------------------------------------------------------------------------
# The executor.
# ---------------------------------------------------------------------------


class PBExecutor:
    """Plan-driven PB execution under a ``HardwareModel`` (default: H100).

    ``use_pallas=True`` adds the kernel-backed ``pallas`` binning method to
    the candidate set, as ``REPRO_PB_USE_PALLAS=1`` does for the default
    executor.
    """

    def __init__(
        self,
        hw: Optional[HardwareModel] = None,
        *,
        autotune: bool = False,
        cache_dir: Optional[str] = None,
        use_pallas: bool = False,
    ):
        if autotune:
            raise NotImplementedError(f"autotune=True: the measured autotuner is {_NOT_PORTED}")
        self.hw = hw or HardwareModel.h100()
        self.use_pallas = use_pallas
        self.cache = _DecisionCache(cache_dir)
        self.decision_log: list = []

    # -- decision ----------------------------------------------------------

    def _key(
        self,
        num_indices: int,
        stream_len: int,
        dtype: torch.dtype,
        bin_range: Optional[int],
        kind: str,
        op: str,
        feature_dim: int,
        device: torch.device,
    ) -> str:
        sl = f"b{_bucket(stream_len)}" if kind != "bin" else str(stream_len)
        dt = str(dtype).replace("torch.", "")
        base = f"{num_indices}:{sl}:{dt}:{_device_tag(device)}:d1"
        if kind != "bin":
            base = f"{base}:{kind}:{op}"
            if feature_dim > 1:
                base = f"{base}:f{feature_dim}"
        return f"{base}:r{bin_range}" if bin_range else base

    def _candidates(self, flat_values: bool, kind: str = "bin") -> Tuple[str, ...]:
        c = ["sort", "counting"]
        if self.use_pallas and flat_values:
            c.append("pallas")
        c.append("hierarchical")
        if kind == "reduce":
            c.append("fused")
        return tuple(c)

    def _finalize(
        self, method: str, num_indices: int, bin_range: Optional[int], source: str
    ) -> BinningDecision:
        """Attach the range/plan to a chosen method: flat methods run at the
        compromise range unless the caller fixed one; hierarchical ends at
        the Bin-Read-optimal range."""
        if method == "hierarchical":
            plan = CobraPlan.from_hardware(num_indices, self.hw, final_bin_range=bin_range)
            return BinningDecision(method, plan.final_bin_range, plan.num_bins, plan, source)
        r = bin_range or max(1, min(compromise_bin_range(num_indices, self.hw), num_indices))
        return BinningDecision(method, r, num_bins_for_range(num_indices, r), None, source)

    def analytic_method(
        self, num_indices: int, stream_len: int, bin_range: Optional[int] = None
    ) -> str:
        """The analytic decision tree, evaluated at the effective range."""
        if stream_len < _SORT_THRESHOLD or num_indices <= 1:
            return "sort"
        r = bin_range or max(1, min(compromise_bin_range(num_indices, self.hw), num_indices))
        if num_bins_for_range(num_indices, r) <= binning_optimal_num_bins(self.hw):
            return "pallas" if self.use_pallas else "counting"
        return "hierarchical"

    def fused_fits(self, num_indices: int, value_bytes: int = 4) -> bool:
        """The dense accumulator must fit half the largest fast level: on
        the H100 model, half the L2, where the fused kernel's atomics land."""
        return num_indices * value_bytes <= self.hw.fast_levels[-1] // 2

    def analytic_reduce_method(
        self,
        num_indices: int,
        stream_len: int,
        bin_range: Optional[int] = None,
        value_bytes: int = 4,
    ) -> str:
        if self.fused_fits(num_indices, value_bytes):
            return "fused"
        return self.analytic_method(num_indices, stream_len, bin_range)

    def choose_f_tile(
        self, feature_dim: int, num_indices: int, itemsize: int = 4, cap: int = 512
    ) -> int:
        """Widest power-of-two feature tile whose accumulator plus C-Buffer
        rows fit half the fast level, at most 128; 0 for scalar streams."""
        if feature_dim <= 0:
            return 0
        budget = self.hw.fast_levels[-1] // 2
        per_col = max(1, num_indices + cap * max(1, num_indices // 512)) * itemsize
        max_ft = max(1, budget // per_col)
        ft = min(feature_dim, max_ft, 128)
        return 1 << (int(ft).bit_length() - 1)

    def decide(
        self,
        num_indices: int,
        stream_len: int,
        dtype: torch.dtype = torch.int32,
        *,
        bin_range: Optional[int] = None,
        flat_values: bool = True,
        kind: str = "bin",
        op: str = "add",
        feature_dim: int = 0,
        device: Optional[torch.device] = None,
    ) -> BinningDecision:
        """Pick (method, bin_range, plan) for a stream shape. Priority:
        cache -> fallback table -> analytic model. ``kind`` is "bin" or
        "reduce"; ``dtype`` is the value dtype for reductions. ``device``
        names the cache key's device (default: the card)."""
        if kind not in ("bin", "reduce"):
            raise NotImplementedError(f"decision kind {kind!r}: {_NOT_PORTED}")
        dev = torch.device("cuda") if device is None else torch.device(device)
        key = self._key(num_indices, stream_len, dtype, bin_range, kind, op, feature_dim, dev)
        d = self._decide_uncached(
            key, num_indices, stream_len, dtype, bin_range, flat_values, kind, feature_dim
        )
        if kind == "reduce" and feature_dim:
            d = _dc_replace(
                d, f_tile=self.choose_f_tile(feature_dim, num_indices, dtype.itemsize)
            )
        entry = {
            "kind": kind,
            "num_indices": num_indices,
            "stream_len": stream_len,
            "method": d.method,
            "bin_range": d.bin_range,
            "source": d.source,
        }
        if kind != "bin":
            entry["op"] = op
        if feature_dim:
            entry["feature_dim"] = feature_dim
            entry["f_tile"] = d.f_tile
        if len(self.decision_log) < _DECISION_LOG_CAP:
            self.decision_log.append(entry)
        return d

    def decide_or_forced(
        self,
        method: Optional[str],
        num_indices: int,
        stream_len: int,
        dtype: torch.dtype = torch.int32,
        *,
        bin_range: Optional[int] = None,
        flat_values: bool = True,
        kind: str = "bin",
        op: str = "add",
        feature_dim: int = 0,
        device: Optional[torch.device] = None,
    ) -> BinningDecision:
        """``decide`` for ``None``/"auto", else the caller's method
        finalized at this shape."""
        if method in (None, "auto"):
            return self.decide(
                num_indices, stream_len, dtype, bin_range=bin_range,
                flat_values=flat_values, kind=kind, op=op, feature_dim=feature_dim,
                device=device,
            )
        d = self._finalize(method, num_indices, bin_range, "caller")
        if kind == "reduce" and feature_dim:
            d = _dc_replace(
                d, f_tile=self.choose_f_tile(feature_dim, num_indices, dtype.itemsize)
            )
        return d

    def _decide_uncached(
        self, key, num_indices, stream_len, dtype, bin_range, flat_values, kind,
        feature_dim: int = 0,
    ) -> BinningDecision:
        hit = self.cache.get(key)
        if hit is not None and hit.get("method") in self._candidates(flat_values, kind):
            return self._finalize(hit["method"], num_indices, bin_range, "cache")
        # the table is bucketed on the default (compromise) range and holds
        # binning decisions only
        if bin_range is None and kind == "bin":
            m = _FALLBACK_TABLE.get((_bucket(num_indices), _bucket(stream_len)))
            if m is not None and m in self._candidates(flat_values, kind):
                return self._finalize(m, num_indices, bin_range, "fallback-table")
        if kind != "bin":
            isz = dtype.itemsize
            ft = self.choose_f_tile(feature_dim, num_indices, isz)
            analytic = self.analytic_reduce_method(
                num_indices, stream_len, bin_range, value_bytes=max(1, ft) * isz
            )
        else:
            analytic = self.analytic_method(num_indices, stream_len, bin_range)
        return self._finalize(analytic, num_indices, bin_range, "analytic")

    # -- execution ---------------------------------------------------------

    def bin_stream(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        num_indices: int,
        bin_range: Optional[int] = None,
        method: Optional[str] = None,
    ) -> pb.Bins:
        """Bin one stream: ``method=None``/"auto" consults ``decide``."""
        flat = isinstance(values, torch.Tensor) and values.ndim == 1
        if method in (None, "auto"):
            d = self.decide(
                num_indices, int(indices.shape[0]), indices.dtype,
                bin_range=bin_range, flat_values=flat, device=indices.device,
            )
        else:
            d = self._finalize(method, num_indices, bin_range, "caller")
        b = execute_binning(
            indices, values, bin_range=d.bin_range, num_bins=d.num_bins,
            method=d.method, plan=d.plan,
        )
        return pb.Bins(b.idx, b.val, b.starts, d.bin_range)

    def reduce_stream(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        out_size: int,
        op: str = "add",
        bin_range: Optional[int] = None,
        method: Optional[str] = None,
        kind: str = "reduce",
    ) -> torch.Tensor:
        """Reduce one commutative stream to a dense (out_size, ...) tensor;
        ``method=None``/"auto" consults ``decide`` with the reduce
        candidate set (which includes ``fused``)."""
        if op not in REDUCE_OPS:
            raise ValueError(
                f"reduce_stream only serves commutative reductions {REDUCE_OPS}; "
                f"got op={op!r}. Non-commutative consumers need the stable "
                "two-phase path: bin_stream() + an order-aware Bin-Read."
            )
        if kind != "reduce":
            raise NotImplementedError(f"reduce_stream kind {kind!r}: {_NOT_PORTED}")
        vshape = pb.value_block_shape(values)
        flat = vshape == ()
        feat = vshape[0] if vshape else 0
        if method in (None, "auto"):
            d = self.decide(
                out_size, int(indices.shape[0]), values.dtype, bin_range=bin_range,
                flat_values=flat, kind=kind, op=op, feature_dim=feat,
                device=indices.device,
            )
        else:
            d = self._finalize(method, out_size, bin_range, "caller")
        if not flat and d.method == "pallas":
            # pallas binning is 1-D-only; row values take the sort path
            d = self._finalize("sort", out_size, bin_range, d.source)
        return execute_reduce(
            indices, values, out_size=out_size, op=op, method=d.method,
            bin_range=d.bin_range, num_bins=d.num_bins, plan=d.plan,
        )

    def scatter_add(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        out_size: int,
        bin_range: Optional[int] = None,
        method: Optional[str] = None,
    ) -> torch.Tensor:
        """Full PB scatter-add, routed through ``reduce_stream``."""
        return self.reduce_stream(
            indices, values, out_size=out_size, op="add", bin_range=bin_range, method=method
        )


_DEFAULT: Optional[PBExecutor] = None


def get_default_executor() -> PBExecutor:
    """Process-wide executor (H100 model). ``REPRO_PB_USE_PALLAS=1`` adds
    the kernel-backed ``pallas`` method to the candidates."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = PBExecutor(
            autotune=os.environ.get("REPRO_PB_AUTOTUNE", "0") == "1",
            use_pallas=os.environ.get("REPRO_PB_USE_PALLAS", "0") == "1",
        )
    return _DEFAULT


def set_default_executor(ex: Optional[PBExecutor]) -> None:
    """Swap the process-wide executor (tests, chip_smoke.py)."""
    global _DEFAULT
    _DEFAULT = ex

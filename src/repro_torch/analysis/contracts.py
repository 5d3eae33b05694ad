"""Runtime contract checker for PB reduce streams (port of
``repro/analysis/contracts.py``).

The contract between the partitioner and the kernel: indices in bounds,
bins covering the domain, the fused reduce within what its kernel takes,
and the caller's order and bounds *claims* true of the stream.
``check_stream`` runs inside ``PBExecutor.reduce_stream`` and
``shard_reduce_stream`` on every call.

Two levels:

  cheap  — always on. Shapes, dtypes and the decision object only:
      value rank, stream length, bin-range legality, the fused fit,
      cache-key completeness. It reads no tensor data, so it never
      synchronises with the card.
  full   — ``REPRO_PB_CHECK=1``. Also verifies the data-dependent claims
      (the in-bounds promise and the sortedness claim), computed on the
      tensor's own device; only the scalar verdicts come back to the
      host. ``meta`` tensors and tensors without storage (the dry run's)
      hold no data and are skipped, as the reference skips a JAX tracer.

Violations raise :class:`ContractError` carrying the decision's
``describe()`` string, so the failure names what the executor chose.
The invariant names are the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch

from repro_torch.core import pb
from repro_torch.core.plan import fused_fits

_INDEX_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


class ContractError(ValueError):
    """A PB stream/decision contract violation. ``invariant`` is a stable
    machine-readable name of the violated clause; the message carries the
    decision's ``describe()``."""

    def __init__(self, invariant: str, message: str):
        self.invariant = invariant
        super().__init__(f"[{invariant}] {message}")


def check_level() -> str:
    """``"full"`` when ``REPRO_PB_CHECK=1``, else ``"cheap"``; read per
    call so tests can flip the variable."""
    return "full" if os.environ.get("REPRO_PB_CHECK", "0") == "1" else "cheap"


def _holds_no_data(x: torch.Tensor) -> bool:
    """A ``meta`` tensor, or one without storage (a functional or
    subclass tensor of a trace): nothing to read."""
    if x.device.type == "meta":
        return True
    try:
        return x.untyped_storage().device.type == "meta"
    except (RuntimeError, NotImplementedError):
        return True


# ---------------------------------------------------------------------------
# Cache-key completeness (introspective).
# ---------------------------------------------------------------------------

# How each BinningDecision field is covered by the persisted decision-cache
# key: in the key (``token``: a substring the executor source must render),
# derived from keyed inputs, the decision itself, or its provenance.
_KEY_COVERAGE = {
    "method": {"how": "output"},
    "bin_range": {"how": "key", "token": ":r"},
    "num_bins": {"how": "derived"},  # num_indices / bin_range, both keyed
    "plan": {"how": "derived"},  # from (hw, num_indices, bin_range)
    "source": {"how": "provenance"},  # cache|autotuned|analytic|caller
    "pipeline_chunks": {"how": "key", "token": ":pipeline"},
    "f_tile": {"how": "key", "token": ":f"},  # via the feature_dim axis
}


@functools.lru_cache(maxsize=8)
def check_cache_key_completeness(decision_cls=None, executor_cls=None) -> None:
    """Fail when a ``BinningDecision`` field has no declared cache-key
    coverage, or a claimed key axis is not rendered by the executor's
    source: a decision measured under one configuration must not be
    replayed under another."""
    import inspect

    if decision_cls is None or executor_cls is None:
        from repro_torch.core.executor import BinningDecision, PBExecutor

        decision_cls = decision_cls or BinningDecision
        executor_cls = executor_cls or PBExecutor

    fields = {f.name for f in dataclasses.fields(decision_cls)}
    unknown = sorted(fields - set(_KEY_COVERAGE))
    if unknown:
        raise ContractError(
            "cache-key-completeness",
            f"decision field(s) {unknown} have no declared cache-key "
            "coverage: extend PBExecutor._key or register the field in "
            "repro_torch.analysis.contracts._KEY_COVERAGE with how it is "
            "covered",
        )
    stale = sorted(set(_KEY_COVERAGE) - fields)
    if stale:
        raise ContractError(
            "cache-key-completeness",
            f"_KEY_COVERAGE claims field(s) {stale} that "
            f"{decision_cls.__name__} no longer carries — registry drift",
        )
    src = inspect.getsource(executor_cls)
    for name, cov in _KEY_COVERAGE.items():
        tok = cov.get("token")
        if tok and tok not in src:
            raise ContractError(
                "cache-key-completeness",
                f"decision field {name!r} claims cache-key token {tok!r} "
                f"but {executor_cls.__name__} source renders no such axis",
            )


# ---------------------------------------------------------------------------
# The stream contract.
# ---------------------------------------------------------------------------


def check_stream(
    indices: torch.Tensor,
    values: torch.Tensor,
    num_nodes: int,
    decision,
    *,
    op: str = "add",
    sorted_within: Optional[int] = None,
    in_bounds: bool = False,
    hw=None,
    level: Optional[str] = None,
    stream_len: Optional[int] = None,
) -> None:
    """Validate one (indices, values) reduce stream against ``decision``.

    Cheap clauses (always): ``stream-length`` (values carry as many
    tuples as indices), ``domain`` (``num_nodes >= 0``), ``bin-range``
    (legal geometry covering ``num_nodes``), ``f-tile`` (no wider than
    the rows), ``fused-fits`` (an *analytic* fused decision passes the
    executor's fit rule ``plan.fused_fits`` under ``hw`` at the
    accumulator's resident columns; ``stream_len``, default the index
    count, is the stream the decision was taken for) and
    ``cache-key-completeness``.

    Full clauses (``level="full"``, skipped for tensors that hold no
    data): ``index-dtype``, ``in-bounds`` (``in_bounds=True`` requires
    every index in ``[0, num_nodes)``) and ``sortedness``
    (``sorted_within=r``: bin ids at granularity ``r`` non-decreasing;
    ``r <= 1``: the indices themselves).
    """
    level = level or check_level()
    desc = decision.describe() if hasattr(decision, "describe") else str(decision)

    # -- cheap: shapes, dtypes and the decision --------------------------
    vshape = pb.value_block_shape(values)  # raises its own typed errors
    m = int(indices.shape[0])
    if int(values.shape[0]) != m:
        raise ContractError(
            "stream-length",
            f"indices carry {m} tuples but values carry "
            f"{int(values.shape[0])} (decision {desc})",
        )
    if num_nodes < 0:
        raise ContractError("domain", f"negative num_nodes={num_nodes} (decision {desc})")
    if decision.bin_range < 1 or decision.num_bins < 1:
        raise ContractError(
            "bin-range",
            f"illegal binning geometry r={decision.bin_range}, "
            f"B={decision.num_bins} (decision {desc})",
        )
    if decision.num_bins * decision.bin_range < num_nodes:
        raise ContractError(
            "bin-range",
            f"bins do not cover the domain: {decision.num_bins} bins x "
            f"range {decision.bin_range} < num_nodes={num_nodes} "
            f"(decision {desc})",
        )
    if decision.f_tile and vshape and decision.f_tile > vshape[0]:
        raise ContractError(
            "f-tile",
            f"f_tile={decision.f_tile} wider than the value rows "
            f"F={vshape[0]} (decision {desc})",
        )
    if decision.method == "fused" and decision.source == "analytic" and hw is not None:
        itemsize = values.dtype.itemsize
        eff_cols = decision.f_tile or (vshape[0] if vshape else 0) or 1
        slen = m if stream_len is None else int(stream_len)
        if not fused_fits(hw, num_nodes, eff_cols * itemsize, slen, flat=not vshape):
            raise ContractError(
                "fused-fits",
                f"analytic fused decision whose accumulator "
                f"({num_nodes * eff_cols * itemsize} B at {eff_cols} resident "
                f"column(s), {slen} tuples) fails the fit rule of {hw.name} "
                f"(half the fast level: {hw.fast_levels[-1] // 2} B) — "
                f"fused_fits legality is broken (decision {desc})",
            )
    check_cache_key_completeness()

    if level != "full" or m == 0:
        return

    # -- full: data-dependent claims (REPRO_PB_CHECK=1) -------------------
    if _holds_no_data(indices):
        return  # nothing to read: a meta trace
    if indices.dtype not in _INDEX_DTYPES:
        raise ContractError(
            "index-dtype",
            f"stream indices must be integers, got {indices.dtype} (decision {desc})",
        )
    if in_bounds:
        lo, hi = (int(t) for t in torch.aminmax(indices))
        if lo < 0 or hi >= num_nodes:
            raise ContractError(
                "in-bounds",
                f"caller promised in_bounds but indices span "
                f"[{lo}, {hi}] outside [0, {num_nodes}) — a kernel that "
                f"trusted the promise would write outside its output "
                f"(decision {desc})",
            )
    if sorted_within is not None and sorted_within >= 0 and m > 1:
        r = max(1, int(sorted_within))
        bids = indices if r == 1 else torch.div(indices, r, rounding_mode="floor")
        back = torch.diff(bids) < 0
        if bool(back.any()):
            pos = int(torch.argmax(back.to(torch.int32)))
            a, b = (int(v) for v in indices[pos:pos + 2].tolist())
            claim = "elementwise sorted" if r == 1 else f"bin-blocked at range {r}"
            raise ContractError(
                "sortedness",
                f"caller claimed the stream is {claim}, but position "
                f"{pos} -> {pos + 1} goes {a} -> {b} backwards — a false "
                f"order claim silently corrupts a kernel that trusts it "
                f"(decision {desc})",
            )


__all__ = [
    "ContractError",
    "check_level",
    "check_stream",
    "check_cache_key_completeness",
]

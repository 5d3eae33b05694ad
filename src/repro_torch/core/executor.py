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
                    ``kernels.fused.cobra_bin_accumulate`` (flat values)
                    or ``cobra_bin_accumulate_rows`` (``(m, F)`` rows).

Kernels run because the tensors are on CUDA: the reference's gate,
``interpret = jax.default_backend() != "tpu"``, has no counterpart. On CPU
tensors each kernel's plain version runs. Decisions follow the
reference's priority (cache -> autotuner -> fallback table -> analytic
model) under an H100 ``HardwareModel`` by default. Under that model the
flat fused reduce follows the two-pass kernel's own limits
(``fused_fits``), and CUDA streams read a fallback table measured on the
card (``_FALLBACK_TABLE_H100``); every other model and the CPU keep the
reference's rules and table, so decisions there equal the reference's.

Batched streams (``bin_streams``, ``reduce_streams``,
``scatter_add_batched``) take one decision per batch, as the reference's
vmapped programs do; the port runs the lanes one after another, or the
fused reduce as one launch over the flattened lanes.

``kind="update"`` (graph-mutation delta-merge streams, ``core/updates.py``)
shares the reduce candidates and economics, under its own cache keys and
decision records; a forced update method still logs (source "caller").

``dispatch_permutation`` routes MoE assignments to expert slots (the
histogram and positions kernels under ``counting``).

``shard_reduce_stream`` is the mesh-sharded reduce over a
``torch.distributed`` group (``core/distributed_pb.py``): the local method
is decided at the per-rank shape under a cache key that carries the
topology, and the decision carries the exchange's pipeline depth. Every
choice that changes which collectives run (the measured K, the autotuner's
timings) is taken from values reduced across the ranks, and only rank 0
writes the decision cache.

``reduce_stream`` and ``shard_reduce_stream`` check every stream against
its decision before they run it (``_check_contract``,
``analysis/contracts.py``): shapes and the decision always, the caller's
in-bounds and sortedness claims under ``REPRO_PB_CHECK=1``.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, replace as _dc_replace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import pb
from repro_torch.core.cobra import hierarchical_binning
from repro_torch.core.plan import (
    CobraPlan,
    HardwareModel,
    binning_optimal_num_bins,
    compromise_bin_range,
    fused_fits,
    num_bins_for_range,
)

METHODS = ("sort", "counting", "pallas", "hierarchical")
REDUCE_METHODS = METHODS + ("fused",)
REDUCE_OPS = ("add", "min", "max")

# Below this stream length a stable sort is latency-bound and wins.
_SORT_THRESHOLD = 4096

# decision_log is a bounded trace, not an audit trail.
_DECISION_LOG_CAP = 512

# Decision kinds: binning, dense reductions and graph-mutation delta merges.
DECISION_KINDS = ("bin", "reduce", "update")


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
    CPU tensors: the kernels' plain version ``scatter_reduce_ref``, one
    vectorised ``index_add_`` / ``scatter_reduce_`` into an
    identity-filled output; indices outside ``[0, out_size)`` dropped,
    bfloat16 reduced in float32 and rounded once."""
    from repro_torch.kernels.ref import scatter_reduce_ref  # deferred: kernels import core.pb

    pb.value_block_shape(values)  # raises on ranks the reduce does not take
    return scatter_reduce_ref(indices, values, out_size, op)


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
    sorted_within: Optional[int] = None,
    f_tile: Optional[int] = None,
    in_bounds: bool = False,
) -> torch.Tensor:
    """Reduce one (indices, values) stream to a dense (out_size, ...) tensor.

    The binning methods run two-phase (``execute_binning`` then
    ``pb.bin_read_reduce``). ``fused`` on CUDA tensors launches the fused
    kernel: ``cobra_bin_accumulate`` for flat values,
    ``cobra_bin_accumulate_rows`` for row-block ``(m, F)`` values; on CPU
    tensors it runs the plain single call.

    The reference's keywords, and what the port does with them:
    ``sorted_within`` (the stream is sorted at that granularity) and
    ``in_bounds`` (every index lies in ``[0, out_size)``) are hints only:
    the kernels drop out-of-range indices whatever the promise, and the
    rows kernel is right for any order (its per-lane runs of equal
    destinations are longest on the sorted streams the GNN path sends).
    ``f_tile`` is handed to the rows kernel, which checks it and reads
    whole rows regardless (see ``kernels/fused.py``).
    """
    del sorted_within, in_bounds  # hints: see the docstring
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
        if indices.device.type not in ("cuda", "meta"):  # meta: the wrappers' shape-only route
            return _fused_reduce_plain(indices, values, out_size, op)
        if vshape != ():
            from repro_torch.kernels.fused import cobra_bin_accumulate_rows

            return cobra_bin_accumulate_rows(
                indices, values, num_indices=out_size, bin_range=r, num_bins=nb, op=op,
                f_tile=max(1, min(vshape[0], f_tile or vshape[0])),
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


class BatchedBins(NamedTuple):
    """A batch of binned streams (leading batch axis on every field): many
    small frontiers binned under one executor decision."""

    idx: torch.Tensor  # (B, m)
    val: torch.Tensor  # (B, m, ...)
    starts: torch.Tensor  # (B, num_bins + 1)
    bin_range: int


def bin_streams_batched(
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    bin_range: int,
    num_bins: int,
    method: str = "sort",
) -> BatchedBins:
    """Bin each lane of (B, m) streams with one (method, bin_range).

    Only ``sort`` and ``counting`` batch, as in the reference (whose vmap
    takes only the pure-XLA methods); the lanes run one after another."""
    if method not in ("sort", "counting"):
        raise ValueError(f"batched binning supports sort|counting, got {method!r}")
    lanes = [
        execute_binning(indices[b], values[b], bin_range=bin_range, num_bins=num_bins,
                        method=method)
        for b in range(indices.shape[0])
    ]
    return BatchedBins(
        idx=torch.stack([b.idx for b in lanes]),
        val=torch.stack([b.val for b in lanes]),
        starts=torch.stack([b.starts for b in lanes]),
        bin_range=bin_range,
    )


def lane_indices(indices: torch.Tensor, out_size: int) -> torch.Tensor:
    """(B, m) lane indices -> one (B * m,) stream over ``B * out_size``:
    lane b's index i at ``b * out_size + i``; an index outside
    ``[0, out_size)`` becomes -1, which every reduce drops, so it never
    lands in a neighbouring lane."""
    B = indices.shape[0]
    lane = torch.arange(B, dtype=indices.dtype, device=indices.device)[:, None] * out_size
    inside = (indices >= 0) & (indices < out_size)
    return torch.where(inside, indices + lane, -1).reshape(-1)


def _reduce_lanes(
    indices: torch.Tensor,
    values: torch.Tensor,
    out_size: int,
    op: str,
    d: "BinningDecision",
) -> torch.Tensor:
    """(B, m) streams -> (B, out_size, ...) under one decision.

    ``fused`` runs one reduce over the flattened lanes (``lane_indices``)
    where the flat domain and stream stay within the fused kernel's bounds
    (at most ``TWO_PASS_MAX_INDICES`` indices, an int32 stream length);
    the binning methods, and a wider fused batch, reduce lane by lane. A
    lane's result is the one ``reduce_stream`` gives at the same decision:
    each index receives its lane's tuples in stream order either way."""
    from repro_torch.kernels.fused import TWO_PASS_MAX_INDICES

    B, m = int(indices.shape[0]), int(indices.shape[1])
    vtail = tuple(values.shape[2:])
    ft = d.f_tile or None
    if d.method == "fused" and B * out_size <= TWO_PASS_MAX_INDICES and B * m <= _INT32_LIMIT:
        out = execute_reduce(
            lane_indices(indices, out_size), values.reshape((B * m,) + vtail),
            out_size=B * out_size, op=op, method="fused", f_tile=ft,
        )
        return out.reshape((B, out_size) + vtail)
    return torch.stack([
        execute_reduce(
            indices[b], values[b], out_size=out_size, op=op, method=d.method,
            bin_range=d.bin_range, num_bins=d.num_bins, plan=d.plan, f_tile=ft,
        )
        for b in range(B)
    ])


# ---------------------------------------------------------------------------
# Dispatch routing (MoE): Binning of a (token, expert) assignment stream.
# ---------------------------------------------------------------------------

def dispatch_permutation(
    key: torch.Tensor, num_slots: int, method: str = "sort"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable counting-sort routing for capacity-bounded dispatch (the
    reference's ``dispatch_permutation``): ``key[a]`` is the slot of
    assignment ``a`` in ``[0, num_slots]``, slot ``num_slots`` being the
    overflow bin. Returns int32 ``(order, key_sorted, starts, rank)``:
    the stable permutation grouping assignments by slot, ``key[order]``,
    the (num_slots + 2,) exclusive prefix of slot counts, and each sorted
    assignment's rank within its slot.

    ``sort``: ``torch.argsort(stable=True)`` and a bincount, as the
    reference. ``counting``: the histogram kernel for the slot counts,
    the positions kernel for each assignment's destination, and one int32
    scatter that inverts them (``pb.inverse_permutation``), composed as
    the ``pallas`` binning method is (``kernels/ops.py::pb_binning``); on
    CPU tensors the wrappers run their plain versions. Both are stable,
    so both give the same four tensors bit for bit. The reference's
    ``block`` (its counting sort's block size) has no counterpart: the
    kernels need none."""
    nb = num_slots + 1
    a = key.shape[0]
    key = key.to(torch.int32)
    if method == "counting":
        from repro_torch.kernels.binning import counting_positions  # deferred: kernels import core
        from repro_torch.kernels.histogram import histogram

        starts = pb.starts_from_counts(histogram(key, nb))
        order = pb.inverse_permutation(counting_positions(key, starts[:-1], nb))
    elif method == "sort":
        order = torch.argsort(key, stable=True).to(torch.int32)
        starts = pb.starts_from_counts(pb.bincount(key, nb))
    else:
        raise ValueError(f"unknown dispatch method: {method!r} (want 'sort' or 'counting')")
    key_s = key[order.long()]
    rank = torch.arange(a, dtype=torch.int32, device=key.device) - starts[key_s.long()]
    return order, key_s, starts, rank


# ---------------------------------------------------------------------------
# Decisions, fallback tables, decision cache.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BinningDecision:
    """What the executor chose for one stream shape, and why."""

    method: str
    bin_range: int
    num_bins: int
    plan: Optional[CobraPlan]
    source: str  # analytic | fallback-table | autotuned | cache | caller
    # the sharded exchange's pipeline depth K: 1 except for mesh-sharded
    # reduce decisions (roofline overlap model or a measured sweep)
    pipeline_chunks: int = 1
    f_tile: int = 0

    def describe(self) -> str:
        ft = f"/f{self.f_tile}" if self.f_tile else ""
        return f"{self.method}@r{self.bin_range}{ft}[{self.source}]"


def _bucket(x: int) -> int:
    return max(0, int(math.log2(x))) if x > 0 else 0


# (log2 num_indices, log2 stream_len) -> method. Copied from the
# reference so decisions match; it was measured on a CPU (interpret-mode
# JAX). Every model but the H100 one, and every CPU stream, reads it.
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

# The same buckets, and those of chip_smoke.py's S1 (2^18 vertices; 2^19,
# 2^20 and 2^21 edges), S2 (2^22, 2^25) and S3 (32M -> 2^24, 128M ->
# 2^26), measured by the port's autotuner on an H100 80GB HBM3 at 700 W
# (binning streams, int32 values; ``scripts/torch_autotune_table.py``,
# the method fastest in most of 3 rounds; PERF.md), keyed by
# ``use_pallas``: the fastest of sort, counting and hierarchical, and with
# ``use_pallas`` also pallas. Below 2^16 tuples a call takes 0.12-0.4 ms
# whatever the method (host-bound), so those entries are near ties. Read
# only for CUDA streams under ``HardwareModel.h100()``.
_FALLBACK_TABLE_H100 = {
    False: {
        (8, 10): "hierarchical",
        (8, 12): "sort",
        (10, 12): "hierarchical",
        (10, 14): "sort",
        (12, 14): "hierarchical",
        (12, 16): "hierarchical",
        (14, 16): "sort",
        (14, 18): "sort",
        (16, 17): "sort",
        (16, 18): "sort",
        (16, 20): "sort",
        (18, 19): "sort",
        (18, 20): "sort",
        (18, 21): "sort",
        (20, 22): "sort",
        (22, 25): "sort",
        (24, 26): "sort",
    },
    True: {
        (8, 10): "pallas",
        (8, 12): "pallas",
        (10, 12): "pallas",
        (10, 14): "pallas",
        (12, 14): "pallas",
        (12, 16): "pallas",
        (14, 16): "pallas",
        (14, 18): "pallas",
        (16, 17): "pallas",
        (16, 18): "pallas",
        (16, 20): "pallas",
        (18, 19): "pallas",
        (18, 20): "pallas",
        (18, 21): "pallas",
        (20, 22): "pallas",
        (22, 25): "pallas",
        (24, 26): "pallas",
    },
}

_CACHE_SCHEMA_VERSION = 1


class _DecisionCache:
    """Measured decisions: an in-memory dict persisted to
    ``<cache_dir>/autotune.json``.

    The port's own namespace (``REPRO_TORCH_CACHE_DIR`` or
    ``~/.cache/repro_torch``), never the reference's, and every key names
    the device (``_device_tag``), so a decision made by JAX on a CPU, or
    on another card, is never replayed here. Persistence is best-effort:
    a directory that cannot be written leaves the entries in memory.
    """

    def __init__(self, cache_dir: Optional[str] = None):
        self.dir = (
            cache_dir
            or os.environ.get("REPRO_TORCH_CACHE_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache", "repro_torch")
        )
        self.path = os.path.join(self.dir, "autotune.json")
        self.mem: dict = {}
        self.persist_ok = True
        self.mem.update(self._read())

    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                blob = json.load(f)
            if isinstance(blob, dict) and blob.get("version") == _CACHE_SCHEMA_VERSION:
                return dict(blob.get("entries", {}))
        except (OSError, ValueError):
            pass  # no cache yet, or a torn file: decide without it
        return {}

    def _save(self) -> None:
        """Merge this process's entries over the file's under an advisory
        lock, write a per-process temporary file and rename it over the
        cache: readers see the old file or the new one, never a torn one,
        and two writers keep each other's keys (on one key the later
        writer wins: both are measurements of the same shape)."""
        if not self.persist_ok:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(self.path + ".lock", "w") as lockf:
                try:
                    import fcntl

                    fcntl.flock(lockf, fcntl.LOCK_EX)  # released on close
                except (ImportError, OSError):
                    pass  # no flock: the merge still applies
                merged = self._read()
                merged.update(self.mem)
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump({"version": _CACHE_SCHEMA_VERSION, "entries": merged}, f, indent=1)
                os.replace(tmp, self.path)
        except OSError:
            self.persist_ok = False  # keep the entries in memory only

    def get(self, key: str) -> Optional[dict]:
        return self.mem.get(key)

    def put(self, key: str, entry: dict) -> None:
        """Keep ``entry``; only rank 0 of a process group writes the file
        (the ranks hold the same entries: their decisions are agreed)."""
        self.mem[key] = entry
        if _rank() == 0:
            self._save()


def _rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _rank_count() -> int:
    """Ranks in the default process group (1 without one): the port's
    counterpart of the reference's process device count in a cache key."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _device_tag(device: torch.device) -> str:
    """``torch:<type>:<name>`` — the device part of a cache key."""
    if device.type == "cuda" and torch.cuda.is_available():
        return f"torch:cuda:{torch.cuda.get_device_name(device)}"
    return f"torch:{device.type}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Kernel-backed methods address streams with int32 (``_lib.check_int32_size``).
_INT32_METHODS = ("pallas", "fused")
_INT32_LIMIT = 2**31 - 1


# ---------------------------------------------------------------------------
# The executor.
# ---------------------------------------------------------------------------


class PBExecutor:
    """Plan-driven (and optionally measured) PB execution under a
    ``HardwareModel`` (default: H100).

    ``use_pallas=True`` adds the kernel-backed ``pallas`` binning method to
    the candidate set, as ``REPRO_PB_USE_PALLAS=1`` does for the default
    executor. ``autotune=True`` makes ``decide`` time every candidate on a
    synthetic stream of the requested shape on the requested device, once
    per key, and keep the fastest in the cache.
    """

    # Reduce methods a batch may run: the two-phase pair and the fused
    # sweep, as in the reference (pallas and hierarchical clamp to sort).
    BATCHED_REDUCE_METHODS = ("sort", "counting", "fused")

    def __init__(
        self,
        hw: Optional[HardwareModel] = None,
        *,
        autotune: bool = False,
        cache_dir: Optional[str] = None,
        use_pallas: bool = False,
    ):
        self.hw = hw or HardwareModel.h100()
        self.autotune = autotune
        self.use_pallas = use_pallas
        self.cache = _DecisionCache(cache_dir)
        self.decision_log: list = []
        # caller-owned, uncapped side channels (add_decision_sink)
        self._decision_sinks: list = []
        self._last_entry: Optional[dict] = None

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
        mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None,
    ) -> str:
        # the topology is always part of the key: a decision measured on
        # one rank is no evidence about a sharded run, whose per-rank
        # stream and domain shrink with the mesh
        topo = f"d{_rank_count()}"
        if mesh_shape:
            topo += "/" + "x".join(f"{a}{s}" for a, s in mesh_shape)
        sl = f"b{_bucket(stream_len)}" if kind != "bin" else str(stream_len)
        dt = str(dtype).replace("torch.", "")
        base = f"{num_indices}:{sl}:{dt}:{_device_tag(device)}:{topo}"
        if kind != "bin":
            base = f"{base}:{kind}:{op}"
            if feature_dim > 1:
                base = f"{base}:f{feature_dim}"
        return f"{base}:r{bin_range}" if bin_range else base

    def _candidates(
        self, flat_values: bool, kind: str = "bin", stream_len: Optional[int] = None
    ) -> Tuple[str, ...]:
        """The methods ``decide`` may return. With ``stream_len`` (the
        autotuner's probe) a method that cannot take the shape is left
        out before any timing: the kernel-backed methods (pallas, fused)
        address the stream with int32."""
        c = ["sort", "counting"]
        if self.use_pallas and flat_values:
            c.append("pallas")
        c.append("hierarchical")
        if kind in ("reduce", "update"):  # update streams are reductions too
            c.append("fused")
        if stream_len is not None and stream_len > _INT32_LIMIT:
            c = [x for x in c if x not in _INT32_METHODS]
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

    def fused_fits(
        self, num_indices: int, value_bytes: int = 4, stream_len: int = 0, flat: bool = True
    ) -> bool:
        """Fusion legality, capacity half. The reference's rule: the dense
        accumulator must fit half the largest fast level (on the H100
        model, half the L2, where the single sweep's atomics and the row
        kernel's accumulator live). A model with ``fused_max_indices``
        (the H100's) also admits a flat stream of 4-byte values that its
        two-pass kernel takes: the output is reduced a slab at a time in
        shared memory, so only the index bound and the scratch of
        ``fused_scratch_per_tuple`` bytes a tuple, within the device
        memory, limit it."""
        return fused_fits(self.hw, num_indices, value_bytes, stream_len, flat)

    def analytic_reduce_method(
        self,
        num_indices: int,
        stream_len: int,
        bin_range: Optional[int] = None,
        value_bytes: int = 4,
        flat: bool = True,
    ) -> str:
        if self.fused_fits(num_indices, value_bytes, stream_len, flat):
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

    def _fallback_table(self, device: torch.device) -> dict:
        """The card's measured table for CUDA streams under the H100 model;
        the reference's table everywhere else."""
        if device.type == "cuda" and self.hw == HardwareModel.h100():
            return _FALLBACK_TABLE_H100[self.use_pallas]
        return _FALLBACK_TABLE

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
        mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None,
        mesh=None,
    ) -> BinningDecision:
        """Pick (method, bin_range, plan) for a stream shape. Priority:
        cache -> autotuner (if on) -> fallback table -> analytic model.
        ``kind`` is "bin", "reduce" or "update" (a reduction under its own
        cache key); ``dtype`` is the value dtype for reductions. ``device``
        is where the stream lives (default: the card): it names the cache
        key's device, the fallback table and where the autotuner measures.
        ``mesh_shape`` (``(axis, size)`` pairs) keys a sharded decision by
        its topology and gives a reduce decision its pipeline depth;
        ``mesh`` (a ``StreamMesh``, whose shape is the default
        ``mesh_shape``) makes the autotuner's timings the largest over its
        ranks, so that every rank decides alike."""
        if kind not in DECISION_KINDS:
            raise ValueError(f"decision kind must be one of {DECISION_KINDS}, got {kind!r}")
        if mesh is not None and mesh_shape is None:
            mesh_shape = tuple(sorted(mesh.shape.items()))
        dev = torch.device("cuda") if device is None else torch.device(device)
        key = self._key(num_indices, stream_len, dtype, bin_range, kind, op, feature_dim, dev,
                        mesh_shape)
        d = self._decide_uncached(
            key, num_indices, stream_len, dtype, bin_range, flat_values, kind, op,
            feature_dim, dev, mesh,
        )
        if kind == "reduce" and feature_dim:
            d = _dc_replace(
                d, f_tile=self.choose_f_tile(feature_dim, num_indices, dtype.itemsize)
            )
        if mesh_shape and kind == "reduce":
            # the sharded decision's pipeline depth: a measured entry under
            # the topology key when one exists, else the overlap model
            d = _dc_replace(
                d, pipeline_chunks=self._pipeline_chunks_for(
                    key, num_indices, stream_len, mesh_shape)
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
        if mesh_shape:
            entry["mesh"] = {a: s for a, s in mesh_shape}
            if kind == "reduce":
                entry["pipeline_chunks"] = d.pipeline_chunks
        self._log_decision(entry)
        return d

    def _log_decision(self, entry: dict) -> None:
        """Append one decision record to the capped shared log and to every
        registered (uncapped) sink; the same dict goes everywhere. The
        entry is also kept as ``_last_entry``, so that
        ``shard_reduce_stream`` can add the exchange's facts to its own
        record in place."""
        self._last_entry = entry
        if len(self.decision_log) < _DECISION_LOG_CAP:
            self.decision_log.append(entry)
        for sink in self._decision_sinks:
            sink.append(entry)

    def add_decision_sink(self, sink: list) -> None:
        """Register a side channel that every later decision record is
        appended to, past the log's cap. The caller owns the list and
        detaches it with ``remove_decision_sink``."""
        self._decision_sinks.append(sink)

    def remove_decision_sink(self, sink: list) -> None:
        # by identity: nested sinks hold the same entries and compare equal
        for i, s in enumerate(self._decision_sinks):
            if s is sink:
                del self._decision_sinks[i]
                return
        raise ValueError("sink not registered")

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
        mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None,
        mesh=None,
    ) -> BinningDecision:
        """``decide`` for ``None``/"auto", else the caller's method
        finalized at this shape."""
        if method in (None, "auto"):
            return self.decide(
                num_indices, stream_len, dtype, bin_range=bin_range,
                flat_values=flat_values, kind=kind, op=op, feature_dim=feature_dim,
                device=device, mesh_shape=mesh_shape, mesh=mesh,
            )
        d = self._finalize(method, num_indices, bin_range, "caller")
        if kind == "reduce" and feature_dim:
            d = _dc_replace(
                d, f_tile=self.choose_f_tile(feature_dim, num_indices, dtype.itemsize)
            )
        return d

    def _decide_uncached(
        self, key, num_indices, stream_len, dtype, bin_range, flat_values, kind, op,
        feature_dim: int, device: torch.device, mesh=None,
    ) -> BinningDecision:
        hit = self.cache.get(key)
        if hit is not None and hit.get("method") in self._candidates(flat_values, kind):
            return self._finalize(hit["method"], num_indices, bin_range, "cache")
        if self.autotune and stream_len > 0:
            entry = self.measure_methods(
                num_indices, stream_len, dtype, bin_range, flat_values, kind=kind, op=op,
                feature_dim=feature_dim, device=device, mesh=mesh,
            )
            self.cache.put(key, entry)
            if mesh is not None:
                from repro_torch.core.distributed_pb import barrier

                barrier(mesh)  # rank 0 has written the entry before any rank reads it
            return self._finalize(entry["method"], num_indices, bin_range, "autotuned")
        # the tables are bucketed on the default (compromise) range and hold
        # binning decisions only
        if bin_range is None and kind == "bin":
            m = self._fallback_table(device).get((_bucket(num_indices), _bucket(stream_len)))
            if m is not None and m in self._candidates(flat_values, kind):
                return self._finalize(m, num_indices, bin_range, "fallback-table")
        if kind != "bin":
            isz = dtype.itemsize
            ft = self.choose_f_tile(feature_dim, num_indices, isz)
            analytic = self.analytic_reduce_method(
                num_indices, stream_len, bin_range, value_bytes=max(1, ft) * isz,
                flat=feature_dim == 0,
            )
        else:
            analytic = self.analytic_method(num_indices, stream_len, bin_range)
        return self._finalize(analytic, num_indices, bin_range, "analytic")

    # -- pipeline depth of the sharded exchange ----------------------------

    def _pipeline_chunks_for(
        self,
        key: str,
        num_indices: int,
        stream_len: int,
        mesh_shape: Tuple[Tuple[str, int], ...],
    ) -> int:
        """K for a sharded reduce decision: the measured ``:pipeline`` entry
        under the same topology key when one exists, else the roofline
        overlap model at the global stream shape."""
        n_dev = 1
        for _, s in mesh_shape:
            n_dev *= int(s)
        if n_dev <= 1 or stream_len <= 0:
            return 1
        hit = self.cache.get(f"{key}:pipeline")
        if hit is not None and "pipeline_chunks" in hit:
            return max(1, int(hit["pipeline_chunks"]))
        from repro_torch.roofline import ShardedPBStreamRoofline

        rl = ShardedPBStreamRoofline(
            num_tuples=max(1, stream_len), num_indices=max(1, num_indices * n_dev), n_dev=n_dev
        )
        return rl.best_pipeline_chunks()

    def _tune_pipeline_chunks(
        self,
        key: str,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        out_size: int,
        mesh,
        op: str,
        axis_name: Optional[str],
        d: BinningDecision,
        capacity: int,
        reps: int = 3,
    ) -> int:
        """Measure K in {1, 2, 4} on the real stream and mesh and keep the
        winner under ``key:pipeline``. Each K's time is the largest over
        the ranks (every rank then picks the same K, so the next calls
        run the same collectives); a warm-up call, then the best of
        ``reps`` calls between device synchronisations."""
        hit = self.cache.get(f"{key}:pipeline")
        if hit is not None and "pipeline_chunks" in hit:
            return max(1, int(hit["pipeline_chunks"]))
        from repro_torch.core import distributed_pb as dpb

        timings = {}
        for k in (1, 2, 4):
            def run(k=k):
                return dpb.shard_reduce_stream(
                    indices, values, out_size=out_size, mesh=mesh, op=op,
                    axis_name=axis_name, method=d.method, bin_range=d.bin_range,
                    plan=d.plan, capacity=capacity, pipeline_chunks=k,
                )

            run()
            _sync(indices.device)
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                _sync(indices.device)
                ts.append(time.perf_counter() - t0)
            timings[str(k)] = min(ts) * 1e6
        timings = dict(zip(timings, dpb.agree_max(timings.values(), mesh)))
        best = int(min(timings, key=timings.get))
        self.cache.put(f"{key}:pipeline", {"pipeline_chunks": best, "timings_us": timings})
        dpb.barrier(mesh)  # rank 0 has written the entry before any rank reads the file again
        return best

    # -- autotune measurement ---------------------------------------------

    def measure_methods(
        self,
        num_indices: int,
        stream_len: int,
        dtype: torch.dtype = torch.int32,
        bin_range: Optional[int] = None,
        flat_values: bool = True,
        reps: int = 3,
        kind: str = "bin",
        op: str = "add",
        feature_dim: int = 0,
        device: Optional[torch.device] = None,
        mesh=None,
    ) -> dict:
        """Time every candidate method on a synthetic stream of this shape
        on ``device`` (default: the card); returns ``{"method": fastest,
        "timings_us": {...}}``. The stream is the reference's: uniform
        indices from a numpy seed of the shape, values ``arange`` ((m, F)
        rows when ``feature_dim``). Each method runs once to warm up, then
        ``reps`` times, each call between two device synchronisations;
        the best time counts. A method that fails raises: every candidate
        has a kernel or a plain version, so a failure is a fault. Under a
        ``mesh`` each method's time is the largest over its ranks, so
        every rank picks the same method."""
        dev = torch.device("cuda") if device is None else torch.device(device)
        rng = np.random.default_rng(num_indices * 1_000_003 + stream_len)
        idx = torch.from_numpy(
            rng.integers(0, max(1, num_indices), stream_len).astype(np.int32)
        ).to(dev)
        if feature_dim:
            val = torch.arange(stream_len * feature_dim, dtype=dtype, device=dev).reshape(
                stream_len, feature_dim
            )
        else:
            val = torch.arange(stream_len, dtype=dtype, device=dev)
        ftile = self.choose_f_tile(feature_dim, num_indices, dtype.itemsize) or None
        timings = {}
        for method in self._candidates(flat_values, kind, stream_len=stream_len):
            d = self._finalize(method, num_indices, bin_range, "probe")
            if kind != "bin":
                def fn(d=d):
                    return execute_reduce(
                        idx, val, out_size=num_indices, op=op, method=d.method,
                        bin_range=d.bin_range, num_bins=d.num_bins, plan=d.plan, f_tile=ftile,
                    )
            else:
                def fn(d=d):
                    return execute_binning(
                        idx, val, bin_range=d.bin_range, num_bins=d.num_bins,
                        method=d.method, plan=d.plan,
                    )
            fn()
            _sync(dev)
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                ts.append(time.perf_counter() - t0)
            timings[method] = min(ts) * 1e6
        if mesh is not None:
            from repro_torch.core.distributed_pb import agree_max

            timings = dict(zip(timings, agree_max(timings.values(), mesh)))
        return {"method": min(timings, key=timings.get), "timings_us": timings}

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

    def bin_streams(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        num_indices: int,
        bin_range: Optional[int] = None,
        method: Optional[str] = None,
    ) -> BatchedBins:
        """Batched binning of (B, m) streams under one decision; a decided
        method outside sort|counting clamps to sort, logged under a
        ``+batch-clamp`` source tag."""
        flat = isinstance(values, torch.Tensor) and values.ndim == 2
        feat = int(values.shape[2]) if values.ndim == 3 else 0
        if method in (None, "auto"):
            d = self.decide(
                num_indices, int(indices.shape[1]), indices.dtype, bin_range=bin_range,
                flat_values=flat, device=indices.device,
            )
            if d.method not in ("sort", "counting"):
                d = self._finalize("sort", num_indices, bin_range, f"{d.source}+batch-clamp")
                entry = {
                    "kind": "bin",
                    "num_indices": num_indices,
                    "stream_len": int(indices.shape[1]),
                    "method": d.method,
                    "bin_range": d.bin_range,
                    "source": d.source,
                }
                if feat:
                    entry["feature_dim"] = feat
                    entry["f_tile"] = self.choose_f_tile(feat, num_indices)
                self._log_decision(entry)
        else:
            d = self._finalize(method, num_indices, bin_range, "caller")
        return bin_streams_batched(
            indices, values, bin_range=d.bin_range, num_bins=d.num_bins, method=d.method
        )

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
        sorted_within: Optional[int] = None,
        in_bounds: bool = False,
    ) -> torch.Tensor:
        """Reduce one commutative stream to a dense (out_size, ...) tensor;
        ``method=None``/"auto" consults ``decide`` with the reduce
        candidate set (which includes ``fused``). Row-block values carry
        the F-tile the reference would choose; ``sorted_within`` and
        ``in_bounds`` are claims the stream contract holds the stream to
        (``_check_contract``), then hints (see ``execute_reduce``).
        ``kind="update"`` tags a graph-mutation delta-merge stream: its own
        cache keys and decision records, and a forced method is logged
        too (source "caller")."""
        if op not in REDUCE_OPS:
            raise ValueError(
                f"reduce_stream only serves commutative reductions {REDUCE_OPS}; "
                f"got op={op!r}. Non-commutative consumers need the stable "
                "two-phase path: bin_stream() + an order-aware Bin-Read."
            )
        if kind not in ("reduce", "update"):
            raise ValueError(f"reduce_stream kind must be 'reduce' or 'update', got {kind!r}")
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
            if feat:
                d = _dc_replace(
                    d, f_tile=self.choose_f_tile(feat, out_size, values.dtype.itemsize)
                )
            if kind == "update":
                self._log_decision({
                    "kind": kind,
                    "num_indices": out_size,
                    "stream_len": int(indices.shape[0]),
                    "method": d.method,
                    "bin_range": d.bin_range,
                    "source": d.source,
                    "op": op,
                })
        if not flat and d.method == "pallas":
            # pallas binning is 1-D-only; row values take the sort path
            d = self._finalize("sort", out_size, bin_range, d.source)
        self._check_contract(
            indices, values, out_size, d, op=op, sorted_within=sorted_within, in_bounds=in_bounds
        )
        return execute_reduce(
            indices, values, out_size=out_size, op=op, method=d.method,
            bin_range=d.bin_range, num_bins=d.num_bins, plan=d.plan,
            sorted_within=sorted_within, f_tile=d.f_tile or None, in_bounds=in_bounds,
        )

    def reduce_streams(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        out_size: int,
        op: str = "add",
        bin_range: Optional[int] = None,
        method: Optional[str] = None,
        sorted_within: Optional[int] = None,
    ) -> torch.Tensor:
        """Batched reduce of (B, m) streams -> (B, out_size, ...) under one
        decision. A decided method outside ``BATCHED_REDUCE_METHODS``
        clamps to ``sort`` under a ``+batch-clamp`` source tag; a forced
        one must be in the set. Lane b equals ``reduce_stream`` of lane b
        at the same decision: bit for bit for min, max and integer add,
        and on the CPU for every op (``_reduce_lanes``). ``sorted_within``
        is a hint, as in ``execute_reduce``."""
        del sorted_within
        if op not in REDUCE_OPS:
            raise ValueError(
                f"reduce_streams only serves commutative reductions {REDUCE_OPS}; got op={op!r}."
            )
        if indices.ndim != 2:
            raise ValueError(f"reduce_streams wants (B, m) indices, got {tuple(indices.shape)}")
        flat = values.ndim == 2
        feat = int(values.shape[2]) if values.ndim == 3 else 0
        if method in (None, "auto"):
            d = self.decide(
                out_size, int(indices.shape[1]), values.dtype, bin_range=bin_range,
                flat_values=flat, kind="reduce", op=op, feature_dim=feat,
                device=indices.device,
            )
            if d.method not in self.BATCHED_REDUCE_METHODS:
                d = self._finalize("sort", out_size, bin_range, f"{d.source}+batch-clamp")
                entry = {
                    "kind": "reduce",
                    "num_indices": out_size,
                    "stream_len": int(indices.shape[1]),
                    "method": d.method,
                    "bin_range": d.bin_range,
                    "source": d.source,
                    "op": op,
                }
                if feat:
                    entry["feature_dim"] = feat
                    entry["f_tile"] = self.choose_f_tile(feat, out_size)
                self._log_decision(entry)
        else:
            if method not in self.BATCHED_REDUCE_METHODS:
                raise ValueError(
                    f"batched reduce supports {self.BATCHED_REDUCE_METHODS}, got {method!r}"
                )
            d = self._finalize(method, out_size, bin_range, "caller")
        return _reduce_lanes(indices, values, out_size, op, d)

    def shard_reduce_stream(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        out_size: int,
        mesh=None,
        op: str = "add",
        axis_name: Optional[str] = None,
        bin_range: Optional[int] = None,
        method: Optional[str] = None,
        capacity: Optional[int] = None,
        pipeline_chunks: Optional[int] = None,
        packed: bool = True,
    ) -> torch.Tensor:
        """Mesh-sharded commutative reduction (``core/distributed_pb.py``):
        the owner rank is the coarsest C-Buffer level, the collective its
        eviction path. ``decide`` picks the rank-local method at the
        per-rank shape (owned index range, received stream length) under a
        topology key, so a single-device decision is never replayed for a
        sharded run; the decision carries the pipeline depth K
        (``pipeline_chunks=None``: a measured ``:pipeline`` entry, tuned
        live under ``autotune``, else the overlap model). ``capacity=None``
        estimates the segment size from owner skew, guarded by the
        overflow rerun; capacity, K and overflow land on this call's
        decision record. ``mesh=None`` or one rank is ``reduce_stream``."""
        from repro_torch.core import distributed_pb as dpb

        if op not in REDUCE_OPS:
            raise ValueError(
                f"shard_reduce_stream only serves commutative reductions {REDUCE_OPS}; "
                f"got op={op!r}. Non-commutative consumers need the stable exchange "
                "and an order-aware Bin-Read (see distributed_pb.shard_build_csr)."
            )
        n_dev = dpb.mesh_size(mesh, axis_name)
        if n_dev == 1:
            return self.reduce_stream(
                indices, values, out_size=out_size, op=op, bin_range=bin_range, method=method
            )
        m = int(indices.shape[0])
        r = dpb.shard_range_for(out_size, n_dev)
        cap_src = "caller" if capacity is not None else "estimated"
        cap = (int(capacity) if capacity is not None
               else dpb.estimate_capacity(indices, out_size=out_size, n_dev=n_dev)) if m > 0 else 1
        vshape = pb.value_block_shape(values)
        flat = vshape == ()
        feat = vshape[0] if vshape else 0
        mshape = dpb.mesh_shape(mesh)
        entry: Optional[dict] = None
        if method in (None, "auto"):
            d = self.decide(
                r,  # per-rank domain: the owned index range
                n_dev * cap,  # per-rank stream: the padded received exchange
                values.dtype, bin_range=bin_range, flat_values=flat, kind="reduce", op=op,
                feature_dim=feat, device=indices.device, mesh_shape=mshape, mesh=mesh,
            )
            entry = self._last_entry  # gains the exchange's facts below
        else:
            d = self._finalize(method, r, bin_range, "caller")
        if not flat and d.method == "pallas":  # pallas binning is 1-D only
            d = self._finalize("sort", r, bin_range, d.source)
        # per-rank contract: the decision's geometry must cover the owned
        # range r, at the received stream the decision was taken for
        self._check_contract(indices, values, r, d, op=op, stream_len=n_dev * cap)
        k = pipeline_chunks
        if k is None:
            key = self._key(r, n_dev * cap, values.dtype, bin_range, "reduce", op, feat,
                            indices.device, mshape)
            if self.autotune and m > 0:
                k = self._tune_pipeline_chunks(
                    key, indices, values, out_size=out_size, mesh=mesh, op=op,
                    axis_name=axis_name, d=d, capacity=cap,
                )
            elif method in (None, "auto"):
                k = d.pipeline_chunks
            else:
                k = self._pipeline_chunks_for(key, r, n_dev * cap, mshape)
        out, xinfo = dpb.shard_reduce_stream_info(
            indices, values, out_size=out_size, mesh=mesh, op=op, axis_name=axis_name,
            method=d.method, bin_range=d.bin_range,
            capacity=cap,  # the capacity the decision was keyed on
            plan=d.plan, pipeline_chunks=k, packed=packed,
        )
        xfields = {
            "capacity": xinfo["capacity"],
            "capacity_source": "overflow-fallback" if xinfo["fallback"] else cap_src,
            "pipeline_chunks": xinfo["pipeline_chunks"],
            "overflow": xinfo["overflow"],
            "packed": xinfo["packed"],
        }
        if entry is not None:
            # the same dict the log and every sink hold
            entry.update(xfields)
        else:  # a forced method has no decide() record: add one
            self._log_decision({
                "kind": "shard_exchange",
                "num_indices": out_size,
                "stream_len": m,
                "method": "exchange",
                "bin_range": 0,
                "source": xfields["capacity_source"],
                "op": op,
                "mesh": {a: s for a, s in mshape},
                **xfields,
            })
        return out

    # -- the stream contract ----------------------------------------------

    def _check_contract(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        num_nodes: int,
        d: BinningDecision,
        *,
        op: str = "add",
        sorted_within: Optional[int] = None,
        in_bounds: bool = False,
        stream_len: Optional[int] = None,
    ) -> None:
        """Validate the stream against the decision before running it
        (``analysis.contracts.check_stream`` under this executor's model):
        the cheap clauses always, the in-bounds and sortedness claims under
        ``REPRO_PB_CHECK=1``. Raises ``ContractError`` naming the
        invariant and ``d.describe()``."""
        from repro_torch.analysis import contracts

        contracts.check_stream(
            indices, values, num_nodes, d, op=op, sorted_within=sorted_within,
            in_bounds=in_bounds, hw=self.hw, stream_len=stream_len,
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

    def scatter_add_batched(
        self,
        indices: torch.Tensor,
        values: torch.Tensor,
        *,
        out_size: int,
        bin_range: Optional[int] = None,
    ) -> torch.Tensor:
        """Batched scatter-add over (B, m) streams -> (B, out_size, ...):
        ``bin_streams``, then each lane's binned stream added in order
        (indices outside ``[0, out_size)`` dropped)."""
        bb = self.bin_streams(indices, values, num_indices=out_size, bin_range=bin_range)
        vtail = tuple(values.shape[2:])
        out = torch.zeros((indices.shape[0], out_size) + vtail, dtype=values.dtype,
                          device=values.device)
        for b in range(indices.shape[0]):
            pb.scatter_reduce_into(out[b], bb.idx[b], bb.val[b], "add")
        return out


_DEFAULT: Optional[PBExecutor] = None


def get_default_executor() -> PBExecutor:
    """Process-wide executor (H100 model). ``REPRO_PB_AUTOTUNE=1`` turns on
    measured selection; ``REPRO_PB_USE_PALLAS=1`` adds the kernel-backed
    ``pallas`` method to the candidates."""
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

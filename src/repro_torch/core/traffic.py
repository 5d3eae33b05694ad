"""Analytic access-cost model for PB executions (port of
``repro/core/traffic.py``).

The arithmetic is the reference's, term for term, so the same
``HardwareModel`` fields give the same numbers in both packages
(``tests/test_torch_cost_models.py``). Model: an irregular phase costs

    stream_bytes / dram_bandwidth            (sequential traffic)
  + num_accesses * expected_access_time(ws)  (random accesses)

where ``expected_access_time`` spreads a working set ``ws`` over the
hierarchy's levels; the byte counters (fused, two-phase, sharded
exchange, traversal, serving, update, SpMM and preprocessing) are the
sequential-traffic terms the rooflines (``repro_torch/roofline.py``)
divide by a bandwidth.

What carries over to the H100 and what does not. The byte counters are
facts of the algorithms and hold on any device. The access-time levels
are the reference's calibrations: the paper's 14-core Xeon for every
model whose name does not start with ``tpu`` (the H100 model
included), and the reference's TPU numbers for a ``tpu``-named model,
kept only so that a TPU model's fields give the reference's seconds. No
level is calibrated for the H100, so seconds from ``PhaseCost`` under
``HardwareModel.h100()`` are the Xeon model's and no measurement of the
card. The interconnect default of the sharded terms is the H100's NVLink
(``plan.H100_NVLINK_BW``), not the reference's TPU ICI link.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.plan import (
    H100_NVLINK_BW,
    TUPLE_BYTES,
    CobraPlan,
    HardwareModel,
    binning_optimal_num_bins,
    binread_optimal_range,
    num_bins_for_range,
)


# (capacity_bytes, access_ns) per level; DRAM appended implicitly.
# Access times are EFFECTIVE per-access costs on the paper's 14-core Xeon
# with memory-level parallelism: the single free parameter (_CPU_DRAM_NS)
# is calibrated once so the modeled NeighPop PB speedup hits the midpoint
# of the paper's Table 1 (4.5-7.3x); everything else is then predicted.
_CPU_LEVELS: Tuple[Tuple[float, float], ...] = (
    (32 * 1024, 0.5),  # L1
    (1024 * 1024, 2.0),  # L2
    (35 * 1024 * 1024, 10.0),  # LLC
)
_CPU_DRAM_NS = 45.0

# Per-tuple CORE cost (instructions) of the PB phases: the paper's second
# inefficiency — software binning executes ~5x more instructions (bin-id
# compute, C-Buffer append/flush bookkeeping). COBRA's binupdate +
# binning engines reduce this to ~one instruction (_COBRA_CORE_NS).
# The four constants below were jointly calibrated by grid search against
# five paper targets (Table 1 NeighPop midpoint 5.9x, Table 2's 1.47x,
# Table 1 PR ~1.05x, Fig 5 B/A=1.48 and C/A=2.25); see EXPERIMENTS.md.
_BINNING_CORE_NS = 2.5
_BINREAD_CORE_NS = 4.0
_BASELINE_CORE_NS = 1.0
_COBRA_CORE_NS = 0.3

# Power-law skew: accesses into vertex-indexed arrays concentrate on hot
# vertices (hot_hit of accesses touch hot_frac of the range) — why the
# paper's PageRank-over-CSR baseline is already fairly cache-friendly and
# PB's PR gain is modest (0.8-1.3x) while NeighPop's cold neighbor-array
# writes gain 4.5-7.3x.
_HOT_FRAC = 0.1
_HOT_HIT = 0.95

_TPU_LEVELS: Tuple[Tuple[float, float], ...] = ((64 * 1024 * 1024, 3.0),)  # VMEM
_TPU_DRAM_NS = 500.0  # HBM random-access (latency-bound scalar scatter)


def _levels_for(hw: HardwareModel):
    if hw.name.startswith("tpu"):
        return _TPU_LEVELS, _TPU_DRAM_NS
    return _CPU_LEVELS, _CPU_DRAM_NS


def expected_access_ns(working_set: float, hw: HardwareModel) -> float:
    """Mean time of one random access into a working set of given size."""
    levels, dram_ns = _levels_for(hw)
    if working_set <= 0:
        return levels[0][1]
    t, prev_cap = 0.0, 0.0
    for cap, ns in levels:
        frac = max(0.0, (min(working_set, cap) - prev_cap)) / working_set
        t += frac * ns
        prev_cap = cap
    t += max(0.0, working_set - levels[-1][0]) / working_set * dram_ns
    return t


def skewed_access_ns(working_set: float, hw: HardwareModel) -> float:
    """Access time into a power-law-accessed array: hot head resident."""
    hot = expected_access_ns(_HOT_FRAC * working_set, hw)
    cold = expected_access_ns(working_set, hw)
    return _HOT_HIT * hot + (1 - _HOT_HIT) * cold


@dataclass(frozen=True)
class PhaseCost:
    stream_bytes: float
    random_accesses: float
    working_set: float
    core_ns_per_access: float = 0.0
    skewed: bool = False

    def seconds(self, hw: HardwareModel) -> float:
        seq = self.stream_bytes / hw.dram_bandwidth
        acc = (
            skewed_access_ns(self.working_set, hw)
            if self.skewed
            else expected_access_ns(self.working_set, hw)
        )
        rand = self.random_accesses * (acc + self.core_ns_per_access) * 1e-9
        return seq + rand


def binning_cost(
    num_tuples: int, num_bins: int, hw: HardwareModel, tuple_bytes: int = TUPLE_BYTES
) -> PhaseCost:
    return PhaseCost(
        stream_bytes=2.0 * num_tuples * tuple_bytes,  # read stream + write bins
        random_accesses=float(num_tuples),
        working_set=num_bins * hw.cbuffer_bytes,
        core_ns_per_access=_BINNING_CORE_NS,
    )


def binread_cost(
    num_tuples: int,
    bin_range: int,
    hw: HardwareModel,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 8,
) -> PhaseCost:
    return PhaseCost(
        stream_bytes=float(num_tuples) * tuple_bytes,
        random_accesses=float(num_tuples),
        working_set=bin_range * value_bytes_per_index,
        core_ns_per_access=_BINREAD_CORE_NS,
    )


def baseline_cost(
    num_tuples: int,
    num_indices: int,
    hw: HardwareModel,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 8,
    randoms_per_tuple: float = 1.0,
    skewed: bool = False,
) -> PhaseCost:
    """Direct irregular execution: every update randomly accesses the
    full index range ``randoms_per_tuple`` times. skewed=True models
    power-law-concentrated accesses into vertex arrays."""
    return PhaseCost(
        stream_bytes=float(num_tuples) * tuple_bytes,
        random_accesses=float(num_tuples) * randoms_per_tuple,
        working_set=num_indices * value_bytes_per_index,
        core_ns_per_access=_BASELINE_CORE_NS,
        skewed=skewed,
    )


def neighpop_baseline_seconds(m: int, n: int, hw: HardwareModel) -> float:
    """Direct EL->CSR: per edge, a skewed offsets[src] fetch-add + a COLD
    neighbor-array write (every edge fills a distinct slot)."""
    skew = baseline_cost(m, n, hw, value_bytes_per_index=4, skewed=True).seconds(hw)
    cold = baseline_cost(m, m, hw, value_bytes_per_index=4, skewed=False).seconds(hw)
    return skew + cold


# --- PageRank per-iteration phase models (paper Table 1 / Fig. 5) --------


def pr_edgelist_iter_seconds(m: int, n: int, hw: HardwareModel) -> float:
    """EL-direct push: skewed contrib read + skewed rank write per edge."""
    return baseline_cost(m, n, hw, randoms_per_tuple=2.0, skewed=True).seconds(hw)


def pr_pull_iter_seconds(m: int, n: int, hw: HardwareModel) -> float:
    """CSC pull: sequential edge array, ONE skewed contrib read per edge,
    sequential rank writes."""
    return baseline_cost(
        m, n, hw, tuple_bytes=4, randoms_per_tuple=1.0, skewed=True
    ).seconds(hw)


def pr_pb_iter_seconds(m: int, n: int, bin_range: int, hw: HardwareModel) -> float:
    """PB push (Beamer): per iteration, contributions are produced
    sequentially and binned (sequential tuple streams); Bin-Read applies
    within the fast-level-resident range."""
    nb = num_bins_for_range(n, bin_range)
    return (
        binning_cost(m, nb, hw).seconds(hw) + binread_cost(m, bin_range, hw).seconds(hw)
    )


def pr_cobra_iter_seconds(m: int, plan: CobraPlan, hw: HardwareModel) -> float:
    """PageRank iteration under COBRA: binupdate-inserted tuples (no
    software binning instructions), Bin-Read at the optimal range —
    COBRA accelerates processing as well as pre-processing (Fig. 5)."""
    insert = PhaseCost(
        stream_bytes=2.0 * m * TUPLE_BYTES,
        random_accesses=float(m),
        working_set=float(plan.level_fanouts[0]) * hw.cbuffer_bytes,
        core_ns_per_access=_COBRA_CORE_NS,
    ).seconds(hw)
    return insert + binread_cost(m, plan.final_bin_range, hw).seconds(hw)


# --- Fused single-sweep execution (DESIGN.md §8) -------------------------
#
# The fused bin-and-accumulate removes the materialized binned stream:
# Binning's write sweep and Bin-Read's re-read sweep disappear, leaving
# one stream read plus one dense accumulator write-back. These explicit
# byte counters are the "traffic counters" fig6/fig5 report next to the
# measured HLO bytes.


def pb_two_phase_stream_bytes(
    num_tuples: int,
    num_indices: int,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 4,
) -> float:
    """Sequential HBM bytes of classic PB: Binning reads the stream and
    writes the binned copy (2 sweeps), Bin-Read re-reads the copy (a 3rd
    sweep) and writes the dense output once."""
    return 3.0 * num_tuples * tuple_bytes + num_indices * value_bytes_per_index


def fused_stream_bytes(
    num_tuples: int,
    num_indices: int,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 4,
) -> float:
    """Sequential HBM bytes of the fused sweep: read the stream once,
    write the accumulator back once — no intermediate ever exists."""
    return float(num_tuples) * tuple_bytes + num_indices * value_bytes_per_index


def fused_cost(
    num_tuples: int,
    num_indices: int,
    hw: HardwareModel,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 4,
) -> PhaseCost:
    """Fused bin-and-accumulate: one sequential sweep; every random
    access lands in the fast-level-resident accumulator (the legality
    condition ``PBExecutor.fused_fits`` enforces — C-Buffers share the
    same budget), with the binning engine's fixed-function per-tuple cost
    (COBRA's binupdate)."""
    return PhaseCost(
        stream_bytes=fused_stream_bytes(
            num_tuples, num_indices, tuple_bytes, value_bytes_per_index
        ),
        random_accesses=float(num_tuples),
        working_set=float(num_indices) * value_bytes_per_index,
        core_ns_per_access=_COBRA_CORE_NS,
    )


def fused_seconds(num_tuples: int, num_indices: int, hw: HardwareModel) -> float:
    return fused_cost(num_tuples, num_indices, hw).seconds(hw)


def pr_fused_iter_seconds(m: int, n: int, hw: HardwareModel) -> float:
    """PageRank iteration under the fused sweep (DESIGN.md §8):
    contributions are produced sequentially and bin-accumulated in one
    pass — no binned intermediate, no second sweep."""
    return fused_cost(m, n, hw).seconds(hw)


# --- Mesh-sharded execution (DESIGN.md §9) --------------------------------
#
# The device shard is the coarsest C-Buffer level and the interconnect is
# its eviction path: owner-routed tuples leave over ICI instead of
# bouncing through HBM, the received stream feeds the device-local fused
# sweep, and each device writes only its owned accumulator slice. Per-
# device HBM bytes therefore scale 1/n_dev for processing AND
# pre-processing streams — the scaling fig7_scaling.py reports. The CPU
# *emulation* materializes send/receive buffers in HBM (extra local
# sweeps); these counters model the hardware-assisted ideal the paper's
# binning engines would realize with an interconnect eviction port.

ICI_BANDWIDTH = H100_NVLINK_BW  # bytes/s a device sends + receives (plan.py)


def sharded_fused_hbm_bytes_per_device(
    num_tuples: int,
    num_indices: int,
    n_dev: int,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 4,
) -> float:
    """Per-device sequential HBM bytes of the sharded fused pipeline:
    read the local stream shard once, write the owned accumulator slice
    once. At ``n_dev=1`` this IS ``fused_stream_bytes`` (no exchange
    exists), and it decreases strictly monotonically with device count —
    the property the ROADMAP's production-scale target needs."""
    n_dev = max(1, n_dev)
    return (
        num_tuples / n_dev * tuple_bytes
        + num_indices / n_dev * value_bytes_per_index
    )


def sharded_exchange_bytes_per_device(
    num_tuples: int,
    n_dev: int,
    tuple_bytes: int = TUPLE_BYTES,
    padded_capacity: float | None = None,
) -> float:
    """Per-device interconnect bytes (send + receive) of the owner-routed
    all_to_all. ``padded_capacity=None`` models the ragged (exact)
    exchange: under uniform ownership each destination segment holds
    ``m_local / n_dev`` tuples, so ``(n_dev-1)/n_dev`` of a device's
    tuples cross the interconnect. A padded exchange ships full
    ``padded_capacity``-tuple segments instead (worst-case-skew safety at
    ``capacity = m_local`` costs a factor ``n_dev`` in exchange volume —
    the trade-off DESIGN.md §9 discusses)."""
    n_dev = max(1, n_dev)
    if n_dev == 1:
        return 0.0
    m_local = num_tuples / n_dev
    per_dest = padded_capacity if padded_capacity is not None else m_local / n_dev
    return 2.0 * (n_dev - 1) * per_dest * tuple_bytes


def sharded_exchange_chunk_bytes_per_device(
    num_tuples: int,
    n_dev: int,
    chunks: int,
    tuple_bytes: int = TUPLE_BYTES,
    padded_capacity: float | None = None,
) -> float:
    """Per-device interconnect bytes (send + receive) of ONE pipeline
    chunk's all_to_all (DESIGN.md §13): the local stream splits into
    ``chunks`` pieces, so each chunk ships ``1/chunks`` of the
    per-destination segment. ``padded_capacity`` here is the PER-CHUNK
    per-destination capacity of a padded exchange."""
    n_dev = max(1, n_dev)
    chunks = max(1, chunks)
    if n_dev == 1:
        return 0.0
    m_chunk = num_tuples / n_dev / chunks
    per_dest = padded_capacity if padded_capacity is not None else m_chunk / n_dev
    return 2.0 * (n_dev - 1) * per_dest * tuple_bytes


def sharded_pipelined_exchange_bytes_per_device(
    num_tuples: int,
    n_dev: int,
    chunks: int,
    tuple_bytes: int = TUPLE_BYTES,
    padded_capacity: float | None = None,
) -> float:
    """Total per-device interconnect bytes across all pipeline chunks —
    ``chunks ×`` the per-chunk counter. With ragged (exact) modeling the
    total is invariant in ``chunks`` (the same tuples cross the wire, in
    more launches); with per-chunk padding the total can exceed the
    monolithic padded exchange whenever per-chunk capacities round up."""
    return chunks * sharded_exchange_chunk_bytes_per_device(
        num_tuples, n_dev, chunks, tuple_bytes, padded_capacity
    )


def exchange_collective_launches(chunks: int, packed: bool = True) -> int:
    """Collective launches one sharded reduce issues: one all_to_all per
    chunk when index+value ride the packed buffer, two otherwise — the
    count the packed-exchange optimization halves (DESIGN.md §13)."""
    return max(1, chunks) * (1 if packed else 2)


def sharded_fused_seconds_per_device(
    num_tuples: int,
    num_indices: int,
    n_dev: int,
    hw: HardwareModel,
    ici_bandwidth: float = ICI_BANDWIDTH,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 4,
) -> float:
    """Per-device time of one sharded fused reduction: the device-local
    fused sweep over the owned shard (HBM + random-access model) plus the
    exchange on the interconnect. HBM and ICI phases are charged serially
    (conservative: no overlap)."""
    n_dev = max(1, n_dev)
    local = fused_cost(
        -(-num_tuples // n_dev),
        max(1, -(-num_indices // n_dev)),
        hw,
        tuple_bytes=tuple_bytes,
        value_bytes_per_index=value_bytes_per_index,
    ).seconds(hw)
    exch = sharded_exchange_bytes_per_device(num_tuples, n_dev, tuple_bytes)
    return local + exch / ici_bandwidth


# --- Pre-processing pipeline counters (DESIGN.md §10) ---------------------
#
# The preprocessing pipeline (core/preprocess.py) is a composition of PB
# stages; each gets an explicit sequential-byte counter so the pipeline's
# PreprocessReport can put modeled traffic next to measured wall-clock,
# and fig2_preproc_cost.py can report the amortization point on the same
# byte model the rest of the repo uses.


def degrees_stage_bytes(
    num_tuples: int, num_indices: int, index_bytes: int = 4,
    value_bytes_per_index: int = 4,
) -> float:
    """Fused degree count: read the src index stream once, write the
    dense degree array once (the ones-values stream never exists — it is
    synthesized on chip)."""
    return float(num_tuples) * index_bytes + float(num_indices) * value_bytes_per_index


def mapping_stage_bytes(num_indices: int, value_bytes_per_index: int = 4) -> float:
    """Reorder-variant mapping: read the degree array, write the sorted
    order, write the inverted new-id table — three n-sized sweeps (the
    sort's internal passes are fast-level resident at vertex-array
    sizes)."""
    return 3.0 * num_indices * value_bytes_per_index


def relabel_stage_bytes(num_tuples: int, index_bytes: int = 4) -> float:
    """Relabel: read both endpoint arrays, write both relabeled arrays —
    4 sequential sweeps. (The new-id gathers are random accesses into
    the n-sized mapping; at vertex-array sizes that table is fast-level
    resident, so this counter charges only the streams.)"""
    return 4.0 * num_tuples * index_bytes


def csr_build_stage_bytes(
    num_tuples: int, num_indices: int, build_method: str = "pb"
) -> float:
    """Sequential bytes of ONE EL->CSR (or EL->CSC) build. The baseline
    single-shot sort moves the tuple stream twice (read + permuted
    write) plus the offsets; PB/COBRA pay the two-phase stream
    (Binning write + Bin-Read re-read) modeled by
    ``pb_two_phase_stream_bytes``."""
    if build_method == "baseline":
        return 2.0 * num_tuples * TUPLE_BYTES + num_indices * 4.0
    return pb_two_phase_stream_bytes(num_tuples, num_indices)


def preproc_stage_bytes(
    stage: str, num_tuples: int, num_indices: int, build_method: str = "pb"
) -> float:
    """Modeled sequential bytes of one named pipeline stage — the single
    lookup ``PreprocessReport`` records per stage (DESIGN.md §10.3)."""
    if stage == "degrees":
        return degrees_stage_bytes(num_tuples, num_indices)
    if stage == "mapping":
        return mapping_stage_bytes(num_indices)
    if stage == "relabel":
        return relabel_stage_bytes(num_tuples)
    if stage in ("build_csr", "build_csc"):
        return csr_build_stage_bytes(num_tuples, num_indices, build_method)
    if stage == "slack":
        return slack_build_stage_bytes(num_tuples, num_indices)
    raise ValueError(f"unknown preprocess stage: {stage!r}")


def slack_build_stage_bytes(
    num_tuples: int,
    num_indices: int,
    headroom: float = 0.25,
    slot_bytes: int = 4,
) -> float:
    """Re-slack a built CSR into the mutable SlackCSR layout (DESIGN.md
    §15): read the compact neighbor array once, write the
    headroom-padded slab once, plus the offsets/counts sidecars."""
    slab = num_tuples * (1.0 + headroom) * slot_bytes
    sidecars = 2 * (num_indices + 1) * 4  # capacity offsets + counts
    return num_tuples * slot_bytes + slab + sidecars


# --- Frontier traversal counters (DESIGN.md §11) ---------------------------
#
# A traversal level moves: the frontier's CSR slice (the expansion
# gather), one (idx, val) reduce stream of the expanded tuples (fused:
# one sweep; two-phase: three), and a dense distance/degree update
# (read + write). Summed over levels the stream term totals the edge
# count once per relaxation — the per-level resolution is the point:
# short frontiers are latency-, not bandwidth-bound, which is why the
# executor's per-level decisions (sort at small buckets) matter.


def traversal_level_bytes(
    frontier_edges: int,
    num_indices: int,
    method: str = "fused",
    index_bytes: int = 4,
    value_bytes: int = 4,
) -> float:
    """Sequential bytes of ONE frontier level at the given reduce
    method (``fused`` = single sweep, anything else = the two-phase
    stream, ``unbinned`` = one stream read plus the dense update). A
    level that expanded nothing ran no reduce and no update: 0 bytes."""
    if frontier_edges == 0:
        return 0.0
    tuple_bytes = index_bytes + value_bytes
    if method == "fused":
        red = fused_stream_bytes(
            frontier_edges, num_indices, tuple_bytes, value_bytes
        )
    elif method == "unbinned":
        red = float(frontier_edges) * tuple_bytes + num_indices * value_bytes
    else:
        red = pb_two_phase_stream_bytes(
            frontier_edges, num_indices, tuple_bytes, value_bytes
        )
    gather = float(frontier_edges) * index_bytes  # CSR neighbor slice
    update = 2.0 * num_indices * value_bytes  # dist compare + rewrite
    return gather + red + update


def traversal_bytes(
    level_edges,
    num_indices: int,
    method: str = "fused",
    index_bytes: int = 4,
    value_bytes: int = 4,
) -> float:
    """Modeled sequential bytes of one whole traversal: the sum of its
    per-level counters. ``level_edges`` is the per-level expanded tuple
    count a ``TraversalResult.level_edges`` reports."""
    return sum(
        traversal_level_bytes(
            int(e), num_indices, method, index_bytes, value_bytes
        )
        for e in level_edges
    )


# --- Serving counters (DESIGN.md §12) --------------------------------------
#
# A serving tick coalesces up to B compatible queries into one batched
# kernel call. The byte win of coalescing is structural: per-level dense
# state (one dist/rank row per lane) scales with B, but fixed per-tick
# costs (planning, dispatch, the CSR offsets touch) are paid once — and
# for PPR the index stream itself is shared across the whole batch
# ((m, B) value block on ONE m-length index stream). These counters feed
# ``roofline.ServingRoofline``'s queue model and benchmarks/serving_load.


def ppr_batch_bytes(
    num_tuples: int,
    num_indices: int,
    batch: int,
    iters: int = 1,
    index_bytes: int = 4,
    value_bytes: int = 4,
) -> float:
    """Sequential bytes of ``iters`` coalesced PPR power iterations over
    ``batch`` lanes: the m-length index stream is read ONCE per iteration
    for the whole batch (the lanes ride it as an (m, B) value block),
    while contributions and the dense rank update scale with B. At B=1
    this is the single-query cost; the per-query saving vs B singles is
    exactly ``(B-1) * m * index_bytes`` per iteration."""
    batch = max(1, batch)
    per_iter = (
        float(num_tuples) * index_bytes  # shared dst index stream
        + float(num_tuples) * batch * value_bytes  # per-lane contributions
        + 2.0 * num_indices * batch * value_bytes  # rank read + write per lane
    )
    return iters * per_iter


def serving_tick_bytes(
    level_edges,
    num_indices: int,
    batch: int,
    method: str = "fused",
    index_bytes: int = 4,
    value_bytes: int = 4,
) -> float:
    """Modeled sequential bytes of ONE coalesced traversal tick serving
    ``batch`` queries. ``level_edges`` is the batch-AGGREGATE per-level
    expanded tuple count (what ``bfs_batched``/``sssp_batched`` report),
    so the per-level stream term is already the whole batch's traffic;
    the per-level dense update, however, is per lane (each query owns a
    dist row) — ``traversal_level_bytes`` charges one, the remaining
    ``batch - 1`` are added here."""
    batch = max(1, batch)
    total = 0.0
    for e in level_edges:
        e = int(e)
        if e == 0:
            continue
        total += traversal_level_bytes(
            e, num_indices, method, index_bytes, value_bytes
        )
        total += (batch - 1) * 2.0 * num_indices * value_bytes
    return total


def serving_query_bytes(
    level_edges,
    num_indices: int,
    batch: int,
    method: str = "fused",
    index_bytes: int = 4,
    value_bytes: int = 4,
) -> float:
    """Per-QUERY bytes of one coalesced tick: ``serving_tick_bytes``
    amortized over the batch — the service-cost input of the
    ``ServingRoofline`` queue model."""
    return serving_tick_bytes(
        level_edges, num_indices, batch, method, index_bytes, value_bytes
    ) / max(1, batch)


# --- Streaming update counters (DESIGN.md §15) -----------------------------
#
# apply_edge_batch is a PB workload over the BATCH, not the graph: two
# kind="update" reduce streams of batch length land per-vertex deltas in
# n-sized accumulators, deletes probe the touched vertices' slabs, and
# inserts write their slack slots. The rebuild alternative re-runs the
# identity preprocess pipeline over the whole edge array. The two curves
# cross at a batch size the model predicts and fig10_updates.py measures.


def update_batch_bytes(
    batch_size: int,
    num_indices: int,
    touched_degree_sum: int | None = None,
    method: str = "fused",
    index_bytes: int = 4,
    value_bytes: int = 4,
) -> float:
    """Sequential bytes of one delta-merge ``apply_edge_batch``: TWO
    batch-length kind="update" reduce streams (net degree delta + insert
    counts) into n-sized accumulators, the delete probes' slab reads
    (``touched_degree_sum`` slots; defaults to ``batch_size`` — one
    average-degree slab per tuple), the insert placements, and the
    counts-array rewrite. Scales with the BATCH, not the graph — the
    structural reason small batches beat rebuild."""
    b = float(max(0, batch_size))
    probes = float(
        touched_degree_sum if touched_degree_sum is not None else batch_size
    )
    tuple_bytes = index_bytes + value_bytes
    if method == "fused":
        reduces = 2.0 * fused_stream_bytes(
            int(b), num_indices, tuple_bytes, value_bytes
        )
    else:
        reduces = 2.0 * pb_two_phase_stream_bytes(
            int(b), num_indices, tuple_bytes, value_bytes
        )
    placement = b * (index_bytes + value_bytes)  # slot id + neighbor write
    counts = 2.0 * (num_indices + 1) * 4  # counts read + rewrite
    return reduces + probes * index_bytes + placement + counts


def update_rebuild_bytes(
    num_tuples: int,
    num_indices: int,
    build_method: str = "pb",
    headroom: float = 0.25,
) -> float:
    """Sequential bytes of the full-rebuild alternative: the identity
    preprocess pipeline over the WHOLE edge array (degree pass + EL->CSR
    build) plus the re-slack into the mutable layout. Scales with m — a
    floor no batch size changes."""
    return (
        degrees_stage_bytes(num_tuples, num_indices)
        + csr_build_stage_bytes(num_tuples, num_indices, build_method)
        + slack_build_stage_bytes(num_tuples, num_indices, headroom)
    )


def update_crossover_batch(
    num_tuples: int,
    num_indices: int,
    batch_grid,
    method: str = "fused",
    build_method: str = "pb",
) -> int | None:
    """Smallest batch size in ``batch_grid`` where the delta-merge model
    moves MORE bytes than one full rebuild — the modeled
    incremental-vs-rebuild crossover fig10 reports next to the measured
    one. Returns None when incremental wins everywhere on the grid."""
    rebuild = update_rebuild_bytes(num_tuples, num_indices, build_method)
    for b in sorted(int(x) for x in batch_grid):
        if update_batch_bytes(b, num_indices, method=method) > rebuild:
            return b
    return None


# --- Row-block SpMM counters (DESIGN.md §14) -------------------------------
#
# A row-block stream carries a dense F-column feature row per tuple, so
# the value term scales with F while the index term does not. The fused
# feature-tiled C-Buffer re-streams the INDEX lane once per F-tile sweep
# (F/F_tile sweeps, F_tile columns of the rows resident per sweep) but
# reads each value row exactly once in total; classic two-phase PB pays
# the full (index + row) tuple three sweeps. That asymmetry is the F*
# crossover fig9_spmm.py measures: the bigger F, the larger the share of
# traffic the fused path moves exactly once.


def spmm_ftile_sweeps(feature_dim: int, f_tile: int | None = None) -> int:
    """Number of F-tile sweeps the fused row-block kernel runs — how many
    times the binned index lane is re-streamed (DESIGN.md §14.2)."""
    feature_dim = max(1, feature_dim)
    ft = feature_dim if not f_tile else max(1, min(f_tile, feature_dim))
    return -(-feature_dim // ft)


def spmm_bytes(
    num_tuples: int,
    num_indices: int,
    feature_dim: int,
    method: str = "fused",
    index_bytes: int = 4,
    value_bytes: int = 4,
    f_tile: int | None = None,
) -> float:
    """Sequential HBM bytes of one (m, F) row-block reduction into an
    (n, F) accumulator at the given method.

    ``fused``       — F/F_tile index-lane sweeps + ONE pass over the row
                      payload + one accumulator write-back.
    ``segment_sum`` — one pass over index + rows, one output write (the
                      XLA baseline's *sequential* traffic; its scatter's
                      random-access cost is what the roofline term adds).
    anything else   — classic two-phase PB: the full (index + row) tuple
                      moves three times (bin write + re-read) plus the
                      output write.

    At F=1, ``f_tile=None`` this degrades exactly to the scalar
    counters: ``fused`` == ``fused_stream_bytes`` and the two-phase arm
    == ``pb_two_phase_stream_bytes`` at ``tuple_bytes=8``.
    """
    m = float(num_tuples)
    F = max(1, feature_dim)
    row_bytes = F * value_bytes
    out_bytes = float(num_indices) * F * value_bytes
    if method == "fused":
        sweeps = spmm_ftile_sweeps(F, f_tile)
        return sweeps * m * index_bytes + m * row_bytes + out_bytes
    if method == "segment_sum":
        return m * (index_bytes + row_bytes) + out_bytes
    return 3.0 * m * (index_bytes + row_bytes) + out_bytes


def spmm_access_seconds(
    num_tuples: int,
    num_indices: int,
    feature_dim: int,
    method: str,
    hw: HardwareModel,
    bin_range: int | None = None,
    index_bytes: int = 4,
    value_bytes: int = 4,
    f_tile: int | None = None,
) -> float:
    """Modeled seconds of one (m, F) row-block reduction under the full
    access-cost model (sequential bytes + random accesses into the arm's
    working set). This is where the fused-vs-``segment_sum`` difference
    lives: their SEQUENTIAL bytes tie (same stream, same output — no
    static byte counter can tell them apart, ``hlo_bytes_accessed``
    included), but ``segment_sum`` on the raw COO-order stream scatters
    into the full (n, F) state while the fused path's accesses land in
    the bin-resident (bin_range, F_tile) accumulator tile — the paper's
    locality argument, charged by the same model fig3/fig5 use."""
    m, F = float(num_tuples), max(1, feature_dim)
    r = bin_range or max(1, min(512, num_indices))
    stream = spmm_bytes(
        num_tuples, num_indices, F, method, index_bytes, value_bytes, f_tile
    )
    if method == "fused":
        ft = F if not f_tile else max(1, min(f_tile, F))
        return PhaseCost(
            stream_bytes=stream,
            random_accesses=m * spmm_ftile_sweeps(F, f_tile),
            working_set=float(r) * ft * value_bytes,
            core_ns_per_access=_COBRA_CORE_NS,
        ).seconds(hw)
    if method == "segment_sum":
        return PhaseCost(
            stream_bytes=stream,
            random_accesses=m,
            working_set=float(num_indices) * F * value_bytes,
            core_ns_per_access=_BASELINE_CORE_NS,
        ).seconds(hw)
    nb = num_bins_for_range(num_indices, r)
    tb = index_bytes + F * value_bytes
    return (
        binning_cost(num_tuples, nb, hw, tuple_bytes=tb).seconds(hw)
        + binread_cost(
            num_tuples, r, hw, tuple_bytes=tb,
            value_bytes_per_index=F * value_bytes,
        ).seconds(hw)
    )


def spmm_crossover_f(
    num_tuples: int,
    num_indices: int,
    f_grid,
    baseline: str = "two_phase",
    index_bytes: int = 4,
    value_bytes: int = 4,
    f_tile: int | None = None,
) -> int | None:
    """Smallest F in ``f_grid`` where the fused row-block model moves
    strictly fewer bytes than ``baseline`` — the modeled F* fig9 reports
    next to the measured one. Returns None when fused never wins on the
    grid."""
    for F in sorted(int(f) for f in f_grid):
        fused = spmm_bytes(
            num_tuples, num_indices, F, "fused", index_bytes, value_bytes,
            f_tile,
        )
        base = spmm_bytes(
            num_tuples, num_indices, F, baseline, index_bytes, value_bytes,
        )
        if fused < base:
            return F
    return None


def pb_seconds(
    num_tuples: int, num_indices: int, bin_range: int, hw: HardwareModel
) -> float:
    nb = num_bins_for_range(num_indices, bin_range)
    return (
        binning_cost(num_tuples, nb, hw).seconds(hw)
        + binread_cost(num_tuples, bin_range, hw).seconds(hw)
    )


def pb_ideal_seconds(num_tuples: int, num_indices: int, hw: HardwareModel) -> float:
    """Each phase at its own optimum (paper Table 2's PB-Ideal)."""
    best_read_range = binread_optimal_range(hw)
    best_bin_count = min(
        binning_optimal_num_bins(hw), num_bins_for_range(num_indices, 1)
    )
    return (
        binning_cost(num_tuples, best_bin_count, hw).seconds(hw)
        + binread_cost(num_tuples, best_read_range, hw).seconds(hw)
    )


def cobra_seconds(num_tuples: int, plan: CobraPlan, hw: HardwareModel) -> float:
    """COBRA execution: the core issues one ``binupdate`` per tuple
    (~_COBRA_CORE_NS instead of software binning's bookkeeping); every
    level's C-Buffers are resident by construction, and the binning
    engines' eviction buffers keep the inter-level scatter off the
    critical path — the hierarchy's cost to the core is the L1-level
    insert plus the sequential bin-write stream. Bin-Read then runs at
    its optimal range."""
    insert = PhaseCost(
        stream_bytes=2.0 * num_tuples * TUPLE_BYTES,
        random_accesses=float(num_tuples),
        working_set=float(plan.level_fanouts[0]) * hw.cbuffer_bytes,
        core_ns_per_access=_COBRA_CORE_NS,
    ).seconds(hw)
    read = binread_cost(num_tuples, plan.final_bin_range, hw).seconds(hw)
    return insert + read


def baseline_seconds(num_tuples: int, num_indices: int, hw: HardwareModel) -> float:
    return baseline_cost(num_tuples, num_indices, hw).seconds(hw)

"""Roofline views of the port's cost models (port of ``repro/roofline.py``).

``Roofline`` turns a cell's global FLOPs, bytes and collective bytes into
three times per step,

  compute    = FLOPs / (chips * peak_flops)
  memory     = bytes / (chips * hbm_bw)
  collective = collective_bytes / (chips * ici_bw)

and names the largest; ``extrapolate`` carries a cost measured at two
layer counts to a third. The stream rooflines (``PBStreamRoofline``,
``SpMMRoofline``, ``ShardedPBStreamRoofline``, ``TraversalRoofline``,
``UpdateRoofline``, ``PreprocessRoofline``) divide the byte counters of
``core/traffic.py`` by a bandwidth, and ``ServingRoofline`` is the M/D/1
queue of coalesced serving. The arithmetic is the reference's, term for
term (``tests/test_torch_cost_models.py``).

Defaults are the H100 SXM's (``core/plan.py``): ``H100_BF16_FLOPS`` (989
TFLOP/s dense bf16), ``H100_HBM_BW`` (3.35 TB/s HBM3) and
``H100_NVLINK_BW`` (NVLink, 900 GB/s sent and received). The reference's
defaults are another machine's; pass them explicitly to reproduce its
numbers.

No twin: the reference fills ``CellCost`` from XLA's compiled programs
(``hlo_bytes_accessed``, ``collective_bytes_from_hlo`` and
``shape_bytes`` with their HLO regexes). Those read XLA's HLO and have no
PyTorch meaning; they are shims, like ``launch/mesh.py`` (ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.plan import H100_BF16_FLOPS, H100_HBM_BW, H100_NVLINK_BW


@dataclass
class CellCost:
    """Raw per-device costs of one compiled module."""

    flops: float
    bytes_accessed: float
    collective: Dict[str, float]
    num_layers: int


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float  # global
    bytes_accessed: float  # global
    collective_bytes: float  # global
    model_flops: float  # 6*N_active*tokens (analytic)
    peak_flops: float = H100_BF16_FLOPS
    hbm_bw: float = H100_HBM_BW
    ici_bw: float = H100_NVLINK_BW
    memory_fit: Optional[str] = None
    collective_detail: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.ici_bw)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at
        the max of the three terms: useful_compute_time / step_time."""
        t_model = self.model_flops / (self.chips * self.peak_flops)
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_model / max(t_step, 1e-30)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops": self.flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_detail": self.collective_detail,
            "memory_fit": self.memory_fit,
        }


# ---------------------------------------------------------------------------
# PB stream traffic on the roofline (DESIGN.md §8).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PBStreamRoofline:
    """HBM-roofline view of one irregular update stream, two-phase vs
    fused execution (DESIGN.md §8).

    Two-phase PB moves the tuple stream three times (Binning read+write,
    Bin-Read re-read) plus the dense output; the fused sweep moves it
    once plus the output. At a fixed HBM bandwidth the byte ratio IS the
    bandwidth-bound speedup ceiling, which is what makes the fused
    column's sub-2x measured gains interpretable.
    """

    num_tuples: int
    num_indices: int
    tuple_bytes: int = 8
    value_bytes: int = 4
    hbm_bw: float = H100_HBM_BW

    @property
    def two_phase_bytes(self) -> float:
        from repro_torch.core.traffic import pb_two_phase_stream_bytes

        return pb_two_phase_stream_bytes(
            self.num_tuples, self.num_indices, self.tuple_bytes, self.value_bytes
        )

    @property
    def fused_bytes(self) -> float:
        from repro_torch.core.traffic import fused_stream_bytes

        return fused_stream_bytes(
            self.num_tuples, self.num_indices, self.tuple_bytes, self.value_bytes
        )

    @property
    def bytes_saved_frac(self) -> float:
        return 1.0 - self.fused_bytes / self.two_phase_bytes

    @property
    def t_two_phase(self) -> float:
        return self.two_phase_bytes / self.hbm_bw

    @property
    def t_fused(self) -> float:
        return self.fused_bytes / self.hbm_bw

    @property
    def speedup_ceiling(self) -> float:
        return self.two_phase_bytes / self.fused_bytes


@dataclass(frozen=True)
class SpMMRoofline:
    """HBM-roofline view of one (m, F) row-block reduction — PB as SpMM
    (DESIGN.md §14). Three arms share the byte model of
    ``traffic.spmm_bytes``: the feature-tiled fused C-Buffer (index lane
    re-streamed F/F_tile times, row payload moved once), classic
    two-phase PB (full tuple moved three times), and ``segment_sum``
    (one pass, XLA's in the reference and ``index_add_`` in the port;
    its scatter's random-access cost is outside the
    sequential-byte model, which is why measured wall-clock can favor
    fused before the byte model does). The F* crossover — the smallest F
    where fused moves fewer bytes than a baseline — is what
    ``benchmarks/fig9_spmm.py`` reports modeled next to measured."""

    num_tuples: int
    num_indices: int
    feature_dim: int
    f_tile: Optional[int] = None
    index_bytes: int = 4
    value_bytes: int = 4
    hbm_bw: float = H100_HBM_BW

    def _bytes(self, method: str) -> float:
        from repro_torch.core.traffic import spmm_bytes

        return spmm_bytes(
            self.num_tuples, self.num_indices, self.feature_dim, method,
            self.index_bytes, self.value_bytes, self.f_tile,
        )

    @property
    def ftile_sweeps(self) -> int:
        from repro_torch.core.traffic import spmm_ftile_sweeps

        return spmm_ftile_sweeps(self.feature_dim, self.f_tile)

    @property
    def fused_bytes(self) -> float:
        return self._bytes("fused")

    @property
    def two_phase_bytes(self) -> float:
        return self._bytes("two_phase")

    @property
    def segment_sum_bytes(self) -> float:
        return self._bytes("segment_sum")

    @property
    def t_fused(self) -> float:
        return self.fused_bytes / self.hbm_bw

    @property
    def t_two_phase(self) -> float:
        return self.two_phase_bytes / self.hbm_bw

    @property
    def t_segment_sum(self) -> float:
        return self.segment_sum_bytes / self.hbm_bw

    @property
    def speedup_ceiling_vs_two_phase(self) -> float:
        return self.two_phase_bytes / self.fused_bytes

    @property
    def speedup_ceiling_vs_segment_sum(self) -> float:
        return self.segment_sum_bytes / self.fused_bytes

    def crossover_f(self, f_grid, baseline: str = "two_phase"):
        """Modeled F*: smallest F in ``f_grid`` where fused wins on
        bytes vs ``baseline`` (None if it never does)."""
        from repro_torch.core.traffic import spmm_crossover_f

        return spmm_crossover_f(
            self.num_tuples, self.num_indices, f_grid, baseline,
            self.index_bytes, self.value_bytes, self.f_tile,
        )


@dataclass(frozen=True)
class ShardedPBStreamRoofline:
    """Roofline view of one mesh-sharded irregular update stream
    (DESIGN.md §9): per-device HBM bytes of the owner-sharded fused
    execution next to the interconnect bytes of the owner-routed
    exchange. The max of the two times is the per-reduction step floor;
    against the single-device fused floor it bounds strong-scaling
    speedup — the interconnect term is what caps it once
    ``hbm_bytes/hbm_bw < ici_bytes/ici_bw``."""

    num_tuples: int
    num_indices: int
    n_dev: int
    tuple_bytes: int = 8
    value_bytes: int = 4
    hbm_bw: float = H100_HBM_BW
    ici_bw: float = H100_NVLINK_BW
    padded_capacity: Optional[float] = None
    # pipeline depth K of the chunked exchange (DESIGN.md §13); 1 = the
    # monolithic partition -> all_to_all -> reduce schedule
    pipeline_chunks: int = 1
    # fixed cost per collective launch, charged once per chunk in
    # best_pipeline_chunks — the term that makes K=1 win on tiny streams
    launch_overhead_s: float = 20e-6

    @property
    def hbm_bytes_per_device(self) -> float:
        from repro_torch.core.traffic import sharded_fused_hbm_bytes_per_device

        return sharded_fused_hbm_bytes_per_device(
            self.num_tuples, self.num_indices, self.n_dev,
            self.tuple_bytes, self.value_bytes,
        )

    @property
    def ici_bytes_per_device(self) -> float:
        from repro_torch.core.traffic import sharded_exchange_bytes_per_device

        return sharded_exchange_bytes_per_device(
            self.num_tuples, self.n_dev, self.tuple_bytes, self.padded_capacity
        )

    @property
    def t_hbm(self) -> float:
        return self.hbm_bytes_per_device / self.hbm_bw

    @property
    def t_ici(self) -> float:
        return self.ici_bytes_per_device / self.ici_bw

    @property
    def bottleneck(self) -> str:
        return "hbm" if self.t_hbm >= self.t_ici else "interconnect"

    @property
    def t_step(self) -> float:
        """Fully-overlapped floor: the slower of the two engines. The
        schedule-aware time for a given K is ``t_pipelined``."""
        return max(self.t_hbm, self.t_ici)

    @property
    def t_sequential(self) -> float:
        """The K=1 schedule: exchange fully drains, then the local
        reduce runs — the interconnect and HBM each idle while the other works."""
        return self.t_hbm + self.t_ici

    def t_pipelined(self, chunks: Optional[int] = None) -> float:
        """Modeled step time of the K-chunk double-buffered schedule
        (DESIGN.md §13): the first chunk's exchange is exposed (interconnect
        prologue, t_ici/K), the last chunk's reduce is exposed (HBM
        epilogue, t_hbm/K), and the K-1 middle slots each take the max
        of one chunk-exchange and one chunk-reduce. K=1 recovers
        ``t_sequential``; K→∞ approaches ``t_step`` (perfect overlap)."""
        k = self.pipeline_chunks if chunks is None else chunks
        k = max(1, int(k))
        if k == 1:
            return self.t_sequential
        th, ti = self.t_hbm, self.t_ici
        return ti / k + (k - 1) / k * max(th, ti) + th / k

    def hidden_exchange_fraction(self, chunks: Optional[int] = None) -> float:
        """Fraction of the exchange time hidden behind local reduces:
        0 at K=1 (fully exposed), → 1 as overlap approaches perfect
        when HBM is the bottleneck. fig7 reports this modeled value
        next to the measured overlap efficiency."""
        ti = self.t_ici
        if ti <= 0.0:
            return 1.0
        exposed = self.t_pipelined(chunks) - self.t_hbm
        return min(1.0, max(0.0, 1.0 - exposed / ti))

    def overlap_efficiency(self, chunks: Optional[int] = None) -> float:
        """Modeled speedup of the K-chunk schedule over sequential:
        t_sequential / t_pipelined(K), in [1, 2]."""
        return self.t_sequential / max(self.t_pipelined(chunks), 1e-30)

    def best_pipeline_chunks(self, max_chunks: int = 4) -> int:
        """The K (power of two up to ``max_chunks``) minimizing modeled
        pipelined time plus per-chunk launch overhead. Tiny streams pick
        K=1: the overlap saving (bounded by min(t_hbm, t_ici)) cannot
        pay for extra collective launches."""
        best_k, best_t = 1, self.t_sequential + self.launch_overhead_s
        k = 2
        while k <= max_chunks:
            t = self.t_pipelined(k) + k * self.launch_overhead_s
            if t < best_t:
                best_k, best_t = k, t
            k *= 2
        return best_k

    @property
    def speedup_ceiling(self) -> float:
        """Bandwidth-bound speedup over the single-device fused sweep."""
        single = PBStreamRoofline(
            self.num_tuples, self.num_indices, self.tuple_bytes,
            self.value_bytes, self.hbm_bw,
        ).t_fused
        return single / max(self.t_step, 1e-30)


@dataclass(frozen=True)
class TraversalRoofline:
    """HBM-roofline view of one frontier traversal (DESIGN.md §11).

    ``level_edges`` is the per-level expanded tuple count
    (``TraversalResult.level_edges``). Per level the executor's choice
    moves either the fused single sweep or the two-phase stream
    (``traffic.traversal_level_bytes``); against the unbinned dense
    scatter the byte ratio is the bandwidth-bound ceiling on the PB
    speedup fig8 measures. Short levels are latency-bound — the bytes
    model says they are ~free, which is exactly why the per-level
    decision (sort at small buckets) and not one whole-run method is the
    right policy.
    """

    level_edges: Tuple[int, ...]
    num_indices: int
    value_bytes: int = 4
    hbm_bw: float = H100_HBM_BW

    def _bytes(self, method: str) -> float:
        from repro_torch.core.traffic import traversal_bytes

        return traversal_bytes(
            self.level_edges,
            self.num_indices,
            method,
            value_bytes=self.value_bytes,
        )

    @property
    def fused_bytes(self) -> float:
        return self._bytes("fused")

    @property
    def two_phase_bytes(self) -> float:
        return self._bytes("sort")

    @property
    def unbinned_bytes(self) -> float:
        return self._bytes("unbinned")

    @property
    def t_fused(self) -> float:
        return self.fused_bytes / self.hbm_bw

    @property
    def t_two_phase(self) -> float:
        return self.two_phase_bytes / self.hbm_bw

    @property
    def speedup_ceiling(self) -> float:
        """Bandwidth-bound ceiling of fused over two-phase execution."""
        return self.two_phase_bytes / max(self.fused_bytes, 1e-30)

    @property
    def num_levels(self) -> int:
        return len(self.level_edges)

    @property
    def total_edges(self) -> int:
        return int(sum(self.level_edges))


@dataclass(frozen=True)
class ServingRoofline:
    """Queueing view of coalesced graph-query serving (DESIGN.md §12).

    Open-loop Poisson arrivals at ``arrival_qps`` against a server that
    ticks: one tick serves up to ``batch`` coalesced queries in
    ``tick_seconds`` (measured, or the bandwidth-bound floor
    ``traffic.serving_tick_bytes / hbm_bw``). With deterministic batch
    service this is an M/D/1 queue in units of ticks: utilization
    ``rho = lambda * s / B``, mean queueing wait ``rho*s / (2(1-rho))``
    (Pollaczek-Khinchine with zero service variance), saturating at
    ``B / s`` qps. The saturation sweep in benchmarks/serving_load.py
    reports the measured curve next to this model: below saturation
    latency is flat-ish, past it the backlog — and p99 — grows without
    bound, which is why max_batch (not kernel speed) sets the knee.
    """

    arrival_qps: float
    batch: int
    tick_seconds: float

    @property
    def saturation_qps(self) -> float:
        """Throughput ceiling: every tick full."""
        return self.batch / max(self.tick_seconds, 1e-30)

    @property
    def utilization(self) -> float:
        return self.arrival_qps / self.saturation_qps

    @property
    def stable(self) -> bool:
        return self.utilization < 1.0

    @property
    def mean_wait_seconds(self) -> float:
        """M/D/1 mean queueing delay; inf at/past saturation."""
        rho = self.utilization
        if rho >= 1.0:
            return float("inf")
        return rho * self.tick_seconds / (2.0 * (1.0 - rho))

    @property
    def mean_latency_seconds(self) -> float:
        """Queueing wait + one service tick."""
        return self.mean_wait_seconds + self.tick_seconds


@dataclass(frozen=True)
class UpdateRoofline:
    """HBM-roofline view of streaming graph mutation (DESIGN.md §15):
    the modeled sequential bytes of one delta-merge ``apply_edge_batch``
    (two kind="update" reduce streams + slot edits — scales with the
    BATCH) against one full rebuild through the identity preprocess
    pipeline (degree pass + EL->CSR build + re-slack — scales with the
    GRAPH). Their ratio bounds the incremental speedup at a batch size,
    and ``crossover_batch`` is the modeled batch where rebuild starts
    winning — the number fig10_updates.py reports next to the measured
    crossover."""

    num_tuples: int  # live edges in the graph (the rebuild's m)
    num_indices: int
    batch_size: int
    method: str = "fused"
    build_method: str = "pb"
    hbm_bw: float = H100_HBM_BW

    @property
    def incremental_bytes(self) -> float:
        from repro_torch.core.traffic import update_batch_bytes

        return update_batch_bytes(
            self.batch_size, self.num_indices, method=self.method
        )

    @property
    def rebuild_bytes(self) -> float:
        from repro_torch.core.traffic import update_rebuild_bytes

        return update_rebuild_bytes(
            self.num_tuples, self.num_indices, self.build_method
        )

    @property
    def t_incremental(self) -> float:
        return self.incremental_bytes / self.hbm_bw

    @property
    def t_rebuild(self) -> float:
        return self.rebuild_bytes / self.hbm_bw

    @property
    def speedup_ceiling(self) -> float:
        """Bandwidth-bound speedup of delta-merge over rebuild at this
        batch size (< 1 past the crossover)."""
        return self.rebuild_bytes / max(self.incremental_bytes, 1e-30)

    def crossover_batch(self, batch_grid):
        """Modeled crossover: smallest batch in ``batch_grid`` where one
        rebuild moves fewer bytes than the delta-merge (None if
        incremental wins on the whole grid)."""
        from repro_torch.core.traffic import update_crossover_batch

        return update_crossover_batch(
            self.num_tuples, self.num_indices, batch_grid, self.method,
            self.build_method,
        )


@dataclass(frozen=True)
class PreprocessRoofline:
    """HBM-roofline view of the preprocessing pipeline (DESIGN.md §10):
    the modeled sequential bytes of every stage (degrees + mapping +
    relabel + per-direction builds) against the per-iteration bytes of a
    downstream kernel. ``amortization_iters`` is the byte-model analogue
    of ``preprocess.amortization_iters``: iterations of the downstream
    kernel needed before the reorder's per-iteration byte saving has
    paid for the pipeline — ``inf`` when the reordered layout moves no
    fewer bytes (locality gains that don't change sequential traffic are
    invisible to this counter; the measured column in
    fig2_preproc_cost.py captures those)."""

    num_tuples: int
    num_indices: int
    dual: bool = True
    build_method: str = "pb"
    hbm_bw: float = H100_HBM_BW

    @property
    def stage_bytes(self) -> Dict[str, float]:
        from repro_torch.core.traffic import preproc_stage_bytes

        stages = ["degrees", "mapping", "relabel", "build_csr"]
        if self.dual:
            stages.append("build_csc")
        return {
            s: preproc_stage_bytes(
                s, self.num_tuples, self.num_indices, self.build_method
            )
            for s in stages
        }

    @property
    def total_bytes(self) -> float:
        return sum(self.stage_bytes.values())

    @property
    def t_preproc(self) -> float:
        return self.total_bytes / self.hbm_bw

    def amortization_iters(
        self, iter_bytes_before: float, iter_bytes_after: float
    ) -> float:
        saved = iter_bytes_before - iter_bytes_after
        if saved <= 0.0:
            return float("inf")
        return self.total_bytes / saved


def extrapolate(c_a: CellCost, c_b: CellCost, num_layers: int) -> CellCost:
    dl = c_b.num_layers - c_a.num_layers
    assert dl > 0

    def lin(a, b):
        per = (b - a) / dl
        return a + per * (num_layers - c_a.num_layers)

    coll = {
        k: lin(c_a.collective.get(k, 0.0), c_b.collective.get(k, 0.0))
        for k in set(c_a.collective) | set(c_b.collective)
    }
    return CellCost(
        flops=lin(c_a.flops, c_b.flops),
        bytes_accessed=lin(c_a.bytes_accessed, c_b.bytes_accessed),
        collective=coll,
        num_layers=num_layers,
    )

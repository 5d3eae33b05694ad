"""PreprocessPipeline: PB-accelerated preprocessing end to end (port of
``repro/core/preprocess.py``).

Pre-processing (EL->CSR construction, reordering) is itself a PB workload
and can cost as much as the kernel that follows; this module makes that
measurable stage by stage:

  degrees   — degree count: an ``add`` reduce through
              ``PBExecutor.reduce_stream`` (the fused kernel on the card
              when the executor decides it);
  mapping   — a ``reorder.REORDER_VARIANTS`` variant over the stage-1
              histogram (the degree pass is shared);
  relabel   — endpoint rewrite under the new ids;
  build_csr — Neighbor-Populate of the relabeled Edgelist (any
              ``neighbor_populate.build_csr`` method), reusing stage 1's
              histogram permuted under the new ids;
  build_csc — the pull layout from the dst-keyed stream of the same
              relabeled Edgelist;
  slack     — (with ``slack_headroom``) the mutable ``SlackCSR`` re-slack
              of the built CSR.

Each stage is timed between CUDA synchronisations when its output lies on
the card (the reference waits with ``jax.block_until_ready``), and the
report puts the modeled bytes (``traffic.preproc_stage_bytes``) and the
executor decisions the stage took beside it. With ``mesh=`` (a
``distributed_pb.StreamMesh``) the degree count and both builds run
through the sharded paths over the mesh's ranks (``build_method`` becomes
``sharded``, and the report says ``sharded=True``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import neighbor_populate as npop
from repro_torch.core import traffic
from repro_torch.core.executor import PBExecutor, get_default_executor
from repro_torch.core.graph import COO, CSR, SlackCSR
from repro_torch.core.reorder import REORDER_VARIANTS, relabel_coo, reorder_mapping


@dataclass(frozen=True)
class StageReport:
    """One pipeline stage: what ran, how long, what it should have moved."""

    name: str
    seconds: float
    modeled_bytes: float
    # the executor decision records this stage appended (empty for the
    # pure-relabel stages and for caller-forced methods)
    decisions: Tuple[dict, ...] = ()
    # wall-clock of the warm-up pass (first run, kernel builds included);
    # 0.0 when the pipeline ran cold (warmup=False)
    compile_seconds: float = 0.0

    def describe(self) -> str:
        ms = ", ".join(
            f"{d['method']}@r{d['bin_range']}[{d['source']}]" for d in self.decisions
        )
        return f"{self.name}: {self.seconds*1e6:.0f}us {self.modeled_bytes:.3g}B" + (
            f" ({ms})" if ms else ""
        )


@dataclass(frozen=True)
class PreprocessReport:
    """Per-stage account of one pipeline run."""

    variant: str
    build_method: str
    num_nodes: int
    num_edges: int
    sharded: bool
    stages: Tuple[StageReport, ...]

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.stages)

    @property
    def total_compile_seconds(self) -> float:
        return sum(s.compile_seconds for s in self.stages)

    @property
    def total_modeled_bytes(self) -> float:
        return sum(s.modeled_bytes for s in self.stages)

    def stage(self, name: str) -> StageReport:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"no stage {name!r} in {[s.name for s in self.stages]}")

    def decisions(self) -> Tuple[dict, ...]:
        return tuple(d for s in self.stages for d in s.decisions)

    def as_dict(self) -> dict:
        return {
            "variant": self.variant,
            "build_method": self.build_method,
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "sharded": self.sharded,
            "total_seconds": self.total_seconds,
            "total_modeled_bytes": self.total_modeled_bytes,
            "stages": [
                {
                    "name": s.name,
                    "seconds": s.seconds,
                    "compile_seconds": s.compile_seconds,
                    "modeled_bytes": s.modeled_bytes,
                    "decisions": list(s.decisions),
                }
                for s in self.stages
            ],
        }


class PreprocessResult(NamedTuple):
    """What the pipeline hands downstream: both layouts and the mapping."""

    csr: CSR
    csc: Optional[CSR]
    new_ids: torch.Tensor
    degrees: torch.Tensor  # stage-1 degree histogram (pre-relabel ids)
    report: PreprocessReport
    slack: Optional[SlackCSR] = None  # with slack_headroom, else None


def amortization_iters(
    preproc_seconds: float, iter_seconds_before: float, iter_seconds_after: float
) -> float:
    """Downstream iterations that pay for preprocessing: its cost over the
    per-iteration saving; ``inf`` when the reordered layout is no faster."""
    gain = iter_seconds_before - iter_seconds_after
    if gain <= 0.0:
        return float("inf")
    return preproc_seconds / gain


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)


def _wait(out):
    """Wait until the card has written ``out`` (nothing to wait for on
    the CPU)."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


class PreprocessPipeline:
    """Composable EL -> (reordered CSR [+ CSC] [+ SlackCSR]) pipeline.

    ``variant``: a ``REORDER_VARIANTS`` key (``identity`` makes it a pure
    build). ``build_method``: a ``neighbor_populate.BUILD_METHODS`` entry
    (``auto`` lets the executor decide; ``sharded`` is implied by
    ``mesh``). ``mesh``: a 1-D ``StreamMesh``; the degree count and both
    builds run over its ranks. ``executor``: the PBExecutor the
    degree stage routes through and whose decisions the report records
    (the process default when None). ``warmup``: run each stage once
    untimed first, so ``seconds`` is steady-state and the first run lands
    in ``compile_seconds``. ``slack_headroom``: add the "slack" stage.
    """

    def __init__(
        self,
        variant: str = "degree_sort",
        build_method: str = "auto",
        *,
        with_csc: bool = True,
        bin_range: Optional[int] = None,
        mesh=None,
        axis_name: Optional[str] = None,
        executor: Optional[PBExecutor] = None,
        seed: int = 0,
        warmup: bool = True,
        slack_headroom: Optional[float] = None,
        slack_min_slack: int = 4,
    ):
        if variant not in REORDER_VARIANTS:
            raise ValueError(
                f"unknown reorder variant: {variant!r} (want one of {tuple(REORDER_VARIANTS)})"
            )
        if build_method not in npop.BUILD_METHODS:
            raise ValueError(
                f"unknown build method: {build_method!r} (want one of {npop.BUILD_METHODS})"
            )
        if slack_headroom is not None and slack_headroom < 0:
            raise ValueError(f"slack_headroom must be >= 0, got {slack_headroom}")
        self.variant = variant
        self.build_method = "sharded" if mesh is not None else build_method
        self.mesh = mesh
        self.axis_name = axis_name
        self.with_csc = with_csc
        self.bin_range = bin_range
        self.executor = executor
        self.seed = seed
        self.warmup = warmup
        self.slack_headroom = slack_headroom
        self.slack_min_slack = slack_min_slack

    def _run_stage(self, stages, ex, name, modeled_bytes, fn):
        """Time one stage, capturing the executor decisions of its timed
        pass through an uncapped sink (``decide`` runs on every call, so
        the warm-up pass is left out)."""
        compile_s = 0.0
        if self.warmup:
            t0 = time.perf_counter()
            _wait(fn())
            compile_s = time.perf_counter() - t0
        sink: list = []
        ex.add_decision_sink(sink)
        t0 = time.perf_counter()
        try:
            out = _wait(fn())
        finally:
            ex.remove_decision_sink(sink)
        dt = time.perf_counter() - t0
        stages.append(
            StageReport(
                name=name, seconds=dt, modeled_bytes=modeled_bytes,
                decisions=tuple(sink), compile_seconds=compile_s,
            )
        )
        return out

    def run(self, coo: COO) -> PreprocessResult:
        ex = self.executor or get_default_executor()
        n, m = coo.num_nodes, coo.num_edges
        stages: list = []
        bm = "baseline" if self.build_method == "baseline" else "pb"

        def stage_bytes(stage):
            return traffic.preproc_stage_bytes(stage, m, n, build_method=bm)

        # 1. degrees: one reduce shared by the mapping and the CSR build
        ones = torch.ones(m, dtype=torch.int32, device=coo.src.device)
        if self.mesh is not None:
            degrees = self._run_stage(
                stages, ex, "degrees", stage_bytes("degrees"),
                lambda: ex.shard_reduce_stream(coo.src, ones, out_size=n, mesh=self.mesh,
                                               op="add", axis_name=self.axis_name),
            )
        else:
            degrees = self._run_stage(
                stages, ex, "degrees", stage_bytes("degrees"),
                lambda: ex.reduce_stream(coo.src, ones, out_size=n, op="add"),
            )

        # 2. mapping: the registered variant over the shared histogram
        new_ids = self._run_stage(
            stages, ex, "mapping", stage_bytes("mapping"),
            lambda: reorder_mapping(self.variant, coo.src, n, seed=self.seed, degrees=degrees),
        )

        # 3. relabel: endpoint rewrite (gathers, no PB stream)
        relabeled = self._run_stage(
            stages, ex, "relabel", stage_bytes("relabel"),
            lambda: relabel_coo(coo, new_ids),
        )

        # 4/5. the builds; the CSR reuses stage 1's histogram permuted
        # under the new ids, the CSC needs the dst histogram and counts it
        build_kw = dict(method=self.build_method, bin_range=self.bin_range, mesh=self.mesh,
                        axis_name=self.axis_name)
        deg_relabeled = torch.zeros_like(degrees)
        deg_relabeled[new_ids.long()] = degrees
        csr = self._run_stage(
            stages, ex, "build_csr", stage_bytes("build_csr"),
            lambda: npop.build_csr(relabeled, degrees=deg_relabeled, **build_kw),
        )
        csc = None
        if self.with_csc:
            csc = self._run_stage(
                stages, ex, "build_csc", stage_bytes("build_csc"),
                lambda: npop.build_csc(relabeled, **build_kw),
            )

        # 6. slack: the mutable re-slack, only when asked
        slack = None
        if self.slack_headroom is not None:
            slack = self._run_stage(
                stages, ex, "slack", stage_bytes("slack"),
                lambda: SlackCSR.from_csr(
                    csr, headroom=self.slack_headroom, min_slack=self.slack_min_slack
                ),
            )

        report = PreprocessReport(
            variant=self.variant,
            build_method=self.build_method,
            num_nodes=n,
            num_edges=m,
            sharded=self.mesh is not None,
            stages=tuple(stages),
        )
        return PreprocessResult(
            csr=csr, csc=csc, new_ids=new_ids, degrees=degrees, report=report, slack=slack,
        )

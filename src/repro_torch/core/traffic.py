"""Modeled sequential bytes of the preprocessing stages (the part of
``repro/core/traffic.py`` that ``core/preprocess.py`` reads).

These are byte counts of the reference's model, copied so that a
``PreprocessReport`` puts the same modeled traffic beside each stage's
measured time; no timing enters them. The rest of the reference's cost
model (access-time model, fused/PB costs, traversal, update and serving
counters) waits for ROADMAP.md Queue 1, "Cost models".
"""
from __future__ import annotations

from repro_torch.core.plan import TUPLE_BYTES


def pb_two_phase_stream_bytes(
    num_tuples: int,
    num_indices: int,
    tuple_bytes: int = TUPLE_BYTES,
    value_bytes_per_index: int = 4,
) -> float:
    """Classic PB: Binning reads the stream and writes the binned copy,
    Bin-Read re-reads the copy and writes the dense output once."""
    return 3.0 * num_tuples * tuple_bytes + num_indices * value_bytes_per_index


def degrees_stage_bytes(
    num_tuples: int, num_indices: int, index_bytes: int = 4,
    value_bytes_per_index: int = 4,
) -> float:
    """Fused degree count: read the src index stream once, write the
    dense degree array once (the ones-values stream never exists)."""
    return float(num_tuples) * index_bytes + float(num_indices) * value_bytes_per_index


def mapping_stage_bytes(num_indices: int, value_bytes_per_index: int = 4) -> float:
    """Reorder mapping: read the degrees, write the sorted order, write
    the inverted new-id table: three n-sized sweeps."""
    return 3.0 * num_indices * value_bytes_per_index


def relabel_stage_bytes(num_tuples: int, index_bytes: int = 4) -> float:
    """Relabel: read both endpoint arrays, write both relabeled arrays
    (the new-id gathers are charged as cache-resident)."""
    return 4.0 * num_tuples * index_bytes


def csr_build_stage_bytes(
    num_tuples: int, num_indices: int, build_method: str = "pb"
) -> float:
    """One EL->CSR (or EL->CSC) build: the baseline sort moves the tuple
    stream twice plus the offsets; PB/COBRA pay the two-phase stream."""
    if build_method == "baseline":
        return 2.0 * num_tuples * TUPLE_BYTES + num_indices * 4.0
    return pb_two_phase_stream_bytes(num_tuples, num_indices)


def slack_build_stage_bytes(
    num_tuples: int,
    num_indices: int,
    headroom: float = 0.25,
    slot_bytes: int = 4,
) -> float:
    """Re-slack a built CSR into the SlackCSR layout: read the compact
    neighbour array once, write the headroom-padded slab once, plus the
    offsets/counts sidecars."""
    slab = num_tuples * (1.0 + headroom) * slot_bytes
    sidecars = 2 * (num_indices + 1) * 4
    return num_tuples * slot_bytes + slab + sidecars


def preproc_stage_bytes(
    stage: str, num_tuples: int, num_indices: int, build_method: str = "pb"
) -> float:
    """Modeled sequential bytes of one named pipeline stage."""
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

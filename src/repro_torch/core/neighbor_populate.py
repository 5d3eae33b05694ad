"""Neighbor-Populate: Edgelist (COO) -> CSR (port of
``repro/core/neighbor_populate.py``).

  * ``build_csr_oracle``    — sequential numpy semantics (tests only).
  * ``build_csr_baseline``  — one stable sort over the full src key.
  * ``build_csr_pb``        — PB: coarse Binning at ``bin_range`` through the
                              executor, then a stable fine grouping.
  * ``build_csr_cobra``     — hierarchical (knob-free) COBRA execution.
  * ``build_csr_sharded``   — distributed over the ranks of a mesh
                              (``distributed_pb.shard_build_csr``).

Every build is stable, so the CSRs are identical to the reference's and
to each other. Degree counting is a commutative reduction and goes
through ``PBExecutor.reduce_stream``, which picks the fused kernel when
its accumulator fits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor import execute_binning, get_default_executor
from repro_torch.core.graph import COO, CSR, SlackCSR, offsets_from_degrees, transpose_coo
from repro_torch.core.plan import CobraPlan


def _degrees(src: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Out-degrees as a PB reduction (add of ones) the executor decides."""
    return get_default_executor().reduce_stream(
        src, torch.ones(src.shape, dtype=torch.int32, device=src.device),
        out_size=num_nodes, op="add",
    )


def build_csr_oracle(coo: COO) -> CSR:
    """Literal Algorithm 1 in numpy (sequential semantics). Test oracle;
    the CSR comes back on the COO's device."""
    src = coo.src.cpu().numpy()
    dst = coo.dst.cpu().numpy()
    n = coo.num_nodes
    degrees = np.bincount(src, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    cursor = offsets[:-1].copy()
    neighs = np.zeros(src.shape[0], dtype=np.int32)
    for s, d in zip(src, dst):
        neighs[cursor[s]] = d
        cursor[s] += 1
    dev = coo.src.device
    return CSR(torch.from_numpy(offsets).to(dev), torch.from_numpy(neighs).to(dev), n)


def build_csr_baseline(coo: COO) -> CSR:
    degrees = torch.bincount(coo.src, minlength=coo.num_nodes).to(torch.int32)
    perm = torch.argsort(coo.src, stable=True)  # full-key-range stable sort
    return CSR(offsets_from_degrees(degrees), coo.dst[perm], coo.num_nodes)


def _pb_build(src, dst, degrees, num_nodes, bin_range, method="sort", plan=None):
    offsets = offsets_from_degrees(degrees)
    num_bins = -(-num_nodes // bin_range)
    # Phase 1: Binning (coarse range), stable, through the executor core.
    bins = execute_binning(
        src, dst, bin_range=bin_range, num_bins=num_bins, method=method, plan=plan
    )
    # Phase 2: Bin-Read — a second stable partition by the exact src.
    perm = torch.argsort(bins.idx, stable=True)
    return offsets, bins.val[perm]


def build_csr_pb(
    coo: COO,
    bin_range: int | None = None,
    method: str = "sort",
    degrees: torch.Tensor | None = None,
) -> CSR:
    """PB EL->CSR. ``method`` is any executor method, or "auto"; a ``None``
    bin_range asks the executor for the planned range."""
    if method == "auto" or bin_range is None:
        d = get_default_executor().decide(
            coo.num_nodes, coo.num_edges, coo.src.dtype, bin_range=bin_range,
            device=coo.src.device,
        )
        method = d.method if method == "auto" else method
        bin_range = d.bin_range
    plan = None
    if method == "hierarchical":
        plan = CobraPlan.from_hardware(coo.num_nodes, final_bin_range=bin_range)
        bin_range = plan.final_bin_range
    if degrees is None:
        degrees = _degrees(coo.src, coo.num_nodes)
    offsets, neighs = _pb_build(
        coo.src, coo.dst, degrees, coo.num_nodes, bin_range, method=method, plan=plan
    )
    return CSR(offsets, neighs, coo.num_nodes)


def build_csr_cobra(
    coo: COO, plan: CobraPlan | None = None, degrees: torch.Tensor | None = None
) -> CSR:
    """Knob-free COBRA build: the hierarchical executor method."""
    plan = plan or CobraPlan.from_hardware(coo.num_nodes)
    if degrees is None:
        degrees = _degrees(coo.src, coo.num_nodes)
    offsets, neighs = _pb_build(
        coo.src, coo.dst, degrees, coo.num_nodes, plan.final_bin_range,
        method="hierarchical", plan=plan,
    )
    return CSR(offsets, neighs, coo.num_nodes)


def build_csr_sharded(coo: COO, mesh=None, axis_name: str | None = None,
                      capacity: int | None = None) -> CSR:
    """Distributed Neighbor-Populate: edges owner-routed by source vertex
    between the mesh's ranks, each rank grouping its owned range stably
    (``distributed_pb.shard_build_csr``). Equals ``build_csr_oracle``;
    without a mesh it is the executor-decided PB build."""
    from repro_torch.core.distributed_pb import shard_build_csr

    return shard_build_csr(coo, mesh, axis_name=axis_name, capacity=capacity)


BUILD_METHODS = ("baseline", "pb", "cobra", "sharded", "auto")


def build_csr(
    coo: COO,
    method: str = "auto",
    bin_range: int | None = None,
    degrees: torch.Tensor | None = None,
    mesh=None,
    axis_name: str | None = None,
) -> CSR:
    """EL->CSR through one named build variant. ``sharded`` distributes over
    ``mesh`` (the single-device auto build without one) and counts its own
    degrees; the PB builds reuse ``degrees`` when given."""
    if method in ("auto", "pb"):
        m = "auto" if method == "auto" else "sort"
        return build_csr_pb(coo, bin_range=bin_range, method=m, degrees=degrees)
    if method == "baseline":
        return build_csr_baseline(coo)
    if method == "cobra":
        plan = CobraPlan.from_hardware(coo.num_nodes, final_bin_range=bin_range)
        return build_csr_cobra(coo, plan, degrees=degrees)
    if method == "sharded":
        return build_csr_sharded(coo, mesh=mesh, axis_name=axis_name)
    raise ValueError(f"unknown build method: {method!r} (want one of {BUILD_METHODS})")


def build_slack_csr(
    coo: COO,
    headroom: float = 0.25,
    min_slack: int = 4,
    method: str = "auto",
    bin_range: int | None = None,
    degrees: torch.Tensor | None = None,
) -> SlackCSR:
    """EL->SlackCSR: ``build_csr``, then one re-slack with ``headroom``
    (at least ``min_slack``) spare slots per vertex."""
    csr = build_csr(coo, method=method, bin_range=bin_range, degrees=degrees)
    return SlackCSR.from_csr(csr, headroom=headroom, min_slack=min_slack)


def build_csc(coo: COO, method: str = "auto", bin_range: int | None = None, mesh=None,
              axis_name: str | None = None) -> CSR:
    """EL->CSC: the CSR of the transposed graph (in-neighbor lists)."""
    return build_csr(transpose_coo(coo), method=method, bin_range=bin_range, mesh=mesh,
                     axis_name=axis_name)


def build_csr_csc(coo: COO, method: str = "auto", bin_range: int | None = None, mesh=None,
                  axis_name: str | None = None):
    """Dual-layout build: ``(CSR, CSC)`` of one graph."""
    kw = dict(method=method, bin_range=bin_range, mesh=mesh, axis_name=axis_name)
    return build_csr(coo, **kw), build_csc(coo, **kw)


def csr_equal_as_sets(a: CSR, b: CSR) -> bool:
    """Same graph irrespective of in-neighborhood order."""
    ao, bo = a.offsets.cpu().numpy(), b.offsets.cpu().numpy()
    if not np.array_equal(ao, bo):
        return False
    an, bn = a.neighs.cpu().numpy(), b.neighs.cpu().numpy()
    if an.shape != bn.shape:
        return False
    seg = np.repeat(np.arange(a.num_nodes), np.diff(ao))
    return np.array_equal(an[np.lexsort((an, seg))], bn[np.lexsort((bn, seg))])

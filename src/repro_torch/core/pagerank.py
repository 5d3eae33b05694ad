"""PageRank (port of ``repro/core/pagerank.py``).

  * ``pagerank_coo_scatter``  — every iteration scatter-adds contributions
    in random destination order (fig5 arm A).
  * ``pagerank_csr_pull``     — pull over a CSC: gather + sorted segment sum
    (arm B).
  * ``pagerank_pb``           — PB push: edges binned by destination once
    through the executor, then each iteration scatters in bin order
    (arms C and D).
  * ``pagerank_fused``        — each iteration is one fused
    bin-and-accumulate through ``execute_reduce`` (arm E).

``fori_loop`` is a Python loop and ``segment_sum`` a sorted
``index_add_``. Float sums run in another order than the reference's (and,
with atomics on the card, in a different order each run), so ranks agree
to a tolerance, not bit for bit. ``pagerank_sharded`` is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.executor import execute_reduce, get_default_executor
from repro_torch.core.graph import COO, CSR, segment_ids_from_offsets


class PRResult(NamedTuple):
    ranks: torch.Tensor
    iters: int


DAMP = 0.85


def _outdeg(src: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(src, minlength=n).clamp(min=1).to(torch.float32)


def _initial(n: int, device) -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def _push(incoming: torch.Tensor, n: int) -> torch.Tensor:
    return (1.0 - DAMP) / n + DAMP * incoming


def pagerank_coo_scatter(coo: COO, iters: int = 10) -> PRResult:
    n = coo.num_nodes
    outdeg = _outdeg(coo.src, n)
    ranks = _initial(n, coo.src.device)
    for _ in range(iters):
        contrib = ranks / outdeg
        incoming = torch.zeros(n, dtype=torch.float32, device=ranks.device)
        incoming.index_add_(0, coo.dst, contrib[coo.src])
        ranks = _push(incoming, n)
    return PRResult(ranks, iters)


def pagerank_csr_pull(csc: CSR, outdeg: torch.Tensor, iters: int = 10) -> PRResult:
    """Pull over the transpose CSR (a CSC): for each v, sum the
    contributions of its in-neighbors, which are contiguous."""
    n = csc.num_nodes
    seg = segment_ids_from_offsets(csc.offsets, csc.num_edges)  # edge -> dst
    od = outdeg.clamp(min=1).to(torch.float32)
    ranks = _initial(n, csc.offsets.device)
    for _ in range(iters):
        contrib = ranks / od
        incoming = torch.zeros(n, dtype=torch.float32, device=ranks.device)
        incoming.index_add_(0, seg, contrib[csc.neighs])
        ranks = _push(incoming, n)
    return PRResult(ranks, iters)


def pb_bin_edges(coo: COO, bin_range: int, method: str | None = None):
    """Bin edges by destination range once through the executor;
    returns (src_binned, dst_binned)."""
    bins = get_default_executor().bin_stream(
        coo.dst, coo.src, num_indices=coo.num_nodes, bin_range=bin_range, method=method
    )
    return bins.val, bins.idx


def _pr_pb(src_b, dst_b, n, iters):
    outdeg = _outdeg(src_b, n)
    ranks = _initial(n, src_b.device)
    for _ in range(iters):
        contrib = ranks / outdeg
        incoming = torch.zeros(n, dtype=torch.float32, device=ranks.device)
        incoming.index_add_(0, dst_b, contrib[src_b])
        ranks = _push(incoming, n)
    return ranks


def pagerank_pb_prebinned(src_b, dst_b, num_nodes: int, iters: int = 10) -> PRResult:
    """Processing phase only (binning amortized)."""
    return PRResult(_pr_pb(src_b, dst_b, num_nodes, iters), iters)


def pagerank_pb(coo: COO, iters: int = 10, bin_range: int = 1 << 14) -> PRResult:
    src_b, dst_b = pb_bin_edges(coo, bin_range)
    return PRResult(_pr_pb(src_b, dst_b, coo.num_nodes, iters), iters)


def _pr_step(src, dst, ranks, outdeg, n, d):
    """One power-iteration step through the decided reduce method."""
    incoming = execute_reduce(
        dst, (ranks / outdeg)[src], out_size=n, op="add", method=d.method,
        bin_range=d.bin_range, num_bins=d.num_bins, plan=d.plan,
    )
    return _push(incoming, n)


def pagerank_fused(coo: COO, iters: int = 10, method: str | None = None) -> PRResult:
    """PageRank through the executor's fused reduction; ``method=None``
    asks ``decide`` (reduce candidates), any ``REDUCE_METHODS`` entry
    forces a path."""
    ex = get_default_executor()
    n = coo.num_nodes
    d = ex.decide_or_forced(
        method, n, coo.num_edges, torch.float32, kind="reduce", device=coo.src.device
    )
    outdeg = _outdeg(coo.src, n)
    ranks = _initial(n, coo.src.device)
    for _ in range(iters):
        ranks = _pr_step(coo.src, coo.dst, ranks, outdeg, n, d)
    return PRResult(ranks, iters)


def pagerank_incremental(
    coo: COO,
    ranks_prev: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    max_iters: int = 200,
    method: str | None = None,
) -> PRResult:
    """PageRank to tolerance by warm-started power iteration; ``iters`` in
    the result is the number of rounds run. ``ranks_prev=None`` is the
    cold start."""
    if tol <= 0:
        raise ValueError(f"tol must be > 0, got {tol}")
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    ex = get_default_executor()
    n = coo.num_nodes
    d = ex.decide_or_forced(
        method, n, coo.num_edges, torch.float32, kind="reduce", device=coo.src.device
    )
    outdeg = _outdeg(coo.src, n)
    ranks = (
        _initial(n, coo.src.device)
        if ranks_prev is None
        else ranks_prev.to(device=coo.src.device, dtype=torch.float32)
    )
    it = 0
    while it < max_iters:
        new = _pr_step(coo.src, coo.dst, ranks, outdeg, n, d)
        delta = float(torch.sum(torch.abs(new - ranks)))  # L1 movement
        ranks = new
        it += 1
        if delta < tol:
            break
    return PRResult(ranks, it)

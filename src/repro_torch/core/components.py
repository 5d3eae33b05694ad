"""Connected components by label propagation (port of
``repro/core/components.py``): the paper's third PB update class,
commutative and idempotent (``min``).

Every vertex starts with its own id as label; each iteration takes, at
both ends of every edge (the graph is treated as undirected), the smaller
label, until no label changes. The labels converge to the smallest vertex
id of each weakly connected component, and the iteration count is the
label diameter.

The reference's ``lax.while_loop`` becomes a host loop that synchronises
once per iteration (``bool(changed)``); its state and test are the
reference's (``labels != prev``, at most ``max_iters`` rounds), so
``iters`` equals the reference's. int32 ``min`` is exact in every method
and in both fused kernel designs, so labels are equal bit for bit.

``connected_components_sharded`` runs the rounds over the ranks of a
mesh: each owner-routes both edge directions' min labels
(``distributed_pb.pipelined_owner_reduce``) and gathers the owned label
slices back; labels and ``iters`` equal the single-device run's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.executor import execute_reduce, get_default_executor
from repro_torch.core.graph import COO

class CCResult(NamedTuple):
    labels: torch.Tensor
    iters: int


def _propagate(step, labels: torch.Tensor, max_iters: int):
    """The reference's while loop: run ``step`` until no label changes or
    ``max_iters`` rounds ran; one host sync per round."""
    prev = torch.full_like(labels, -1)
    it = 0
    while it < max_iters and bool((labels != prev).any()):
        prev, labels = labels, step(labels)
        it += 1
    return labels, it


def _cc(src: torch.Tensor, dst: torch.Tensor, num_nodes: int, max_iters: int):
    """Baseline rounds: min-scatter of the labels across every edge in
    stream order, dst side then src side, gathering the round's labels."""
    s, d = src.long(), dst.long()

    def step(labels):
        upd = labels.scatter_reduce(0, d, labels[s], reduce="amin")
        return upd.scatter_reduce(0, s, labels[d], reduce="amin")

    labels0 = torch.arange(num_nodes, dtype=torch.int32, device=src.device)
    return _propagate(step, labels0, max_iters)


def connected_components(coo: COO, max_iters: int = 512) -> CCResult:
    """Baseline: random-order min-scatter per iteration."""
    labels, it = _cc(coo.src, coo.dst, coo.num_nodes, max_iters)
    return CCResult(labels, it)


def _cc_fused(src, dst, labels0, num_nodes, max_iters, d):
    """Label propagation whose per-round min-scatter is one reduce of each
    edge direction through ``execute_reduce`` at the decision ``d`` (on
    the card, the fused kernel when ``d`` is fused). ``labels0`` seeds
    the rounds: ``arange`` from scratch, or the labels before an edge
    batch for the incremental warm start."""

    def reduce_min(key, val):
        return execute_reduce(
            key, val, out_size=num_nodes, op="min", method=d.method,
            bin_range=d.bin_range, num_bins=d.num_bins, plan=d.plan,
        )

    def step(labels):
        upd = torch.minimum(reduce_min(dst, labels[src]), reduce_min(src, labels[dst]))
        return torch.minimum(labels, upd)

    return _propagate(step, labels0, max_iters)


def _decide_min(coo: COO, method: Optional[str]):
    return get_default_executor().decide_or_forced(
        method, coo.num_nodes, coo.num_edges, torch.int32, kind="reduce", op="min",
        device=coo.src.device,
    )


def connected_components_fused(
    coo: COO, max_iters: int = 512, method: Optional[str] = None
) -> CCResult:
    """CC through the executor's reduce: each round's min labels in one
    sweep of the edge stream per direction. ``method=None`` consults
    ``decide`` (reduce set)."""
    d = _decide_min(coo, method)
    labels0 = torch.arange(coo.num_nodes, dtype=torch.int32, device=coo.src.device)
    labels, it = _cc_fused(coo.src, coo.dst, labels0, coo.num_nodes, max_iters, d)
    return CCResult(labels, it)


def connected_components_incremental(
    coo: COO,
    labels_prev: torch.Tensor,
    *,
    has_deletes: bool = False,
    max_iters: int = 512,
    method: Optional[str] = None,
):
    """Connected components after an edge batch, warm-started from the
    labels before it. Inserted edges only merge components, so the min of
    the old labels over a new component is its smallest vertex id and the
    rounds converge to the from-scratch labels in about the merge
    diameter. Deletions can split a component (a label would have to
    rise), so ``has_deletes=True`` runs ``connected_components_fused``
    from scratch. ``coo`` is the edge stream after the batch. Returns
    ``(CCResult, mode)``, ``mode`` "incremental" or "full"."""
    if has_deletes:
        return connected_components_fused(coo, max_iters=max_iters, method=method), "full"
    d = _decide_min(coo, method)
    labels0 = torch.as_tensor(labels_prev).to(device=coo.src.device, dtype=torch.int32)
    labels, it = _cc_fused(coo.src, coo.dst, labels0, coo.num_nodes, max_iters, d)
    return CCResult(labels, it), "incremental"


def connected_components_sharded(
    coo: COO,
    mesh=None,
    max_iters: int = 512,
    axis_name: Optional[str] = None,
    method: Optional[str] = None,
    capacity: Optional[int] = None,
    pipeline_chunks: Optional[int] = None,
) -> CCResult:
    """Label propagation with the mesh-sharded PB reduction. Rank ``r``
    holds the ``r``-th block of the edges; each round owner-routes the min
    labels of both edge directions between the ranks (each in
    ``pipeline_chunks`` double-buffered pieces), reduces them into the
    owned label slice, and ``all_gather`` gives every rank the whole
    vector. int32 min is exact and order-free, so labels and ``iters``
    equal the single-device run's at any K, and every rank sees the same
    labels, so all leave the loop together. ``mesh=None`` or one rank is
    ``connected_components_fused``. ``method=None`` asks ``decide`` at
    the per-rank shape under the topology key; ``capacity=None``
    estimates from the owner skew of both directions, and an overflow on
    any rank reruns the rounds once at the always-safe chunk length."""
    from repro_torch.core import distributed_pb as dpb

    n_dev = dpb.mesh_size(mesh, axis_name)
    if n_dev == 1:
        return connected_components_fused(coo, max_iters=max_iters, method=method)
    ex = get_default_executor()
    n, m = coo.num_nodes, coo.num_edges
    dev = coo.src.device
    r = dpb.shard_range_for(n, n_dev)
    m_local = -(-max(m, 1) // n_dev)
    cap_total = int(capacity) if capacity is not None else max(
        dpb.estimate_capacity(coo.dst, out_size=n, n_dev=n_dev),
        dpb.estimate_capacity(coo.src, out_size=n, n_dev=n_dev),
    )
    d = ex.decide_or_forced(
        method, r, n_dev * cap_total, torch.int32, kind="reduce", op="min", device=dev,
        mesh=mesh,
    )
    entry = ex._last_entry if method in (None, "auto") else None
    k = pipeline_chunks if pipeline_chunks is not None else d.pipeline_chunks
    k, chunk_len = dpb._chunk_layout(m_local, k)
    cap = max(1, min(chunk_len, -(-cap_total // k)))
    # padded edges carry the sentinel n at both ends: gathers are clamped
    # and the exchange drops them in either direction
    src_l = dpb._rank_block(coo.src, mesh.rank, m_local, n)
    dst_l = dpb._rank_block(coo.dst, mesh.rank, m_local, n)
    safe_src, safe_dst = src_l.clamp(max=n - 1).long(), dst_l.clamp(max=n - 1).long()

    def run(c):
        overflow = [torch.zeros((), dtype=torch.bool, device=dev)]

        def reduce_owned(key, val):
            owned, of = dpb.pipelined_owner_reduce(
                key, val, out_size=n, shard_range=r, mesh=mesh, capacity=c, chunks=k,
                op="min", method=d.method, bin_range=d.bin_range, plan=d.plan,
            )
            overflow[0] = overflow[0] | of
            return owned

        def step(labels):
            owned = torch.minimum(reduce_owned(dst_l, labels[safe_src]),
                                  reduce_owned(src_l, labels[safe_dst]))
            return torch.minimum(labels, dpb.all_gather_cat(owned, mesh)[:n])

        labels0 = torch.arange(n, dtype=torch.int32, device=dev)
        labels, it = _propagate(step, labels0, max_iters)
        return labels, it, overflow[0]

    labels, it, overflow = run(cap)
    if cap < chunk_len and bool(overflow):
        labels, it, _ = run(chunk_len)
        if entry is not None:
            entry.update(overflow=True, capacity=chunk_len, capacity_source="overflow-fallback")
    return CCResult(labels, it)


def connected_components_pb(
    coo: COO, bin_range: int = 1 << 14, max_iters: int = 512, method: Optional[str] = None
) -> CCResult:
    """PB execution: the edges binned by destination range once through
    the executor, then the baseline rounds over the binned stream (the
    min-scatter walks destinations bin by bin). min is idempotent, so
    duplicates within a bin need no correction."""
    bins = get_default_executor().bin_stream(
        coo.dst, coo.src, num_indices=coo.num_nodes, bin_range=bin_range, method=method
    )
    labels, it = _cc(bins.val, bins.idx, coo.num_nodes, max_iters)
    return CCResult(labels, it)

"""Frontier-driven traversal on the PB executor (port of
``repro/core/traversal.py``): level-synchronous BFS, SSSP relaxation
rounds, k-core peeling, their batched forms and personalized PageRank.

Each level gathers the CSR out-edges of the current frontier into one
stream (``_expand_frontier``, plain torch: the reference has no kernel
there) and reduces it through ``PBExecutor.reduce_stream`` (``min`` for
BFS levels and SSSP distances, ``max`` for the BFS parent, ``add`` for
k-core decrements). On the card the decided method runs its kernels: the
fused reduce for ``fused``, histogram and positions for ``pallas``.

The reference's padding is kept: the frontier and the edge stream are
padded to power-of-two buckets (``bucket_len``), padding slots carry an
in-range index and the op's identity, and the executor decides per level
at the bucketed length, so the per-level decisions (method, bucketed
``stream_len``, level) equal the reference's. The level loop runs on the
host and synchronises once per level, where the next frontier comes back
(``torch.nonzero``); the CSR offsets are copied to the host once per call.

Results equal the reference's exactly for BFS levels and parents, k-core
membership and SSSP distances (``dist[u] + w`` is one float32 add and
``min`` is exact); personalized PageRank sums float32 in another order
and agrees to a tolerance. ``method="unbinned"`` is fig8's baseline, one
dense scatter (``kernels/ref.py::scatter_reduce_ref``) with no executor.

``bfs_incremental`` re-relaxes BFS levels after an edge batch
(``core/updates.py``) from the batch's touched vertices. ``mesh=`` on
``bfs``, ``sssp``, ``k_core`` (and ``radii``) routes every level's reduce
through ``PBExecutor.shard_reduce_stream``: every rank expands the same
frontier, each reduces its block of the level's stream, and every rank
gets the whole result, so every rank takes the next level alike.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import PBExecutor, get_default_executor, lane_indices
from repro_torch.core.graph import CSR, segment_ids_from_offsets

_INT_MAX = int(np.iinfo(np.int32).max)
_INT_MIN = int(np.iinfo(np.int32).min)
_F32_MAX = float(np.finfo(np.float32).max)

# Methods the per-level reduction accepts: the executor's reduce set plus
# the unbinned dense-scatter baseline.
TRAVERSAL_METHODS = (
    "auto", "sort", "counting", "pallas", "hierarchical", "fused", "unbinned",
)

# The subset a batched traversal may force (``PBExecutor.reduce_streams``).
BATCHED_TRAVERSAL_METHODS = ("auto", "sort", "counting", "fused", "unbinned")


def bucket_len(n: int, minimum: int = 256) -> int:
    """Next power of two at least ``minimum``: the length a frontier of
    ``n`` tuples is padded to."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _expand_frontier(offsets, neighs, ids, count: int, bucket_edges: int):
    """Gather the out-edges of ``ids[:count]`` into arrays of length
    ``bucket_edges``: ``(nbr, src, pos, ok)`` = destination vertex, owning
    frontier vertex, the edge's slot in ``neighs`` (for weight gathers)
    and the validity mask. Invalid slots hold clamped in-range values;
    callers mask them with ``ok`` (values to the op identity), never by
    index."""
    counts = torch.full((1,), count, dtype=torch.int32, device=ids.device)
    return tuple(t[0] for t in _expand_frontiers(offsets, neighs, ids[None], counts,
                                                 bucket_edges))


def _expand_frontiers(offsets, neighs, ids, counts, bucket_edges: int):
    """``_expand_frontier`` for (B, nf) frontiers with (B,) counts, every
    lane at the same bucket: (B, bucket_edges) arrays (the reference's
    vmapped expansion). The reference's arithmetic, in int32."""
    dev = ids.device
    B, nf = ids.shape
    valid = torch.arange(nf, dtype=torch.int32, device=dev)[None, :] < counts[:, None]
    ids_c = torch.where(valid, ids, 0)
    ic = ids_c.long()
    deg = torch.where(valid, offsets[ic + 1] - offsets[ic], 0)
    cum = torch.cumsum(deg, 1, dtype=torch.int32)  # inclusive prefix per lane
    j = torch.arange(bucket_edges, dtype=torch.int32, device=dev).expand(B, bucket_edges)
    seg = torch.searchsorted(cum, j.contiguous(), right=True, out_int32=True).clamp(max=nf - 1)
    sl = seg.long()
    start = cum.gather(1, sl) - deg.gather(1, sl)  # exclusive prefix of the owning vertex
    v = ids_c.gather(1, sl)
    pos = (offsets[v.long()] + (j - start)).clamp(min=0, max=max(neighs.shape[0] - 1, 0))
    ok = j < cum[:, -1:]
    return neighs[pos.long()], v, pos, ok


class TraversalResult(NamedTuple):
    """One frontier traversal: distances/levels and how it ran."""

    dist: torch.Tensor  # (n,) levels (BFS, int32) or distances (SSSP, float32)
    parent: Optional[torch.Tensor]  # (n,) BFS tree parent (-1 = unreached)
    levels: int  # expansion rounds executed
    converged: bool  # frontier drained before max_iters
    frontier_sizes: Tuple[int, ...]  # vertices per level, level 0 first
    level_edges: Tuple[int, ...]  # real (unpadded) tuples expanded per level
    decisions: Tuple[dict, ...]  # executor decisions, annotated with "level"


class KCoreResult(NamedTuple):
    """k-core peeling: surviving vertices and the peel trajectory."""

    in_core: torch.Tensor  # (n,) bool
    rounds: int
    converged: bool
    removed_per_round: Tuple[int, ...]
    decisions: Tuple[dict, ...]


class _LevelReducer:
    """Routes one level's (idx, val) stream to the chosen reduction path
    and collects the executor's decisions, tagged with the level."""

    def __init__(self, ex: PBExecutor, method, mesh=None, axis_name: Optional[str] = None):
        self.ex = ex
        self.method = None if method in (None, "auto") else method
        self.mesh = mesh
        self.axis_name = axis_name
        self.decisions: list = []
        self._level = 0

    def set_level(self, level: int) -> None:
        self._level = level

    def _run(self, fn):
        sink: list = []
        self.ex.add_decision_sink(sink)
        try:
            out = fn()
        finally:
            self.ex.remove_decision_sink(sink)
        self.decisions.extend({**e, "level": self._level} for e in sink)
        return out

    def __call__(self, idx, val, *, out_size: int, op: str):
        if self.method == "unbinned":
            from repro_torch.kernels.ref import scatter_reduce_ref

            return scatter_reduce_ref(idx, val, out_size, op=op)
        if self.mesh is not None:
            return self._run(lambda: self.ex.shard_reduce_stream(
                idx, val, out_size=out_size, mesh=self.mesh, op=op,
                axis_name=self.axis_name, method=self.method))
        return self._run(lambda: self.ex.reduce_stream(
            idx, val, out_size=out_size, op=op, method=self.method))

    def batched(self, idx, val, *, out_size: int, op: str):
        """One level of many query lanes: (B, m) streams under a single
        decision (``PBExecutor.reduce_streams``)."""
        if self.method == "unbinned":  # one dense scatter over the flattened lanes
            from repro_torch.kernels.ref import scatter_reduce_ref

            B, m = idx.shape
            out = scatter_reduce_ref(lane_indices(idx, out_size), val.reshape(B * m),
                                     B * out_size, op=op)
            return out.reshape(B, out_size)
        return self._run(lambda: self.ex.reduce_streams(
            idx, val, out_size=out_size, op=op, method=self.method))


def _resolve(method: str) -> None:
    if method not in TRAVERSAL_METHODS:
        raise ValueError(f"unknown traversal method: {method!r} (want one of {TRAVERSAL_METHODS})")


def _resolve_batched(method: str) -> None:
    if method not in BATCHED_TRAVERSAL_METHODS:
        raise ValueError(
            f"unknown batched traversal method: {method!r} "
            f"(want one of {BATCHED_TRAVERSAL_METHODS})"
        )


def _frontier_of(mask: torch.Tensor) -> np.ndarray:
    """Sorted int32 vertex ids where ``mask`` holds, on the host."""
    return _lane_frontiers(mask[None])[0]


def _pad_frontier(frontier: np.ndarray, device) -> torch.Tensor:
    ids = np.zeros(bucket_len(frontier.size), np.int32)
    ids[: frontier.size] = frontier
    return torch.from_numpy(ids).to(device)


def _edges_of(offs_host: np.ndarray, frontier: np.ndarray) -> int:
    return int((offs_host[frontier + 1] - offs_host[frontier]).sum()) if frontier.size else 0


def bfs(
    csr: CSR,
    source: int,
    *,
    executor: Optional[PBExecutor] = None,
    method: str = "auto",
    mesh=None,
    axis_name: Optional[str] = None,
    max_iters: Optional[int] = None,
    with_parents: bool = True,
) -> TraversalResult:
    """Level-synchronous BFS: each level is one ``op="min"`` reduce of
    (neighbor, level + 1) tuples over the frontier's out-edges, and with
    ``with_parents`` one ``op="max"`` reduce of (neighbor, frontier
    vertex) tuples that picks the largest-id predecessor as the parent.
    ``dist[v]`` is the level (INT32_MAX when unreached)."""
    _resolve(method)
    ex = executor or get_default_executor()
    n = csr.num_nodes
    if not 0 <= source < n:
        raise ValueError(f"source {source} outside [0, {n})")
    max_iters = n if max_iters is None else max_iters
    dev = csr.offsets.device
    offs_host = csr.offsets.cpu().numpy()
    red = _LevelReducer(ex, method, mesh, axis_name)

    dist = torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev)
    dist[source] = 0
    parent = None
    if with_parents:
        parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
        parent[source] = source
    frontier = np.asarray([source], np.int32)
    sizes, edges, level = [1], [], 0
    while frontier.size and level < max_iters:
        red.set_level(level)
        total = _edges_of(offs_host, frontier)
        edges.append(total)
        if total == 0:
            # the round ran (levels counts it) but expanded nothing
            level += 1
            frontier = np.zeros(0, np.int32)
            sizes.append(0)
            break
        nbr, srcv, _, ok = _expand_frontier(
            csr.offsets, csr.neighs, _pad_frontier(frontier, dev), frontier.size,
            bucket_len(total),
        )
        val = torch.where(ok, level + 1, _INT_MAX).to(torch.int32)
        cand = red(nbr, val, out_size=n, op="min")
        newly = cand < dist
        if with_parents:
            pval = torch.where(ok, srcv, _INT_MIN).to(torch.int32)
            pmax = red(nbr, pval, out_size=n, op="max")
            parent = torch.where(newly, pmax, parent)
        dist = torch.where(newly, cand, dist)
        frontier = _frontier_of(newly)
        sizes.append(int(frontier.size))
        level += 1
    return TraversalResult(
        dist=dist, parent=parent, levels=level, converged=frontier.size == 0,
        frontier_sizes=tuple(sizes), level_edges=tuple(edges), decisions=tuple(red.decisions),
    )


def _check_weights(csr: CSR, weights: torch.Tensor) -> None:
    if weights.shape[0] != csr.num_edges:
        raise ValueError(
            f"weights must align with csr.neighs: {weights.shape[0]} != {csr.num_edges}"
        )


def sssp(
    csr: CSR,
    weights: torch.Tensor,
    source: int,
    *,
    executor: Optional[PBExecutor] = None,
    method: str = "auto",
    mesh=None,
    axis_name: Optional[str] = None,
    max_iters: Optional[int] = None,
) -> TraversalResult:
    """Frontier-driven SSSP rounds: each round relaxes the out-edges of
    every vertex whose distance improved in the last one, as one
    ``op="min"`` reduce of (neighbor, dist[u] + w(u, v)) tuples; with
    non-negative weights at most n rounds. ``weights`` is aligned with
    ``csr.neighs``; ``dist`` is float32 with float32 max at unreached
    vertices (the min identity)."""
    _resolve(method)
    ex = executor or get_default_executor()
    n = csr.num_nodes
    if not 0 <= source < n:
        raise ValueError(f"source {source} outside [0, {n})")
    _check_weights(csr, weights)
    w = weights.to(torch.float32)
    max_iters = n if max_iters is None else max_iters
    dev = csr.offsets.device
    offs_host = csr.offsets.cpu().numpy()
    red = _LevelReducer(ex, method, mesh, axis_name)

    dist = torch.full((n,), _F32_MAX, dtype=torch.float32, device=dev)
    dist[source] = 0.0
    frontier = np.asarray([source], np.int32)
    sizes, edges, rounds = [1], [], 0
    while frontier.size and rounds < max_iters:
        red.set_level(rounds)
        total = _edges_of(offs_host, frontier)
        edges.append(total)
        if total == 0:  # the bfs zero-edge exit
            rounds += 1
            frontier = np.zeros(0, np.int32)
            sizes.append(0)
            break
        nbr, srcv, pos, ok = _expand_frontier(
            csr.offsets, csr.neighs, _pad_frontier(frontier, dev), frontier.size,
            bucket_len(total),
        )
        val = torch.where(ok, dist[srcv.long()] + w[pos.long()], _F32_MAX)
        cand = red(nbr, val, out_size=n, op="min")
        improved = cand < dist
        dist = torch.where(improved, cand, dist)
        frontier = _frontier_of(improved)
        sizes.append(int(frontier.size))
        rounds += 1
    return TraversalResult(
        dist=dist, parent=None, levels=rounds, converged=frontier.size == 0,
        frontier_sizes=tuple(sizes), level_edges=tuple(edges), decisions=tuple(red.decisions),
    )


def k_core(
    csr: CSR,
    k: int,
    *,
    executor: Optional[PBExecutor] = None,
    method: str = "auto",
    mesh=None,
    axis_name: Optional[str] = None,
    max_iters: Optional[int] = None,
) -> KCoreResult:
    """k-core peeling: remove vertices of out-degree < k round by round;
    each round streams the removed vertices' out-edges through one
    ``op="add"`` reduce of (neighbor, 1) tuples, the degree decrement.
    On a symmetrized graph this is the textbook k-core."""
    _resolve(method)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    ex = executor or get_default_executor()
    n = csr.num_nodes
    max_iters = n if max_iters is None else max_iters
    dev = csr.offsets.device
    offs_host = csr.offsets.cpu().numpy()
    red = _LevelReducer(ex, method, mesh, axis_name)

    deg = (csr.offsets[1:] - csr.offsets[:-1]).to(torch.int32)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    frontier = _frontier_of(deg < k)
    removed = [int(frontier.size)] if frontier.size else []
    rounds = 0
    while frontier.size and rounds < max_iters:
        red.set_level(rounds)
        alive[torch.from_numpy(frontier).to(dev).long()] = False
        total = _edges_of(offs_host, frontier)
        if total:
            nbr, _, _, ok = _expand_frontier(
                csr.offsets, csr.neighs, _pad_frontier(frontier, dev), frontier.size,
                bucket_len(total),
            )
            deg = deg - red(nbr, ok.to(torch.int32), out_size=n, op="add")
        frontier = _frontier_of(alive & (deg < k))
        if frontier.size:
            removed.append(int(frontier.size))
        rounds += 1
    return KCoreResult(
        in_core=alive, rounds=rounds, converged=frontier.size == 0,
        removed_per_round=tuple(removed), decisions=tuple(red.decisions),
    )


def bfs_incremental(
    csr: CSR,
    source: int,
    dist_prev: torch.Tensor,
    touched,
    *,
    has_deletes: bool = False,
    executor: Optional[PBExecutor] = None,
    method: str = "auto",
    max_iters: Optional[int] = None,
) -> Tuple[TraversalResult, str]:
    """BFS after an edge batch, re-relaxing only from the batch-touched
    vertices. Inserts can only shorten BFS distances, so the pre-batch
    ``dist_prev`` is an upper bound: seed the frontier with the reached
    touched vertices and run the per-level ``op="min"`` relaxation of
    ``dist[u] + 1`` (frontier vertices sit at different levels after a
    batch) until it drains. Deletions can lengthen distances, so
    ``has_deletes=True`` runs a from-scratch ``bfs`` without parents.

    ``csr`` is the post-batch graph; ``touched`` the batch's endpoints
    (``updates.touched_vertices``). Returns ``(result, mode)``, ``mode``
    "incremental" or "full"; the incremental result has ``parent=None``
    and counts only the re-relaxation rounds."""
    _resolve(method)
    ex = executor or get_default_executor()
    n = csr.num_nodes
    if not 0 <= source < n:
        raise ValueError(f"source {source} outside [0, {n})")
    if has_deletes:
        return (
            bfs(csr, source, executor=ex, method=method, max_iters=max_iters,
                with_parents=False),
            "full",
        )
    max_iters = n if max_iters is None else max_iters
    dev = csr.offsets.device
    offs_host = csr.offsets.cpu().numpy()
    red = _LevelReducer(ex, method)

    dist = torch.as_tensor(dist_prev).to(device=dev, dtype=torch.int32)
    touched_np = np.unique(np.asarray(touched, np.int32))
    # only reached endpoints can propagate a shorter level
    reached = (dist[torch.from_numpy(touched_np).to(dev).long()] < _INT_MAX).cpu().numpy()
    frontier = touched_np[reached]
    sizes, edges, rounds = [int(frontier.size)], [], 0
    while frontier.size and rounds < max_iters:
        red.set_level(rounds)
        total = _edges_of(offs_host, frontier)
        edges.append(total)
        if total == 0:  # the bfs zero-edge exit
            rounds += 1
            frontier = np.zeros(0, np.int32)
            sizes.append(0)
            break
        nbr, srcv, _, ok = _expand_frontier(
            csr.offsets, csr.neighs, _pad_frontier(frontier, dev), frontier.size,
            bucket_len(total),
        )
        # padding slots read dist[0], which may be INT32_MAX: the add wraps
        # there, as in the reference, and ``ok`` masks it
        val = torch.where(ok, dist[srcv.long()] + 1, _INT_MAX).to(torch.int32)
        cand = red(nbr, val, out_size=n, op="min")
        improved = cand < dist
        dist = torch.where(improved, cand, dist)
        frontier = _frontier_of(improved)
        sizes.append(int(frontier.size))
        rounds += 1
    return (
        TraversalResult(
            dist=dist, parent=None, levels=rounds, converged=frontier.size == 0,
            frontier_sizes=tuple(sizes), level_edges=tuple(edges),
            decisions=tuple(red.decisions),
        ),
        "incremental",
    )


# ---------------------------------------------------------------------------
# Micro-batched traversal: many source queries per reduce call.
# ---------------------------------------------------------------------------


def _sources_of(sources, n: int, what: str) -> np.ndarray:
    srcs = np.atleast_1d(np.asarray(sources, np.int32))
    if srcs.size == 0:
        raise ValueError(f"{what} needs at least one source")
    if not ((srcs >= 0) & (srcs < n)).all():
        raise ValueError(f"sources outside [0, {n}): {srcs}")
    return srcs


def _expand_lanes(csr: CSR, fronts: List[np.ndarray], per_q: List[int]):
    """Every lane's out-edges at one common bucket (the reference's
    ``_pad_frontiers`` + vmapped expansion): (B, bucket) arrays."""
    dev = csr.offsets.device
    ids = np.zeros((len(fronts), bucket_len(max(f.size for f in fronts))), np.int32)
    for q, f in enumerate(fronts):
        ids[q, : f.size] = f
    counts = np.asarray([f.size for f in fronts], np.int32)
    return _expand_frontiers(csr.offsets, csr.neighs, torch.from_numpy(ids).to(dev),
                             torch.from_numpy(counts).to(dev), bucket_len(max(per_q)))


def _lane_frontiers(mask: torch.Tensor) -> List[np.ndarray]:
    """Each lane's sorted int32 vertex ids where the (B, n) ``mask``
    holds: one ``nonzero`` and one copy to the host for the batch."""
    nz = torch.nonzero(mask).cpu().numpy()
    cuts = np.searchsorted(nz[:, 0], np.arange(1, mask.shape[0]))
    return [a.astype(np.int32) for a in np.split(nz[:, 1], cuts)]


def bfs_batched(
    csr: CSR,
    sources,
    *,
    executor: Optional[PBExecutor] = None,
    method: str = "auto",
    max_iters: Optional[int] = None,
    with_parents: bool = False,
) -> TraversalResult:
    """BFS from many sources at once: each level is one batched reduce of
    (B, bucket) per-query streams (``PBExecutor.reduce_streams``: one
    decision for the batch). Lane q equals ``bfs(csr, sources[q])``: the
    integer ``min``/``max`` are order-free, and a drained lane streams
    only identities. ``dist`` (and ``parent``) carry a leading batch axis;
    ``frontier_sizes``/``level_edges`` sum over the batch."""
    _resolve_batched(method)
    ex = executor or get_default_executor()
    n = csr.num_nodes
    srcs = _sources_of(sources, n, "bfs_batched")
    B = srcs.size
    max_iters = n if max_iters is None else max_iters
    dev = csr.offsets.device
    offs_host = csr.offsets.cpu().numpy()
    red = _LevelReducer(ex, method)

    lanes = torch.arange(B, device=dev)
    src_t = torch.from_numpy(srcs).to(dev)
    dist = torch.full((B, n), _INT_MAX, dtype=torch.int32, device=dev)
    dist[lanes, src_t.long()] = 0
    parent = None
    if with_parents:
        parent = torch.full((B, n), -1, dtype=torch.int32, device=dev)
        parent[lanes, src_t.long()] = src_t
    fronts = [np.asarray([s], np.int32) for s in srcs]
    sizes, edges, level = [B], [], 0
    while any(f.size for f in fronts) and level < max_iters:
        red.set_level(level)
        per_q = [_edges_of(offs_host, f) for f in fronts]
        total = sum(per_q)
        edges.append(total)
        if total == 0:  # no lane expands
            level += 1
            fronts = [np.zeros(0, np.int32) for _ in fronts]
            sizes.append(0)
            break
        nbr, srcv, _, ok = _expand_lanes(csr, fronts, per_q)
        val = torch.where(ok, level + 1, _INT_MAX).to(torch.int32)
        cand = red.batched(nbr, val, out_size=n, op="min")
        newly = cand < dist
        if with_parents:
            pval = torch.where(ok, srcv, _INT_MIN).to(torch.int32)
            pmax = red.batched(nbr, pval, out_size=n, op="max")
            parent = torch.where(newly, pmax, parent)
        dist = torch.where(newly, cand, dist)
        fronts = _lane_frontiers(newly)
        sizes.append(int(sum(f.size for f in fronts)))
        level += 1
    return TraversalResult(
        dist=dist, parent=parent, levels=level, converged=not any(f.size for f in fronts),
        frontier_sizes=tuple(sizes), level_edges=tuple(edges), decisions=tuple(red.decisions),
    )


def sssp_batched(
    csr: CSR,
    weights: torch.Tensor,
    sources,
    *,
    executor: Optional[PBExecutor] = None,
    method: str = "auto",
    max_iters: Optional[int] = None,
) -> TraversalResult:
    """SSSP from many sources: the batched form of ``sssp``. float32
    ``min`` is order-free, so lane q equals ``sssp(csr, weights,
    sources[q])`` bit for bit under the same reduce method."""
    _resolve_batched(method)
    ex = executor or get_default_executor()
    n = csr.num_nodes
    _check_weights(csr, weights)
    srcs = _sources_of(sources, n, "sssp_batched")
    B = srcs.size
    w = weights.to(torch.float32)
    max_iters = n if max_iters is None else max_iters
    dev = csr.offsets.device
    offs_host = csr.offsets.cpu().numpy()
    red = _LevelReducer(ex, method)

    dist = torch.full((B, n), _F32_MAX, dtype=torch.float32, device=dev)
    dist[torch.arange(B, device=dev), torch.from_numpy(srcs).to(dev).long()] = 0.0
    fronts = [np.asarray([s], np.int32) for s in srcs]
    sizes, edges, rounds = [B], [], 0
    while any(f.size for f in fronts) and rounds < max_iters:
        red.set_level(rounds)
        per_q = [_edges_of(offs_host, f) for f in fronts]
        total = sum(per_q)
        edges.append(total)
        if total == 0:
            rounds += 1
            fronts = [np.zeros(0, np.int32) for _ in fronts]
            sizes.append(0)
            break
        nbr, srcv, pos, ok = _expand_lanes(csr, fronts, per_q)
        relax = torch.gather(dist, 1, srcv.long()) + w[pos.long()]
        val = torch.where(ok, relax, _F32_MAX)
        cand = red.batched(nbr, val, out_size=n, op="min")
        improved = cand < dist
        dist = torch.where(improved, cand, dist)
        fronts = _lane_frontiers(improved)
        sizes.append(int(sum(f.size for f in fronts)))
        rounds += 1
    return TraversalResult(
        dist=dist, parent=None, levels=rounds, converged=not any(f.size for f in fronts),
        frontier_sizes=tuple(sizes), level_edges=tuple(edges), decisions=tuple(red.decisions),
    )


# ---------------------------------------------------------------------------
# Personalized PageRank: restart mass as an op=add reduce stream.
# ---------------------------------------------------------------------------


class PPRResult(NamedTuple):
    """Personalized PageRank: ranks and how the reductions ran."""

    ranks: torch.Tensor  # (n,) single query / (B, n) batched
    iters: int
    decisions: Tuple[dict, ...]  # executor decisions, tagged with "level"


_PPR_METHODS = ("auto", "sort", "counting", "fused", "unbinned")


def personalized_pagerank(
    csr: CSR,
    sources=None,
    *,
    iters: int = 20,
    damp: float = 0.85,
    executor: Optional[PBExecutor] = None,
    method: str = "auto",
) -> PPRResult:
    """Personalized PageRank by power iteration over the CSR edge stream,

        ranks <- (1 - damp) * e_source + damp * A^T (ranks / outdeg),

    each iteration one ``op="add"`` reduce of (neighbor, contribution)
    tuples whose values are an (m, B) block: one column per query, so the
    index stream and the decision serve the whole batch (on the card the
    row-block kernel when the decision is fused). ``sources=None`` is the
    uniform restart, a scalar one query, an array B queries ((B, n)
    ranks). Dangling vertices drop their mass (out-degree clamped to 1),
    as every PageRank of the repo does."""
    _resolve(method)
    if method not in _PPR_METHODS:
        raise ValueError(f"personalized_pagerank supports methods {_PPR_METHODS}, got {method!r}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    ex = executor or get_default_executor()
    n, m = csr.num_nodes, csr.num_edges
    dev = csr.offsets.device
    src = segment_ids_from_offsets(csr.offsets, m).long()
    dst = csr.neighs
    outdeg = (csr.offsets[1:] - csr.offsets[:-1]).clamp(min=1).to(torch.float32)

    single = sources is None or np.ndim(sources) == 0
    if sources is None:
        restart = torch.full((n, 1), 1.0 / n, dtype=torch.float32, device=dev)
    else:
        srcs = _sources_of(sources, n, "personalized_pagerank")
        restart = torch.zeros((n, srcs.size), dtype=torch.float32, device=dev)
        restart[torch.from_numpy(srcs).to(dev).long(), torch.arange(srcs.size, device=dev)] = 1.0
    red = _LevelReducer(ex, method)
    ranks = restart
    for it in range(iters):
        red.set_level(it)
        contrib = ranks / outdeg[:, None]
        incoming = red(dst, contrib.index_select(0, src), out_size=n, op="add")
        ranks = (1.0 - damp) * restart + damp * incoming
    out = ranks[:, 0] if single else ranks.T
    return PPRResult(ranks=out, iters=iters, decisions=tuple(red.decisions))


# ---------------------------------------------------------------------------
# Oracles (numpy; tests and chip_smoke.py).
# ---------------------------------------------------------------------------


def personalized_pagerank_oracle(
    csr: CSR, source=None, iters: int = 20, damp: float = 0.85
) -> np.ndarray:
    """float64 power iteration with ``personalized_pagerank``'s semantics
    (clamped out-degree, dropped dangling mass)."""
    off, nei = csr.offsets.cpu().numpy(), csr.neighs.cpu().numpy()
    n = csr.num_nodes
    src = np.repeat(np.arange(n), np.diff(off))
    outdeg = np.maximum(np.diff(off), 1).astype(np.float64)
    if source is None:
        restart = np.full(n, 1.0 / n)
    else:
        restart = np.zeros(n)
        restart[int(source)] = 1.0
    ranks = restart.copy()
    for _ in range(iters):
        contrib = ranks / outdeg
        incoming = np.zeros(n)
        np.add.at(incoming, nei, contrib[src])
        ranks = (1.0 - damp) * restart + damp * incoming
    return ranks


def k_core_oracle(csr: CSR, k: int) -> np.ndarray:
    """Sequential peeling with ``k_core``'s semantics; the in-core mask.
    The decrements of a round are one ``np.add.at`` over the removed
    vertices' out-edges (the reference's per-edge loop, vectorised)."""
    off, nei = csr.offsets.cpu().numpy(), csr.neighs.cpu().numpy()
    n = csr.num_nodes
    deg = np.diff(off).astype(np.int64)
    alive = np.ones(n, bool)
    frontier = np.flatnonzero(deg < k)
    while frontier.size:
        alive[frontier] = False
        starts, ends = off[frontier], off[frontier + 1]
        span = ends - starts
        slots = np.repeat(ends - np.cumsum(span), span) + np.arange(int(span.sum()))
        np.add.at(deg, nei[slots], -1)
        frontier = np.flatnonzero(alive & (deg < k))
    return alive

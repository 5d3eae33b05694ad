"""Streaming graph mutation as a PB workload (port of ``repro/core/updates.py``).

A batch of edge insertions and deletions is another (idx, val) stream,
and applying it to a ``SlackCSR`` is a binned delta merge:

  delta reduce — the per-vertex degree delta (+1 insert / -1 delete) and
      the insert counts are one ``add`` reduce each through
      ``PBExecutor.reduce_stream(kind="update")`` (on the card, the fused
      kernel when the executor decides it);
  slot placement — an insert lands at ``offsets[v] + counts[v] + rank``,
      ``rank`` its stable rank among the batch's inserts at v: the
      counting permutation (``pb.counting_permutation``, one bin per
      vertex) up to ``_COUNTING_PLACEMENT_MAX_BINS`` vertices, a stable
      argsort above, as in the reference;
  deletions — each delete tombstones one live matching slot (multiset
      semantics); a delete with no live match is counted, not an error;
  regrow — a slab that would overflow gets capacity need + headroom, one
      gather into the new layout;
  rebuild — when free slack falls below ``rebuild_slack_frac`` the graph
      is compacted and re-slacked through ``PreprocessPipeline``
      (variant="identity": vertex ids stay).

The reference copies the whole slab to the host for every batch; here
every step runs where the slab is (stable ``torch.sort``/``argsort`` on
int64 keys, ``searchsorted``, ``repeat_interleave``), and placement,
tombstones and counts equal the reference's bit for bit. Seeded batches
keep numpy's ``default_rng``, so both packages draw the same edges.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pb
from repro_torch.core.executor import PBExecutor, get_default_executor
from repro_torch.core.graph import COO, TOMBSTONE, SlackCSR
from repro_torch.device import resolve_device

# Vertex-domain ceiling for the counting-permutation placement (the
# reference's; above it the stable-sort realization of the same
# permutation is used).
_COUNTING_PLACEMENT_MAX_BINS = 4096


class EdgeBatch(NamedTuple):
    """One mutation batch: parallel endpoint tensors and an insert mask
    (True = insert (src, dst), False = delete one live (src, dst))."""

    src: torch.Tensor  # (b,) int32
    dst: torch.Tensor  # (b,) int32
    insert: torch.Tensor  # (b,) bool

    @property
    def num_updates(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_inserts(self) -> int:
        return int(self.insert.sum())

    @property
    def num_deletes(self) -> int:
        return self.num_updates - self.num_inserts


class UpdateResult(NamedTuple):
    """One applied batch: the new layout and how the merge ran."""

    graph: SlackCSR
    rebuilt: bool  # slack exhaustion routed through PreprocessPipeline
    regrown: int  # vertices whose slab was regrown
    inserted: int
    deleted: int  # deletes that tombstoned a live slot
    missed_deletes: int  # deletes with no live matching edge (no-ops)
    slack_fraction: float  # free slots / capacity after the batch
    decisions: Tuple[dict, ...]  # executor decisions (kind="update" + rebuild)
    report: Optional[object]  # PreprocessReport when rebuilt, else None


def _tensor(a, dtype, device) -> torch.Tensor:
    """``a`` (an array, a list or a tensor) as a ``dtype`` tensor on ``device``."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def make_batch(src, dst, insert, device=None) -> EdgeBatch:
    """An ``EdgeBatch`` on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    return EdgeBatch(
        src=_tensor(src, torch.int32, dev),
        dst=_tensor(dst, torch.int32, dev),
        insert=_tensor(insert, torch.bool, dev),
    )


def random_edge_batch(
    coo: COO, num_inserts: int, num_deletes: int, *, seed: int = 0
) -> EdgeBatch:
    """Seeded batch on the COO's device: uniform-random insert endpoints
    plus deletes sampled without replacement from the Edgelist (so every
    delete matches a live edge); the reference's numpy draws."""
    rng = np.random.default_rng(seed)
    n, m = coo.num_nodes, coo.num_edges
    num_deletes = min(num_deletes, m)
    ins_src = rng.integers(0, n, num_inserts, dtype=np.int32)
    ins_dst = rng.integers(0, n, num_inserts, dtype=np.int32)
    pick = torch.from_numpy(rng.choice(m, size=num_deletes, replace=False)).to(coo.src.device)
    src = np.concatenate([ins_src, coo.src[pick].cpu().numpy()])
    dst = np.concatenate([ins_dst, coo.dst[pick].cpu().numpy()])
    insert = np.concatenate([np.ones(num_inserts, bool), np.zeros(num_deletes, bool)])
    perm = rng.permutation(src.shape[0])  # interleave inserts and deletes
    return make_batch(src[perm], dst[perm], insert[perm], device=coo.src.device)


def _multiset_hits(keys_sorted: torch.Tensor, del_keys: torch.Tensor):
    """For sorted delete keys, the position in ``keys_sorted`` of the
    occurrence each delete removes (the k-th equal delete takes the k-th
    equal key) and whether it exists."""
    dk = torch.sort(del_keys).values
    drank = torch.arange(dk.numel(), device=dk.device) - torch.searchsorted(dk, dk)
    lo = torch.searchsorted(keys_sorted, dk)
    hi = torch.searchsorted(keys_sorted, dk, right=True)
    at = lo + drank
    return at, at < hi


def merge_batch_coo(coo: COO, batch: EdgeBatch) -> COO:
    """The from-scratch oracle's input: ``coo (+) batch`` as a multiset —
    inserts appended, each delete removing one matching occurrence (a
    delete with no match is a no-op); on the COO's device."""
    n = coo.num_nodes
    dev = coo.src.device
    src, dst = coo.src.long(), coo.dst.long()
    ins = batch.insert.to(dev)
    bs, bd = batch.src.to(dev).long(), batch.dst.to(dev).long()
    key = src * n + dst
    order = torch.argsort(key, stable=True)
    at, hit = _multiset_hits(key[order], bs[~ins] * n + bd[~ins])
    keep = torch.ones(src.numel(), dtype=torch.bool, device=dev)
    keep[order[at[hit]]] = False
    return COO(
        src=torch.cat([src[keep], bs[ins]]).to(torch.int32),
        dst=torch.cat([dst[keep], bd[ins]]).to(torch.int32),
        num_nodes=n,
    )


def touched_vertices(batch: EdgeBatch) -> Tuple[np.ndarray, bool]:
    """(sorted unique endpoint ids on the host, batch-has-deletes): the
    seed set the incremental kernels re-relax from, and the flag that
    decides incremental against recompute."""
    ids = torch.unique(torch.cat([batch.src, batch.dst])).cpu().numpy().astype(np.int32)
    return ids, bool((~batch.insert).any())


def _insert_ranks(ins_src: torch.Tensor, n: int, method: Optional[str]) -> torch.Tensor:
    """Stable rank of each insert among the batch's inserts at the same
    vertex: the counting permutation (one bin per vertex) when n allows
    it and the method is auto or counting, else the stable argsort
    realization of the same permutation."""
    b = ins_src.shape[0]
    dev = ins_src.device
    if b == 0:
        return torch.zeros(0, dtype=torch.long, device=dev)
    use_counting = method == "counting" or (
        method in (None, "auto") and n <= _COUNTING_PLACEMENT_MAX_BINS
    )
    if use_counting and n <= _COUNTING_PLACEMENT_MAX_BINS:
        dest, counts = pb.counting_permutation(ins_src.to(torch.int32), n)
        starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                            torch.cumsum(counts.long(), 0)])
        return dest.long() - starts[ins_src.long()]
    order = torch.argsort(ins_src, stable=True)
    sorted_src = ins_src[order].contiguous()
    group_start = torch.searchsorted(sorted_src, sorted_src)
    rank = torch.empty(b, dtype=torch.long, device=dev)
    rank[order] = torch.arange(b, device=dev) - group_start
    return rank


def _slab_slots(off: torch.Tensor, n: int):
    """(slot -> vertex, slot's rank in its slab) of a layout with int64
    offsets ``off``."""
    cap = int(off[-1])
    seg = torch.repeat_interleave(torch.arange(n, device=off.device), off[1:] - off[:-1],
                                  output_size=cap)
    return seg, torch.arange(cap, device=off.device) - off[seg]


def _tombstone_deletes(off, nei, cnt, n, del_src, del_dst) -> Tuple[int, int]:
    """Tombstone one occupied live slot per delete tuple: the k-th equal
    delete takes the k-th live matching slot in slot order. Only the
    slabs of delete sources are searched (the reference searches every
    slab; the chosen slots are the same). Mutates ``nei``; returns
    (hits, misses)."""
    if del_src.numel() == 0:
        return 0, 0
    seg, r = _slab_slots(off, n)
    mine = torch.zeros(n, dtype=torch.bool, device=off.device)
    mine[del_src.long()] = True
    live = mine[seg] & (r < cnt[seg]) & (nei != TOMBSTONE)
    slots = torch.nonzero(live).flatten()
    skey = seg[slots] * n + nei[slots].long()
    sorder = torch.argsort(skey, stable=True)
    at, hit = _multiset_hits(skey[sorder].contiguous(), del_src.long() * n + del_dst.long())
    nei[slots[sorder][at[hit]]] = TOMBSTONE
    hits = int(hit.sum())
    return hits, int(hit.numel()) - hits


def _regrow(off, nei, cnt, n, need, headroom: float, min_slack: int):
    """Slabs that would overflow get capacity need + max(min_slack,
    ceil(need * headroom)); every slab's occupied prefix moves by one
    gather into the new layout. Returns (new offsets, new neighs)."""
    cap = off[1:] - off[:-1]
    grow = need > cap
    extra = torch.ceil(need.double() * headroom).long().clamp(min=min_slack)
    new_cap = torch.where(grow, need + extra, cap)
    new_off = torch.cat([torch.zeros(1, dtype=torch.long, device=off.device),
                         torch.cumsum(new_cap, 0)])
    new_nei = torch.full((int(new_off[-1]),), TOMBSTONE, dtype=nei.dtype, device=nei.device)
    seg, r = _slab_slots(new_off, n)
    occ = r < cnt[seg]
    new_nei[occ] = nei[(off[seg] + r)[occ]]
    return new_off, new_nei


def apply_edge_batch(
    g: SlackCSR,
    batch: EdgeBatch,
    *,
    executor: Optional[PBExecutor] = None,
    method: Optional[str] = None,
    headroom: float = 0.25,
    min_slack: int = 4,
    rebuild_slack_frac: float = 0.05,
    allow_rebuild: bool = True,
) -> UpdateResult:
    """Apply one insertion/deletion batch to a ``SlackCSR`` as a binned
    delta-merge PB stream.

    The degree delta and the insert counts each run as one ``add`` reduce
    through ``PBExecutor.reduce_stream(kind="update")`` (``method``
    forwards: None/"auto" decides, "sort"/"counting"/"fused" force; all
    exact). Overflowing slabs regrow; when free slack after the batch is
    below ``rebuild_slack_frac`` the graph is rebuilt through
    ``PreprocessPipeline(variant="identity")`` unless ``allow_rebuild``
    is False. The batch moves to the slab's device.
    """
    ex = executor or get_default_executor()
    n = g.num_nodes
    dev = g.neighs.device
    src, dst, ins = (t.to(dev) for t in batch)
    b = int(src.shape[0])
    if b and not bool(((src >= 0) & (src < n) & (dst >= 0) & (dst < n)).all()):
        raise ValueError(f"batch endpoints outside [0, {n})")

    sink: list = []
    ex.add_decision_sink(sink)
    try:
        if b:
            # the delta-merge pair over the batch's src-keyed stream
            delta = ex.reduce_stream(
                src, torch.where(ins, 1, -1).to(torch.int32), out_size=n, op="add",
                # in-bounds-ok: the endpoints were checked against [0, n) above
                method=method, kind="update", in_bounds=True,
            )
            ins_counts = ex.reduce_stream(
                src, ins.to(torch.int32), out_size=n, op="add",
                # in-bounds-ok: the endpoints were checked against [0, n) above
                method=method, kind="update", in_bounds=True,
            ).long()
            del delta  # the net delta feeds the traffic model; counts drive the layout
        else:
            ins_counts = torch.zeros(n, dtype=torch.long, device=dev)
    finally:
        ex.remove_decision_sink(sink)

    off = g.offsets.long()
    nei = g.neighs.clone()
    cnt = g.counts.long()

    deleted, missed = _tombstone_deletes(off, nei, cnt, n, src[~ins], dst[~ins])

    regrown = 0
    need = cnt + ins_counts
    overflow = need > off[1:] - off[:-1]
    if bool(overflow.any()):
        regrown = int(overflow.sum())
        off, nei = _regrow(off, nei, cnt, n, need, headroom, min_slack)

    ins_src = src[ins]
    inserted = int(ins_src.numel())
    if inserted:
        rank = _insert_ranks(ins_src, n, method)
        isl = ins_src.long()
        nei[off[isl] + cnt[isl] + rank] = dst[ins]
        cnt = cnt + ins_counts

    out = SlackCSR(
        offsets=off.to(torch.int32), neighs=nei, counts=cnt.to(torch.int32), num_nodes=n
    )
    rebuilt = False
    report = None
    if allow_rebuild and out.slack_fraction < rebuild_slack_frac:
        out, report = rebuild_slack_csr(out, executor=ex, headroom=headroom, min_slack=min_slack)
        rebuilt = True
        sink.extend(report.decisions())
    return UpdateResult(
        graph=out,
        rebuilt=rebuilt,
        regrown=regrown,
        inserted=inserted,
        deleted=deleted,
        missed_deletes=missed,
        slack_fraction=out.slack_fraction,
        decisions=tuple(sink),
        report=report,
    )


def rebuild_slack_csr(
    g: SlackCSR,
    *,
    executor: Optional[PBExecutor] = None,
    headroom: float = 0.25,
    min_slack: int = 4,
):
    """Full rebuild: compact the live edges, re-run the PB build through
    ``PreprocessPipeline`` (variant="identity", one cold pass) and
    re-slack with fresh headroom. Returns (SlackCSR, PreprocessReport)."""
    from repro_torch.core.preprocess import PreprocessPipeline

    pipe = PreprocessPipeline(
        variant="identity",
        with_csc=False,
        executor=executor,
        warmup=False,
        slack_headroom=headroom,
        slack_min_slack=min_slack,
    )
    res = pipe.run(g.to_coo())
    return res.slack, res.report

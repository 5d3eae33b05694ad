"""Multi-tenant graph-query serving on the PB engine (port of
``repro/serving/graph_frontend.py``).

  admission  — ``GraphQuery`` requests (BFS / SSSP / personalized
      PageRank per source; PageRank / k-core global; "update" edge
      batches) enter per-tenant FIFO queues; admission is round-robin
      across tenants, so a flooding tenant cannot starve the others.
  coalescing — each ``tick`` serves one compatible group (same graph,
      kind and parameters, chosen by the globally oldest queue head) of
      up to ``max_batch`` queries as one batched call (``bfs_batched``,
      ``sssp_batched``, ``personalized_pagerank``), lanes padded to a
      power of two.
  warm plans — ``register_graph`` preprocesses through
      ``PreprocessPipeline`` (reorder + PB rebuild + SlackCSR), and
      ``warmup`` pre-decides every reduce key serving can generate.
  mutation   — "update" queries apply their ``EdgeBatch`` (original ids)
      through ``apply_edge_batch``, bump the graph's epoch, refresh the
      packed CSR and redraw sssp weights from ``(seed, epoch)``;
      memoized global answers are keyed by (graph, epoch, kind, param).
  clock      — every timestamp goes through an injected ``Clock``;
      ``FakeClock`` + ``poisson_trace`` + ``replay_trace`` make ticks,
      batches and latencies deterministic.

The graph lives on one device (where its COO was): the kernels run
there, a tick's lane rows are gathered through ``new_ids`` on that device
and copied to the host once per tick. sssp weights keep numpy's
``default_rng`` draws, so both packages serve the same weights. Results
(``GraphQuery.result``) are numpy arrays in original vertex ids.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import PBExecutor, get_default_executor
from repro_torch.core.graph import COO, CSR, SlackCSR
from repro_torch.core.preprocess import PreprocessPipeline, PreprocessReport
from repro_torch.core.traversal import (
    BATCHED_TRAVERSAL_METHODS,
    bfs_batched,
    bucket_len,
    k_core,
    personalized_pagerank,
    sssp_batched,
)
from repro_torch.core.updates import EdgeBatch, apply_edge_batch, make_batch

QUERY_KINDS = ("bfs", "sssp", "ppr", "pagerank", "kcore", "update")

# Kinds answered per source vertex: these coalesce into batched lanes.
# "pagerank"/"kcore" are graph-global and memoized per (graph, epoch,
# kind, param); "update" mutates the graph's SlackCSR.
_SOURCE_KINDS = ("bfs", "sssp", "ppr")


# ---------------------------------------------------------------------------
# Clocks: every timestamp the frontends take goes through one of these.
# ---------------------------------------------------------------------------


class Clock:
    """Monotonic wall clock (``time.perf_counter``).

    ``time.time()`` is not monotonic (NTP steps move it backwards), so
    latencies computed from it can go negative. Everything that measures
    a duration goes through ``now()`` here or on an injected fake.
    """

    def now(self) -> float:
        return time.perf_counter()

    def wait_until(self, t: float) -> None:
        """Sleep until ``now() >= t`` (benchmarks only; tests use
        ``FakeClock`` and never sleep)."""
        while True:
            dt = t - self.now()
            if dt <= 0:
                return
            time.sleep(min(dt, 0.05))


class FakeClock(Clock):
    """Manually advanced clock: deterministic time for tests.

    ``wait_until`` jumps instead of sleeping.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards: {dt}")
        self._t += dt

    def wait_until(self, t: float) -> None:
        if t > self._t:
            self._t = t


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile, ``sorted(xs)[ceil(p/100 * N) - 1]``: always
    an element of ``xs``, so results compare exactly."""
    s = sorted(xs)
    if not s:
        return float("nan")
    k = int(math.ceil(p / 100.0 * len(s))) - 1
    return s[max(0, min(len(s) - 1, k))]


def latency_stats(queries, percentiles: Tuple[float, ...] = (50.0, 99.0)) -> dict:
    """Latency summary over completed queries (submit -> done)."""
    lats = [q.t_done - q.t_submit for q in queries]
    out = {
        "count": len(lats),
        "mean": sum(lats) / len(lats) if lats else float("nan"),
        "max": max(lats) if lats else float("nan"),
    }
    for p in percentiles:
        out[f"p{p:g}"] = percentile(lats, p)
    return out


# ---------------------------------------------------------------------------
# Queries and the graph registry.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphQuery:
    """One request. ``source`` / ``iters`` / ``k`` are read per ``kind``;
    vertex ids are the graph's original ids (the frontend applies and
    inverts the preprocessing relabel)."""

    tenant: str
    graph: str
    kind: str  # one of QUERY_KINDS
    source: int = 0  # bfs / sssp / ppr
    iters: int = 10  # ppr / pagerank power iterations
    k: int = 2  # kcore threshold
    batch: Optional[EdgeBatch] = None  # update (original ids)
    qid: int = -1  # assigned at submit
    t_submit: float = 0.0
    t_start: float = 0.0  # admission into a tick
    t_done: float = 0.0
    result: Optional[np.ndarray] = None  # dense per-vertex answer

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def wait(self) -> float:
        return self.t_start - self.t_submit


@dataclasses.dataclass
class RegisteredGraph:
    """One preprocessed graph. "update" queries swap ``slack``/``csr``/
    ``weights`` in place and bump ``epoch``, the stamp every memo key
    carries."""

    name: str
    csr: CSR  # reordered layout, on the graph's device
    new_ids: np.ndarray  # old id -> new id, on the host (source mapping)
    new_ids_dev: torch.Tensor  # the same on the graph's device (row gathers)
    weights: torch.Tensor  # per-CSR-edge sssp weights (relabeled order)
    report: PreprocessReport
    slack: Optional[SlackCSR] = None  # the mutable layout updates edit
    epoch: int = 0  # bumped once per applied edge batch
    seed: int = 0  # weight redraw seed ((seed, epoch) per epoch > 0)


@dataclasses.dataclass
class WarmupReport:
    """What startup warmup did."""

    seconds: float
    decisions: int  # reduce cache keys pre-decided
    probes: int  # probe kernel calls
    cache_writes: int  # autotune entries written during warmup


def _lane_bucket(b: int, cap: int) -> int:
    """Admitted lane counts pad to the next power of two (at most cap)."""
    p = 1
    while p < b:
        p *= 2
    return min(p, cap)


def _weights(m: int, seed, device) -> torch.Tensor:
    """sssp weights uniform in [0.1, 1.1) from numpy ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(m, dtype=np.float32) + 0.1).to(device)


# ---------------------------------------------------------------------------
# The frontend.
# ---------------------------------------------------------------------------


class GraphFrontend:
    """Multi-tenant graph-query engine over preprocessed PB graphs.

    ``executor``: the PBExecutor every kernel routes through (process
    default when None). ``max_batch``: lane cap per tick. ``method``: the
    reduce method of every query kernel, one of
    ``BATCHED_TRAVERSAL_METHODS``. ``clock``: timing source (a
    ``FakeClock`` for deterministic runs). ``tick_cost``: service time
    added to a FakeClock after each tick.
    """

    def __init__(
        self,
        *,
        executor: Optional[PBExecutor] = None,
        max_batch: int = 8,
        method: str = "auto",
        clock: Optional[Clock] = None,
        tick_cost: float = 0.0,
    ):
        if method not in BATCHED_TRAVERSAL_METHODS:
            raise ValueError(
                f"serving method must be batchable {BATCHED_TRAVERSAL_METHODS}, got {method!r}"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.ex = executor or get_default_executor()
        self.max_batch = max_batch
        self.method = method
        self.clock = clock or Clock()
        self.tick_cost = float(tick_cost)
        self._graphs: Dict[str, RegisteredGraph] = {}
        # per-tenant FIFO queues in first-seen order (the round-robin ring)
        self._queues: "OrderedDict[str, Deque[GraphQuery]]" = OrderedDict()
        self._rr = 0
        self._seq = 0
        self._memo: Dict[tuple, np.ndarray] = {}  # global-kind results
        self.completed: List[GraphQuery] = []
        self.ticks = 0
        self.tick_log: List[dict] = []  # one record per tick
        self.warm_report: Optional[WarmupReport] = None

    # -- registry ----------------------------------------------------------

    def register_graph(
        self,
        name: str,
        coo: COO,
        *,
        variant: str = "degree_sort",
        build_method: str = "auto",
        weights: Optional[torch.Tensor] = None,
        seed: int = 0,
        slack_headroom: float = 0.25,
    ) -> RegisteredGraph:
        """Preprocess ``coo`` (reorder + PB rebuild + re-slack through
        ``PreprocessPipeline``) on its device and admit it. ``weights``
        are per slot of the rebuilt CSR; None draws uniform(0.1, 1.1)
        from numpy ``default_rng(seed)`` (redrawn from ``(seed, epoch)``
        after each mutation)."""
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        pipe = PreprocessPipeline(
            variant=variant,
            build_method=build_method,
            with_csc=False,  # every serving kernel pushes on the CSR
            executor=self.ex,
            slack_headroom=slack_headroom,
        )
        res = pipe.run(coo)
        m = res.csr.num_edges
        dev = coo.src.device
        if weights is None:
            w = _weights(m, seed, dev)
        else:
            if int(weights.shape[0]) != m:
                raise ValueError(
                    f"weights must align with the rebuilt CSR: {weights.shape[0]} != {m}"
                )
            w = torch.as_tensor(weights).to(device=dev, dtype=torch.float32)
        g = RegisteredGraph(
            name=name,
            csr=res.csr,
            new_ids=res.new_ids.cpu().numpy(),
            new_ids_dev=res.new_ids.long(),
            weights=w,
            report=res.report,
            slack=res.slack,
            epoch=0,
            seed=seed,
        )
        self._graphs[name] = g
        return g

    @property
    def graphs(self) -> Tuple[str, ...]:
        return tuple(self._graphs)

    # -- warmup ------------------------------------------------------------

    def warmup(self, *, probe: bool = True) -> WarmupReport:
        """Pre-decide every reduce cache key serving can generate, and
        (``probe``) run probe queries at every serving lane width.

        Reduce keys bucket stream_len by log2, frontier streams are padded
        to power-of-two buckets of at least 256 and at most
        ``bucket_len(m)``, and the PPR / PageRank stream is exactly m, so
        those lengths for each (op, dtype) the kernels use cover every
        decide serving will issue: with autotune on, all measurement
        happens here."""
        t0 = time.perf_counter()
        decided = 0
        probes = 0
        writes0 = len(self.ex.cache.mem)
        # bfs levels (min,i32) + parents (max,i32), sssp (min,f32),
        # kcore decrements (add,i32), ppr/pagerank mass (add,f32)
        pairs = (
            ("min", torch.int32),
            ("max", torch.int32),
            ("min", torch.float32),
            ("add", torch.int32),
            ("add", torch.float32),
        )
        for g in self._graphs.values():
            n = g.csr.num_nodes
            m = max(1, g.csr.num_edges)
            lengths = set()
            L = bucket_len(1)
            while L <= bucket_len(m):
                lengths.add(L)
                L *= 2
            lengths.add(m)
            for op, dt in pairs:
                for sl in sorted(lengths):
                    self.ex.decide(n, sl, dt, kind="reduce", op=op, device=g.csr.offsets.device)
                    decided += 1
        if probe:
            for g in self._graphs.values():
                probes += self._probe(g)
        self.warm_report = WarmupReport(
            seconds=time.perf_counter() - t0,
            decisions=decided,
            probes=probes,
            cache_writes=len(self.ex.cache.mem) - writes0,
        )
        return self.warm_report

    def _probe(self, g: RegisteredGraph) -> int:
        """Run each batched kernel once at every power-of-two lane width
        serving can admit, sources spread over the vertex range (on the
        card: the kernels' first launches, the allocator's first blocks)."""
        n = g.csr.num_nodes
        probes = 0
        B = 1
        while True:
            srcs = [int(i * n / B) % n for i in range(B)]
            bfs_batched(g.csr, srcs, executor=self.ex, method=self.method)
            sssp_batched(g.csr, g.weights, srcs, executor=self.ex, method=self.method)
            personalized_pagerank(g.csr, srcs, iters=1, executor=self.ex, method=self.method)
            probes += 3
            if B >= self.max_batch:
                break
            B = min(B * 2, self.max_batch)
        return probes

    # -- admission ---------------------------------------------------------

    def submit(self, q: GraphQuery, at: Optional[float] = None) -> int:
        """Enqueue one query; returns its qid. ``at`` stamps a nominal
        arrival time (open-loop traces)."""
        if q.graph not in self._graphs:
            raise ValueError(f"unknown graph {q.graph!r} (have {self.graphs})")
        if q.kind not in QUERY_KINDS:
            raise ValueError(f"unknown kind {q.kind!r} (want one of {QUERY_KINDS})")
        n = self._graphs[q.graph].csr.num_nodes
        if q.kind in _SOURCE_KINDS and not 0 <= q.source < n:
            raise ValueError(f"source {q.source} outside [0, {n}) for {q.graph!r}")
        if q.kind in ("ppr", "pagerank") and q.iters < 1:
            raise ValueError(f"iters must be >= 1, got {q.iters}")
        if q.kind == "update":
            if q.batch is None:
                raise ValueError("update queries need an EdgeBatch in q.batch")
            if self._graphs[q.graph].slack is None:
                raise ValueError(
                    f"graph {q.graph!r} was registered without a SlackCSR "
                    f"(slack_headroom=None): it cannot serve updates"
                )
            s, d = q.batch.src, q.batch.dst
            if s.numel() and not bool(((s >= 0) & (s < n) & (d >= 0) & (d < n)).all()):
                raise ValueError(f"batch endpoints outside [0, {n}) for {q.graph!r}")
        q.qid = self._seq
        self._seq += 1
        q.t_submit = float(at) if at is not None else self.clock.now()
        if q.tenant not in self._queues:
            self._queues[q.tenant] = deque()
        self._queues[q.tenant].append(q)
        return q.qid

    def pending_count(self) -> int:
        return sum(len(dq) for dq in self._queues.values())

    @staticmethod
    def _group_of(q: GraphQuery) -> tuple:
        """Coalescing key: queries in one batched tick agree on it."""
        if q.kind == "ppr" or q.kind == "pagerank":
            return (q.graph, q.kind, q.iters)
        if q.kind == "kcore":
            return (q.graph, q.kind, q.k)
        return (q.graph, q.kind, None)  # bfs / sssp / update

    def _admit(self) -> Tuple[List[GraphQuery], Optional[tuple]]:
        """Pick the tick's group by the globally oldest queue head (always
        admitted, so no query waits forever) and drain up to
        ``max_batch`` matching queries one per tenant per round, from a
        rotating ring position; lanes are laid out in qid order."""
        heads = [(dq[0].qid, t) for t, dq in self._queues.items() if dq]
        if not heads:
            return [], None
        _, oldest_tenant = min(heads)
        group = self._group_of(self._queues[oldest_tenant][0])
        ring = list(self._queues)
        start = self._rr % len(ring)
        ring = ring[start:] + ring[:start]
        self._rr += 1
        admitted: List[GraphQuery] = []
        progress = True
        while len(admitted) < self.max_batch and progress:
            progress = False
            for t in ring:
                if len(admitted) >= self.max_batch:
                    break
                dq = self._queues[t]
                for i, q in enumerate(dq):
                    if self._group_of(q) == group:
                        del dq[i]
                        admitted.append(q)
                        progress = True
                        break
        admitted.sort(key=lambda q: q.qid)
        return admitted, group

    # -- the tick ----------------------------------------------------------

    def tick(self) -> List[GraphQuery]:
        """Serve one coalesced group: admit, one batched call, complete.
        Returns the queries finished this tick."""
        admitted, group = self._admit()
        if not admitted:
            return []
        t_start = self.clock.now()
        for q in admitted:
            q.t_start = t_start
        info = self._execute(group, admitted)
        if self.tick_cost:
            adv = getattr(self.clock, "advance", None)
            if adv is not None:  # only fakes are told service time
                adv(self.tick_cost)
        t_done = self.clock.now()
        for q in admitted:
            q.t_done = t_done
        self.ticks += 1
        self.completed.extend(admitted)
        self.tick_log.append(
            {"tick": self.ticks - 1, "graph": group[0], "kind": group[1],
             "batch": len(admitted), **info}
        )
        return admitted

    def run_until_drained(self, max_ticks: int = 100_000) -> List[GraphQuery]:
        done: List[GraphQuery] = []
        for _ in range(max_ticks):
            out = self.tick()
            if not out:
                break
            done.extend(out)
        return done

    def _execute(self, group: tuple, queries: List[GraphQuery]) -> dict:
        graph, kind, param = group
        g = self._graphs[graph]
        if kind == "update":
            return self._execute_updates(g, queries)
        nid = g.new_ids_dev
        if kind in _SOURCE_KINDS:
            # original-id sources -> reordered layout; lanes padded to a
            # power of two (first source repeated; spare rows dropped)
            srcs = np.asarray([g.new_ids[q.source] for q in queries], np.int32)
            B = _lane_bucket(srcs.size, self.max_batch)
            padded = np.concatenate([srcs, np.full(B - srcs.size, srcs[0], np.int32)])
            if kind == "bfs":
                r = bfs_batched(g.csr, padded, executor=self.ex, method=self.method)
                rows, levels, edges = r.dist, r.levels, int(sum(r.level_edges))
            elif kind == "sssp":
                r = sssp_batched(g.csr, g.weights, padded, executor=self.ex, method=self.method)
                rows, levels, edges = r.dist, r.levels, int(sum(r.level_edges))
            else:  # ppr
                r = personalized_pagerank(
                    g.csr, padded, iters=param, executor=self.ex, method=self.method
                )
                rows, levels, edges = r.ranks, r.iters, r.iters * g.csr.num_edges * B
            # rows are new-id-indexed: gather back to original ids on the
            # device, then one copy to the host for the tick
            out = rows[: len(queries)][:, nid].cpu().numpy()
            for i, q in enumerate(queries):
                q.result = out[i]
            return {"lanes": int(B), "levels": int(levels), "edges": edges}
        # graph-global kinds: one computation, memoized under the epoch
        mkey = (graph, g.epoch, kind, param)
        cached = mkey in self._memo
        if not cached:
            if kind == "pagerank":
                r = personalized_pagerank(
                    g.csr, None, iters=param, executor=self.ex, method=self.method
                )
                self._memo[mkey] = r.ranks[nid].cpu().numpy()
                levels, edges = r.iters, r.iters * g.csr.num_edges
            else:  # kcore
                r = k_core(g.csr, param, executor=self.ex, method=self.method)
                self._memo[mkey] = r.in_core[nid].cpu().numpy()
                levels, edges = r.rounds, 0
        else:
            levels, edges = 0, 0
        for q in queries:
            q.result = self._memo[mkey]
        return {"lanes": 1, "levels": int(levels), "edges": int(edges), "memo": cached}

    def _execute_updates(self, g: RegisteredGraph, queries: List[GraphQuery]) -> dict:
        """Apply the tick's edge batches to ``g``'s SlackCSR, one
        ``apply_edge_batch`` per query in qid order, bumping the epoch per
        batch; then refresh the packed CSR, prune the dead epochs' memo
        entries and redraw the sssp weights from ``(seed, epoch)``. Each
        query's ``result`` is [epoch, inserted, deleted, missed_deletes]."""
        dev = g.csr.offsets.device
        nid = g.new_ids_dev
        inserted = deleted = missed = rebuilds = regrows = 0
        decisions = 0
        for q in queries:
            b = q.batch
            # tenant ids -> reordered layout
            nb = make_batch(nid[b.src.to(dev).long()], nid[b.dst.to(dev).long()],
                            b.insert, device=dev)
            res = apply_edge_batch(g.slack, nb, executor=self.ex)
            g.slack = res.graph
            g.epoch += 1
            inserted += res.inserted
            deleted += res.deleted
            missed += res.missed_deletes
            rebuilds += int(res.rebuilt)
            regrows += res.regrown
            decisions += len(res.decisions)
            q.result = np.asarray(
                [g.epoch, res.inserted, res.deleted, res.missed_deletes], np.int64
            )
        g.csr = g.slack.to_csr()
        g.weights = _weights(g.csr.num_edges, (g.seed, g.epoch), dev)
        self._memo = {
            k: v for k, v in self._memo.items() if k[0] != g.name or k[1] == g.epoch
        }
        return {
            "lanes": len(queries), "levels": 0,
            "edges": int(inserted + deleted + missed),
            "epoch": int(g.epoch), "inserted": int(inserted),
            "deleted": int(deleted), "missed_deletes": int(missed),
            "rebuilds": int(rebuilds), "regrown": int(regrows),
            "update_decisions": int(decisions),
        }

    # -- reporting ---------------------------------------------------------

    def stats(self, tenant: Optional[str] = None) -> dict:
        qs = [q for q in self.completed if tenant is None or q.tenant == tenant]
        return latency_stats(qs)


# ---------------------------------------------------------------------------
# Traces: seeded open-loop arrivals and deterministic replay.
# ---------------------------------------------------------------------------


def poisson_trace(
    rate_qps: float, num_queries: int, make_query, *, seed: int = 0
) -> List[Tuple[float, GraphQuery]]:
    """Seeded open-loop Poisson arrivals: ``num_queries`` (arrival_time,
    query) pairs with exponential gaps at ``rate_qps``; ``make_query(rng,
    i)`` builds the i-th query. Same seed, same trace."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=num_queries)
    times = np.cumsum(gaps)
    return [(float(times[i]), make_query(rng, i)) for i in range(num_queries)]


@dataclasses.dataclass
class TraceReport:
    """One replayed trace: completions and timing."""

    completed: List[GraphQuery]
    ticks: int
    span_seconds: float  # first arrival -> last completion (clock time)

    @property
    def throughput_qps(self) -> float:
        if self.span_seconds <= 0:
            return float("inf") if self.completed else 0.0
        return len(self.completed) / self.span_seconds

    def stats(self, tenant: Optional[str] = None) -> dict:
        qs = [q for q in self.completed if tenant is None or q.tenant == tenant]
        return latency_stats(qs)

    def tenants(self) -> Tuple[str, ...]:
        return tuple(sorted({q.tenant for q in self.completed}))


def replay_trace(
    frontend: GraphFrontend,
    trace: List[Tuple[float, GraphQuery]],
    *,
    max_ticks: int = 100_000,
) -> TraceReport:
    """Drive ``frontend`` through an open-loop arrival trace: arrivals are
    submitted (stamped with their nominal time) once the clock reaches
    them; with nothing pending the clock waits for the next arrival (a
    ``FakeClock`` jumps, a real clock sleeps)."""
    clock = frontend.clock
    order = sorted(trace, key=lambda a: a[0])
    t0 = clock.now()
    completed: List[GraphQuery] = []
    i = 0
    ticks0 = frontend.ticks
    while True:
        now = clock.now() - t0
        while i < len(order) and order[i][0] <= now + 1e-12:
            t_arr, q = order[i]
            frontend.submit(q, at=t0 + t_arr)
            i += 1
        if frontend.pending_count() == 0:
            if i >= len(order):
                break
            clock.wait_until(t0 + order[i][0])
            continue
        completed.extend(frontend.tick())
        if frontend.ticks - ticks0 >= max_ticks:
            break
    return TraceReport(
        completed=completed, ticks=frontend.ticks - ticks0, span_seconds=clock.now() - t0
    )

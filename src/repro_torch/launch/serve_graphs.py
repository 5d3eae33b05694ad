"""Graph-query serving launcher: the PB stack behind a frontend (port of
``repro/launch/serve_graphs.py``).

On the CUDA card (real clock, sustained Poisson load):
  PYTHONPATH=src python -m repro_torch.launch.serve_graphs --requests 64 --rate 200

Deterministic replay on the CPU (fake clock: zero sleeps, exact latencies):
  PYTHONPATH=src python -m repro_torch.launch.serve_graphs --fake-clock --device cpu

Registers the graph suite through ``PreprocessPipeline`` (reorder + PB
rebuild), warms the decision cache, then replays a seeded open-loop trace
of mixed BFS / SSSP / PPR / PageRank / k-core queries from several tenants
and prints throughput and latency percentiles (overall and per tenant).
It runs on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse

from repro_torch.core.executor import PBExecutor
from repro_torch.core.graph import graph_suite
from repro_torch.serving.graph_frontend import (
    Clock,
    FakeClock,
    GraphFrontend,
    GraphQuery,
    poisson_trace,
    replay_trace,
)

_KIND_MIX = ("bfs", "bfs", "sssp", "ppr", "pagerank", "kcore")


def make_query_mix(graphs, num_nodes, tenants: int = 4, iters: int = 10, k: int = 3):
    """Seeded mixed-workload query factory for ``poisson_trace``."""

    def make(rng, i):
        kind = _KIND_MIX[int(rng.integers(0, len(_KIND_MIX)))]
        name = graphs[int(rng.integers(0, len(graphs)))]
        return GraphQuery(
            tenant=f"tenant{i % tenants}",
            graph=name,
            kind=kind,
            source=int(rng.integers(0, num_nodes[name])),
            iters=iters,
            k=k,
        )

    return make


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=["smoke", "bench"], default="smoke")
    ap.add_argument("--graphs", default="DBP,KRON", help="comma list from the suite")
    ap.add_argument("--variant", default="degree_sort")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0, help="arrival rate (qps)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10, help="ppr/pagerank iterations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fake-clock", action="store_true",
                    help="deterministic replay: FakeClock, zero sleeps")
    ap.add_argument("--tick-cost", type=float, default=0.0,
                    help="modeled per-tick service time (fake clock only)")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the probe queries at startup")
    ap.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    suite = graph_suite(args.scale, device=args.device)
    names = [g.strip() for g in args.graphs.split(",") if g.strip()]
    for g in names:
        if g not in suite:
            raise SystemExit(f"unknown graph {g!r} (suite has {tuple(suite)})")

    clock = FakeClock() if args.fake_clock else Clock()
    ex = PBExecutor()
    fe = GraphFrontend(
        executor=ex, max_batch=args.max_batch, method=args.method,
        clock=clock, tick_cost=args.tick_cost,
    )
    for g in names:
        reg = fe.register_graph(g, suite[g], variant=args.variant, seed=args.seed)
        rep = reg.report
        print(
            f"[serve-graphs] registered {g}: n={rep.num_nodes} m={rep.num_edges} "
            f"variant={rep.variant} preprocess={rep.total_seconds*1e3:.1f}ms"
        )
    wr = fe.warmup(probe=not args.no_probe)
    print(
        f"[serve-graphs] warmup: {wr.seconds*1e3:.1f}ms, "
        f"{wr.decisions} decisions, {wr.probes} probes, "
        f"{wr.cache_writes} autotune writes"
    )

    num_nodes = {g: suite[g].num_nodes for g in names}
    trace = poisson_trace(
        args.rate, args.requests,
        make_query_mix(names, num_nodes, tenants=args.tenants, iters=args.iters),
        seed=args.seed,
    )
    rep = replay_trace(fe, trace)
    s = rep.stats()
    print(
        f"[serve-graphs] {len(rep.completed)} queries in {rep.ticks} ticks, "
        f"{rep.span_seconds*1e3:.1f}ms span -> {rep.throughput_qps:.1f} qps"
    )
    print(
        f"[serve-graphs] latency: mean={s['mean']*1e3:.2f}ms "
        f"p50={s['p50']*1e3:.2f}ms p99={s['p99']*1e3:.2f}ms "
        f"max={s['max']*1e3:.2f}ms"
    )
    for t in rep.tenants():
        ts = rep.stats(t)
        print(
            f"[serve-graphs]   {t}: {ts['count']} done, "
            f"p50={ts['p50']*1e3:.2f}ms p99={ts['p99']*1e3:.2f}ms"
        )
    mean_batch = (
        sum(e["batch"] for e in fe.tick_log) / len(fe.tick_log) if fe.tick_log else 0.0
    )
    print(f"[serve-graphs] mean batch {mean_batch:.2f} over {len(fe.tick_log)} ticks")
    return len(rep.completed)


if __name__ == "__main__":
    main()

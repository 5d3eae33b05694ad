"""Graph-serving parity: ``repro_torch.serving.graph_frontend`` and
``repro_torch.launch.serve_graphs`` against the reference's on the CPU.

Both frontends run under a ``FakeClock`` with a fixed tick cost, on
executors with the same hardware fields and fresh cache directories, and
replay one seeded multi-tenant trace that mixes reads with edge-batch
updates. Admissions, the tick log, latencies and every integer answer
(BFS levels, k-core membership, update counts) and SSSP distance must be
equal; PageRank and PPR answers sum float32 in another order and agree
within rtol 1e-5, atol 1e-7. The frontend's own contracts (coalescing,
memo by epoch, fairness, the warm-cache invariant) are checked as the
reference's tests check them.
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import updates as rup
from repro.core.plan import HardwareModel as RHW
from repro.launch import serve_graphs as rlaunch
from repro.serving import graph_frontend as rfe
from repro_torch.convert import coo_from_numpy, csr_from_numpy, hardware_from_fields, to_numpy
from repro_torch.core import executor as tex
from repro_torch.core import traversal as ttrav
from repro_torch.core import updates as tup
from repro_torch.core.neighbor_populate import build_csr
from repro_torch.core.plan import HardwareModel as THW
from repro_torch.launch import serve_graphs as tlaunch
from repro_torch.serving import graph_frontend as tfe

SUITE = R.graph_suite("smoke")
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-7
TICK = 0.002


def _coo(name):
    g = SUITE[name]
    return coo_from_numpy(np.asarray(g.src), np.asarray(g.dst), g.num_nodes, device="cpu")


def _executors(tmp_path, autotune=False):
    t = THW.h100()
    rhw = RHW(t.name, tuple(t.fast_levels), t.cbuffer_bytes, t.dram_bandwidth, t.fast_bandwidth)
    thw = hardware_from_fields(rhw.name, rhw.fast_levels, rhw.cbuffer_bytes,
                               rhw.dram_bandwidth, rhw.fast_bandwidth)
    return (R.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"), autotune=autotune),
            tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t"), autotune=autotune))


@pytest.fixture(scope="module")
def tx(tmp_path_factory):
    return tex.PBExecutor(cache_dir=str(tmp_path_factory.mktemp("tcache")))


def _specs(num, graphs, seed):
    """Seeded query specs: every kind, several tenants, two update batches
    per graph (original ids; 10% of each batch deletes)."""
    rng = np.random.default_rng(seed)
    kinds = ("bfs", "sssp", "ppr", "bfs", "pagerank", "kcore", "update")
    out = []
    for i in range(num):
        kind = kinds[i % len(kinds)]
        g = graphs[int(rng.integers(0, len(graphs)))]
        spec = dict(tenant=f"t{i % 3}", graph=g, kind=kind,
                    source=int(rng.integers(0, SUITE[g].num_nodes)), iters=4, k=2)
        if kind == "update":
            b = rup.random_edge_batch(SUITE[g], 36, 4, seed=1000 + i)
            spec["batch"] = (np.asarray(b.src), np.asarray(b.dst), np.asarray(b.insert))
        out.append(spec)
    return out


def _queries(specs, mod, make_batch):
    qs = []
    for s in specs:
        kw = {k: v for k, v in s.items() if k != "batch"}
        if "batch" in s:
            kw["batch"] = make_batch(*s["batch"])
        qs.append(mod.GraphQuery(**kw))
    return qs


def _trace(specs, mod, make_batch, rate=2000.0):
    qs = iter(_queries(specs, mod, make_batch))
    return mod.poisson_trace(rate, len(specs), lambda rng, i: next(qs), seed=17)


def _same_answer(t, r, kind):
    assert t.dtype == r.dtype, (kind, t.dtype, r.dtype)
    if kind in ("ppr", "pagerank"):
        np.testing.assert_allclose(t, r, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    else:
        np.testing.assert_array_equal(t, r)


def _same_replay(tf, trep, rf, rrep):
    assert trep.ticks == rrep.ticks
    assert trep.span_seconds == rrep.span_seconds
    assert tf.tick_log == rf.tick_log
    assert [q.qid for q in trep.completed] == [q.qid for q in rrep.completed]
    for tq, rq in zip(trep.completed, rrep.completed):
        assert (tq.tenant, tq.kind, tq.t_submit, tq.t_start, tq.t_done) == (
            rq.tenant, rq.kind, rq.t_submit, rq.t_start, rq.t_done)
        _same_answer(tq.result, np.asarray(rq.result), tq.kind)
    assert trep.stats() == rrep.stats()
    assert trep.tenants() == rrep.tenants()
    for t in trep.tenants():
        assert trep.stats(t) == rrep.stats(t)
    assert trep.throughput_qps == rrep.throughput_qps


@pytest.mark.parametrize("max_batch", [1, 4])
def test_fake_clock_replay_with_updates_matches_reference(tmp_path, max_batch):
    graphs = ("DBP", "KRON")
    rx, txx = _executors(tmp_path)
    fes = {}
    for side, mod, ex in (("r", rfe, rx), ("t", tfe, txx)):
        fe = mod.GraphFrontend(executor=ex, max_batch=max_batch, clock=mod.FakeClock(),
                               tick_cost=TICK)
        for g in graphs:
            fe.register_graph(g, SUITE[g] if side == "r" else _coo(g), seed=3)
        fes[side] = fe
    for g in graphs:
        rg, tg = fes["r"]._graphs[g], fes["t"]._graphs[g]
        np.testing.assert_array_equal(tg.new_ids, np.asarray(rg.new_ids))
        np.testing.assert_array_equal(to_numpy(tg.weights), np.asarray(rg.weights))
        assert tg.report.decisions() == rg.report.decisions()
    rw, tw = fes["r"].warmup(probe=False), fes["t"].warmup(probe=False)
    assert (tw.decisions, tw.probes, tw.cache_writes) == (rw.decisions, rw.probes, rw.cache_writes)
    specs = _specs(28, graphs, seed=max_batch)
    rrep = rfe.replay_trace(fes["r"], _trace(specs, rfe, rup.make_batch))
    trep = tfe.replay_trace(fes["t"], _trace(specs, tfe, lambda *b: tup.make_batch(*b, device="cpu")))
    _same_replay(fes["t"], trep, fes["r"], rrep)
    assert len(trep.completed) == len(specs)
    assert sum(e["kind"] == "update" for e in fes["t"].tick_log) > 0
    assert max(e["batch"] for e in fes["t"].tick_log) == max_batch  # ticks coalesced
    for g in graphs:
        rg, tg = fes["r"]._graphs[g], fes["t"]._graphs[g]
        assert tg.epoch == rg.epoch > 0
        for f in ("offsets", "neighs", "counts"):
            np.testing.assert_array_equal(to_numpy(getattr(tg.slack, f)),
                                          np.asarray(getattr(rg.slack, f)))
        np.testing.assert_array_equal(to_numpy(tg.weights), np.asarray(rg.weights))
    assert sorted(fes["t"]._memo) == sorted(fes["r"]._memo)


# ---------------------------------------------------------------------------
# The frontend's own contracts.
# ---------------------------------------------------------------------------


def _mixed_queries():
    qs = []
    for i, s in enumerate([1, 5, 9, 33, 57, 101]):
        qs.append(tfe.GraphQuery(tenant=f"t{i % 2}", graph="G", kind="bfs", source=s))
    for i, s in enumerate([2, 6, 10, 34]):
        qs.append(tfe.GraphQuery(tenant=f"t{i % 2}", graph="G", kind="sssp", source=s))
    for i, s in enumerate([3, 7, 11]):
        qs.append(tfe.GraphQuery(tenant=f"t{i % 3}", graph="G", kind="ppr", source=s, iters=6))
    qs.append(tfe.GraphQuery(tenant="t0", graph="G", kind="pagerank", iters=6))
    qs.append(tfe.GraphQuery(tenant="t2", graph="G", kind="kcore", k=2))
    return qs


def _serve(max_batch, ex):
    fe = tfe.GraphFrontend(executor=ex, max_batch=max_batch, clock=tfe.FakeClock())
    fe.register_graph("G", _coo("KRON"), seed=0)
    for q in _mixed_queries():
        fe.submit(q, at=0.0)
    done = fe.run_until_drained()
    assert fe.pending_count() == 0
    return fe, {(q.tenant, q.kind, q.source, q.iters, q.k): q.result for q in done}


def test_coalesced_ticks_equal_individual_queries(tx):
    """BFS/SSSP/k-core answers equal bit for bit; PPR within the float
    tolerance (a lane of the (m, B) block sums in another order)."""
    fe1, singles = _serve(1, tx)
    fe4, batched = _serve(4, tx)
    assert singles.keys() == batched.keys()
    for k in singles:
        _same_answer(batched[k], singles[k], k[1])
    assert fe4.ticks < fe1.ticks and max(r["batch"] for r in fe4.tick_log) > 1


def test_frontend_inverts_the_preprocess_relabeling(tx):
    coo = _coo("DBP")
    fe = tfe.GraphFrontend(executor=tx, max_batch=2, clock=tfe.FakeClock())
    g = fe.register_graph("G", coo, seed=7)
    fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="bfs", source=17))
    fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="sssp", source=17))
    done = {q.kind: q for q in fe.run_until_drained()}
    want = ttrav.bfs(build_csr(coo), 17, executor=tx).dist
    np.testing.assert_array_equal(done["bfs"].result, to_numpy(want))
    r = ttrav.sssp(g.csr, g.weights, int(g.new_ids[17]), executor=tx)
    np.testing.assert_array_equal(done["sssp"].result, to_numpy(r.dist)[g.new_ids])


def test_memo_is_keyed_by_epoch_and_updates_invalidate_it(tx):
    coo = _coo("DBP")
    fe = tfe.GraphFrontend(executor=tx, max_batch=4, clock=tfe.FakeClock())
    fe.register_graph("g", coo, seed=0)
    q1 = tfe.GraphQuery(tenant="t", graph="g", kind="pagerank")
    fe.submit(q1)
    fe.run_until_drained()
    assert list(fe._memo) == [("g", 0, "pagerank", 10)]
    q2 = tfe.GraphQuery(tenant="t", graph="g", kind="pagerank")
    fe.submit(q2)
    fe.run_until_drained()
    assert q2.result is q1.result and fe.tick_log[-1]["memo"] is True
    ub = tup.random_edge_batch(coo, 256, 64, seed=3)
    uq = tfe.GraphQuery(tenant="t", graph="g", kind="update", batch=ub)
    fe.submit(uq)
    fe.run_until_drained()
    assert fe._graphs["g"].epoch == 1
    np.testing.assert_array_equal(uq.result, [1, ub.num_inserts, ub.num_deletes, 0])
    assert fe._memo == {}  # the dead epoch's entry is pruned
    q3 = tfe.GraphQuery(tenant="t", graph="g", kind="pagerank")
    fe.submit(q3)
    fe.run_until_drained()
    assert q3.result is not q1.result and not np.allclose(q1.result, q3.result)
    assert list(fe._memo) == [("g", 1, "pagerank", 10)]
    # the refreshed CSR is the slab's compaction, the weights redrawn
    g = fe._graphs["g"]
    assert torch.equal(g.csr.neighs, g.slack.to_csr().neighs)
    assert g.weights.shape[0] == g.csr.num_edges == coo.num_edges + 256 - 64


def test_submit_validates_queries(tx):
    fe = tfe.GraphFrontend(executor=tx, max_batch=2, clock=tfe.FakeClock())
    coo = _coo("EURO")
    fe.register_graph("G", coo, seed=0)
    n = coo.num_nodes
    with pytest.raises(ValueError, match="unknown graph"):
        fe.submit(tfe.GraphQuery(tenant="a", graph="nope", kind="bfs"))
    with pytest.raises(ValueError, match="unknown kind"):
        fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="dfs"))
    with pytest.raises(ValueError, match="source"):
        fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="bfs", source=n))
    with pytest.raises(ValueError, match="iters"):
        fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="ppr", iters=0))
    with pytest.raises(ValueError, match="EdgeBatch"):
        fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="update"))
    with pytest.raises(ValueError, match="outside"):
        fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="update",
                                 batch=tup.make_batch([0], [n], [True], device="cpu")))
    with pytest.raises(ValueError, match="already registered"):
        fe.register_graph("G", coo)
    with pytest.raises(ValueError, match="batchable"):
        tfe.GraphFrontend(method="pallas")
    with pytest.raises(ValueError, match="max_batch"):
        tfe.GraphFrontend(max_batch=0)
    fe.register_graph("frozen", coo, slack_headroom=None)
    b = tup.make_batch([0], [1], [True], device="cpu")
    with pytest.raises(ValueError, match="SlackCSR"):
        fe.submit(tfe.GraphQuery(tenant="a", graph="frozen", kind="update", batch=b))


def test_flooding_tenant_cannot_starve_a_small_one(tx):
    """tick_cost=1 on a FakeClock makes t_done the tick index."""
    fe = tfe.GraphFrontend(executor=tx, max_batch=4, clock=tfe.FakeClock(), tick_cost=1.0)
    fe.register_graph("G", _coo("EURO"), seed=0)
    for i in range(16):
        fe.submit(tfe.GraphQuery(tenant="flood", graph="G", kind="bfs", source=i), at=0.0)
    for i in range(4):
        fe.submit(tfe.GraphQuery(tenant="small", graph="G", kind="bfs", source=100 + i), at=0.0)
    done = fe.run_until_drained()
    assert len(done) == 20 and fe.ticks == 5
    small = [q for q in done if q.tenant == "small"]
    flood = [q for q in done if q.tenant == "flood"]
    assert max(q.t_done for q in small) == 2.0
    assert max(q.t_done for q in flood) == 5.0
    assert all(rec["batch"] == 4 for rec in fe.tick_log[:2])
    assert tfe.latency_stats(small)["max"] <= tfe.latency_stats(flood)["max"]


def test_oldest_head_bounds_staleness_across_groups(tx):
    fe = tfe.GraphFrontend(executor=tx, max_batch=4, clock=tfe.FakeClock(), tick_cost=1.0)
    fe.register_graph("G", _coo("EURO"), seed=0)
    fe.submit(tfe.GraphQuery(tenant="a", graph="G", kind="sssp", source=3), at=0.0)
    for i in range(8):
        fe.submit(tfe.GraphQuery(tenant="b", graph="G", kind="bfs", source=i), at=0.0)
    done = fe.run_until_drained()
    assert fe.tick_log[0]["kind"] == "sssp" and fe.tick_log[0]["batch"] == 1
    assert [r["kind"] for r in fe.tick_log[1:]] == ["bfs", "bfs"]
    assert len(done) == 9


def _trace_query(rng, i):
    kinds = ("bfs", "sssp", "ppr", "pagerank", "kcore")
    return tfe.GraphQuery(tenant=f"t{i % 3}", graph="G", kind=kinds[i % len(kinds)],
                          source=int(rng.integers(0, 1024)), iters=4, k=2)


def test_warmup_covers_every_serving_decide(tmp_path, monkeypatch):
    """With autotune on, every decide of a replayed trace hits what
    warmup decided: no cache write after it."""
    ex = tex.PBExecutor(autotune=True, cache_dir=str(tmp_path))
    monkeypatch.setattr(tex.PBExecutor, "measure_methods",
                        lambda self, *a, **k: {"method": "sort", "timings_us": {}})
    fe = tfe.GraphFrontend(executor=ex, max_batch=4, clock=tfe.FakeClock())
    fe.register_graph("G", _coo("DBP"), seed=0)
    rep = fe.warmup(probe=False)
    assert rep.decisions > 0 and rep.cache_writes > 0
    puts = []
    orig = ex.cache.put
    monkeypatch.setattr(ex.cache, "put", lambda key, entry: (puts.append(key), orig(key, entry)))
    report = tfe.replay_trace(fe, tfe.poisson_trace(100.0, 20, _trace_query, seed=3))
    assert len(report.completed) == 20
    assert puts == [], f"serving wrote autotune entries after warmup: {puts}"


def test_warm_report_matches_reference(tmp_path):
    rx, txx = _executors(tmp_path)
    reps = []
    for mod, ex, g in ((rfe, rx, SUITE["EURO"]), (tfe, txx, _coo("EURO"))):
        fe = mod.GraphFrontend(executor=ex, max_batch=4, clock=mod.FakeClock())
        fe.register_graph("G", g, seed=0)
        reps.append(fe.warmup(probe=True))
        assert fe.warm_report is reps[-1]
    (r, t) = reps
    assert (t.decisions, t.probes, t.cache_writes) == (r.decisions, r.probes, r.cache_writes)
    assert t.probes == 9  # 3 kernels x lane widths {1, 2, 4}


def test_percentile_latency_stats_and_trace_match_reference():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    for p in (0.0, 37.0, 50.0, 99.0, 100.0):
        assert tfe.percentile(xs, p) == rfe.percentile(xs, p)
    assert np.isnan(tfe.percentile([], 50.0))
    s = tfe.latency_stats([])
    assert s["count"] == 0 and np.isnan(s["mean"])
    a = tfe.poisson_trace(50.0, 30, lambda rng, i: int(rng.integers(0, 9)), seed=9)
    b = rfe.poisson_trace(50.0, 30, lambda rng, i: int(rng.integers(0, 9)), seed=9)
    assert a == b
    with pytest.raises(ValueError):
        tfe.poisson_trace(0.0, 1, lambda rng, i: None)
    assert [tfe._lane_bucket(b, 8) for b in range(1, 10)] == \
        [rfe._lane_bucket(b, 8) for b in range(1, 10)]
    assert tfe.QUERY_KINDS == rfe.QUERY_KINDS


def test_replay_is_deterministic_on_the_fake_clock(tx):
    def once():
        fe = tfe.GraphFrontend(executor=tx, max_batch=4, clock=tfe.FakeClock(), tick_cost=0.01)
        fe.register_graph("G", _coo("DBP"), seed=0)
        fe.warmup(probe=False)
        return fe, tfe.replay_trace(fe, tfe.poisson_trace(200.0, 24, _trace_query, seed=11))

    (fa, ra), (fb, rb) = once(), once()
    assert fa.tick_log == fb.tick_log and ra.span_seconds == rb.span_seconds
    assert [q.latency for q in ra.completed] == [q.latency for q in rb.completed]
    assert all(q.latency >= fa.tick_cost - 1e-9 for q in ra.completed)
    assert ra.throughput_qps > 0


def test_clocks():
    c = tfe.FakeClock(2.0)
    c.advance(0.5)
    c.wait_until(1.0)
    assert c.now() == 2.5
    c.wait_until(4.0)
    assert c.now() == 4.0
    with pytest.raises(ValueError):
        c.advance(-1.0)
    real = tfe.Clock()
    t0 = real.now()
    real.wait_until(t0 + 0.001)
    assert real.now() >= t0 + 0.001


def test_serve_graphs_launcher_completes_the_reference_count(capsys):
    argv = ["--fake-clock", "--tick-cost", "2e-3", "--requests", "12", "--no-probe",
            "--max-batch", "4"]
    want = rlaunch.main(argv)
    got = tlaunch.main(argv + ["--device", "cpu"])
    assert got == want == 12
    out = capsys.readouterr().out
    assert "[serve-graphs] 12 queries" in out
    q = tlaunch.make_query_mix(["A"], {"A": 10})(np.random.default_rng(0), 5)
    assert (q.tenant, q.graph) == ("tenant1", "A") and 0 <= q.source < 10

"""Mutation parity: the executor's ``update`` kind, ``repro_torch.core.updates``
and the incremental kernels against ``repro.core`` on the CPU.

Both sides get the same SlackCSR (the reference's), the same numpy-drawn
batches and executors with the same hardware fields and fresh cache
directories. Slabs, counts, offsets, the insert / delete / missed / regrow
/ rebuild accounting, the decision records, ``bfs_incremental``'s runs and
the incremental components must be equal; the incremental PageRank sums
float32 in another order and agrees within rtol 1e-5, atol 1e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import executor as rex
from repro.core import traversal as rtrav
from repro.core import updates as rup
from repro.core.plan import HardwareModel as RHW
from repro_torch.convert import coo_from_numpy, csr_from_numpy, hardware_from_fields, to_numpy
from repro_torch.core import components as tcomp
from repro_torch.core import executor as tex
from repro_torch.core import graph as tgraph
from repro_torch.core import pagerank as tpr
from repro_torch.core import traversal as ttrav
from repro_torch.core import updates as tup
from repro_torch.core.plan import HardwareModel as THW

SUITE = R.graph_suite("smoke")
PR_RTOL, PR_ATOL = 1e-5, 1e-7
_JNP = {torch.float32: jnp.float32, torch.int32: jnp.int32}


def _hw(which):
    t = getattr(THW, which)()
    r = RHW(t.name, tuple(t.fast_levels), t.cbuffer_bytes, t.dram_bandwidth, t.fast_bandwidth)
    return r, hardware_from_fields(r.name, r.fast_levels, r.cbuffer_bytes, r.dram_bandwidth,
                                   r.fast_bandwidth)


def _executors(tmp_path, which="h100"):
    rhw, thw = _hw(which)
    return (rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r")),
            tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t")))


def _eq(t, r):
    a, b = to_numpy(t), np.asarray(r)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _coo(g):
    return coo_from_numpy(np.asarray(g.src), np.asarray(g.dst), g.num_nodes, device="cpu")


def _slack(rs):
    return tgraph.SlackCSR(*(torch.from_numpy(np.array(getattr(rs, f)))
                             for f in ("offsets", "neighs", "counts")), rs.num_nodes)


def _batch(rb):
    return tup.make_batch(np.asarray(rb.src), np.asarray(rb.dst), np.asarray(rb.insert),
                          device="cpu")


def _same_slack(t, r):
    for f in ("offsets", "neighs", "counts"):
        _eq(getattr(t, f), getattr(r, f))
    assert t.num_nodes == r.num_nodes


def _same_update(t, r):
    _same_slack(t.graph, r.graph)
    assert (t.rebuilt, t.regrown, t.inserted, t.deleted, t.missed_deletes, t.slack_fraction) == (
        r.rebuilt, r.regrown, r.inserted, r.deleted, r.missed_deletes, r.slack_fraction)
    assert t.decisions == r.decisions
    assert (t.report is None) == (r.report is None)


def _setup(name, headroom=0.25, min_slack=4, graph=None):
    g = graph if graph is not None else SUITE[name]
    rc = R.build_csr_baseline(g)
    rs = R.SlackCSR.from_csr(rc, headroom=headroom, min_slack=min_slack)
    return g, rs, _slack(rs)


# ---------------------------------------------------------------------------
# The executor's update kind.
# ---------------------------------------------------------------------------


def _same_decision(td, rd):
    assert (td.method, td.bin_range, td.num_bins, td.source, td.f_tile) == (
        rd.method, rd.bin_range, rd.num_bins, rd.source, rd.f_tile)
    assert (td.plan is None) == (rd.plan is None)


def _key_fields(tkey, rkey):
    """The keys without their device parts: the port's ``torch:cpu:d1``,
    the reference's ``cpu:d<devices>``."""
    t, r = tkey.split(":"), rkey.split(":")
    return t[:3] + t[6:], r[:3] + r[5:]


@pytest.mark.parametrize("which", ["h100", "tpu_v5e", "cpu_xeon"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_update_decisions_and_keys_match_reference(tmp_path, which, use_pallas):
    rhw, thw = _hw(which)
    rx = rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"), use_pallas=use_pallas)
    tx = tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t"), use_pallas=use_pallas)
    for n in (1, 300, 1 << 10, 1 << 14, 1 << 18, 4_194_304, 32_000_000):
        for m in (0, 100, 5000, 1 << 16, 1 << 20, 33_554_432):
            for br in (None, 64):
                for dt in (torch.int32, torch.float32):
                    for op in ("add", "min"):
                        kw = dict(bin_range=br, kind="update", op=op)
                        _same_decision(tx.decide(n, m, dt, device="cpu", **kw),
                                       rx.decide(n, m, _JNP[dt], **kw))
                        tk, rk = _key_fields(
                            tx._key(n, m, dt, br, "update", op, 0, torch.device("cpu")),
                            rx._key(n, m, _JNP[dt], br, "update", op, None, 0))
                        assert tk == rk
    assert tx.decision_log == rx.decision_log
    # update streams get their own keys, beside the reduce ones
    k = tx._key(1024, 4096, torch.int32, None, "update", "add", 0, torch.device("cpu"))
    assert ":update:add" in k and k != tx._key(1024, 4096, torch.int32, None, "reduce", "add", 0,
                                               torch.device("cpu"))
    assert "fused" in tx._candidates(True, "update")


def test_update_kind_on_the_h100_model_follows_the_flat_reduce():
    ex = tex.PBExecutor()
    for n, m in ((4_194_304, 33_554_432), (32_000_000, 128_000_000), (1 << 18, 4096)):
        for dev in ("cpu", "cuda"):
            u = ex.decide(n, m, torch.int32, kind="update", device=dev)
            r = ex.decide(n, m, torch.int32, kind="reduce", device=dev)
            assert (u.method, u.bin_range, u.source) == (r.method, r.bin_range, r.source)


@pytest.mark.parametrize("method", [None, "sort", "counting", "fused", "hierarchical"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_reduce_stream_update_kind_matches_reference(tmp_path, method, op):
    rx, tx = _executors(tmp_path)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 1024, 5000).astype(np.int32)
    val = rng.integers(-1, 2, 5000).astype(np.int32)
    got = tx.reduce_stream(torch.from_numpy(idx), torch.from_numpy(val), out_size=1024, op=op,
                           method=method, kind="update", in_bounds=True)
    want = rx.reduce_stream(jnp.asarray(idx), jnp.asarray(val), out_size=1024, op=op,
                            method=method, kind="update", in_bounds=True)
    _eq(got, want)
    assert tx.decision_log == rx.decision_log and len(tx.decision_log) == 1
    assert tx.decision_log[0]["kind"] == "update"
    if method is not None:
        assert tx.decision_log[0]["source"] == "caller"


def test_unknown_kinds_raise(tmp_path):
    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    i, v = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    with pytest.raises(ValueError, match="kind"):
        ex.reduce_stream(i, v, out_size=4, kind="bin")
    with pytest.raises(ValueError, match="kind"):
        ex.decide(4, 3, kind="scatter", device="cpu")


# ---------------------------------------------------------------------------
# Batches and the multiset oracle.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["DBP", "EURO"])
@pytest.mark.parametrize("ins,dels,seed", [(64, 16, 0), (0, 40, 1), (300, 0, 2), (5, 10_000, 3)])
def test_random_batch_merge_and_touched_match_reference(name, ins, dels, seed):
    g = SUITE[name]
    tc = _coo(g)
    rb = rup.random_edge_batch(g, ins, dels, seed=seed)
    tb = tup.random_edge_batch(tc, ins, dels, seed=seed)
    for f in ("src", "dst", "insert"):
        _eq(getattr(tb, f), getattr(rb, f))
    assert (tb.num_updates, tb.num_inserts, tb.num_deletes) == (
        rb.num_updates, rb.num_inserts, rb.num_deletes)
    tm, rm = tup.merge_batch_coo(tc, tb), rup.merge_batch_coo(g, rb)
    _eq(tm.src, rm.src)
    _eq(tm.dst, rm.dst)
    tt, rt = tup.touched_vertices(tb), rup.touched_vertices(rb)
    np.testing.assert_array_equal(tt[0], rt[0])
    assert tt[0].dtype == rt[0].dtype and tt[1] == rt[1]


def test_merge_removes_one_occurrence_per_delete():
    tc = tgraph.COO(torch.tensor([0, 0, 0, 1, 2], dtype=torch.int32),
                    torch.tensor([1, 1, 1, 2, 0], dtype=torch.int32), 3)
    rc = R.COO(jnp.asarray(tc.src.numpy()), jnp.asarray(tc.dst.numpy()), 3)
    b = ([0, 0, 2, 1, 0], [1, 1, 1, 0, 2], [False, False, False, True, True])
    tm = tup.merge_batch_coo(tc, tup.make_batch(*b, device="cpu"))
    rm = rup.merge_batch_coo(rc, rup.make_batch(*b))
    _eq(tm.src, rm.src)
    _eq(tm.dst, rm.dst)


# ---------------------------------------------------------------------------
# apply_edge_batch.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["DBP", "KRON", "URND", "EURO", "HBUBL"])
@pytest.mark.parametrize("ins,dels", [(200, 0), (200, 50), (0, 80)])
def test_apply_edge_batch_matches_reference(tmp_path, name, ins, dels):
    g, rs, ts = _setup(name)
    rx, tx = _executors(tmp_path)
    rb = rup.random_edge_batch(g, ins, dels, seed=7)
    t = tup.apply_edge_batch(ts, _batch(rb), executor=tx)
    r = rup.apply_edge_batch(rs, rb, executor=rx)
    _same_update(t, r)
    # the layout holds exactly the from-scratch build's edges
    want = R.build_csr_baseline(rup.merge_batch_coo(g, rb))
    assert R.csr_equal_as_sets(
        R.CSR(jnp.asarray(to_numpy(t.graph.to_csr().offsets)),
              jnp.asarray(to_numpy(t.graph.to_csr().neighs)), g.num_nodes), want)


@pytest.mark.parametrize("method", ["sort", "counting", "fused", "auto"])
def test_apply_edge_batch_forced_methods_match_reference(tmp_path, method):
    g, rs, ts = _setup("KRON")
    rx, tx = _executors(tmp_path)
    rb = rup.random_edge_batch(g, 150, 30, seed=11)
    t = tup.apply_edge_batch(ts, _batch(rb), executor=tx, method=method)
    r = rup.apply_edge_batch(rs, rb, executor=rx, method=method)
    _same_update(t, r)
    assert all(d["kind"] == "update" for d in t.decisions) and len(t.decisions) == 2


def test_multiset_and_missed_deletes_match_reference(tmp_path):
    """Duplicate edges: each delete removes one live copy (the earliest
    slot first); a delete beyond the copies, or of an absent edge, is a
    miss; a delete and a re-insert of the same edge in one batch."""
    src = np.asarray([0, 0, 0, 0, 1, 1, 2, 3], np.int32)
    dst = np.asarray([1, 1, 1, 2, 0, 0, 3, 3], np.int32)
    rg = R.COO(jnp.asarray(src), jnp.asarray(dst), 5)
    g, rs, ts = _setup(None, graph=rg)
    rx, tx = _executors(tmp_path)
    b = ([0, 0, 1, 1, 1, 4, 0, 2],
         [1, 1, 0, 0, 0, 4, 1, 3],
         [False, False, False, False, False, False, True, False])
    t = tup.apply_edge_batch(ts, tup.make_batch(*b, device="cpu"), executor=tx)
    r = rup.apply_edge_batch(rs, rup.make_batch(*b), executor=rx)
    _same_update(t, r)
    assert (t.deleted, t.missed_deletes, t.inserted) == (5, 2, 1)


def test_empty_batch_is_identity(tmp_path):
    g, rs, ts = _setup("EURO")
    rx, tx = _executors(tmp_path)
    e = ([], [], [])
    t = tup.apply_edge_batch(ts, tup.make_batch(*e, device="cpu"), executor=tx)
    r = rup.apply_edge_batch(rs, rup.make_batch(*e), executor=rx)
    _same_update(t, r)
    _same_slack(t.graph, rs)
    assert t.decisions == ()


def test_batch_endpoints_are_validated():
    g, rs, ts = _setup("EURO")
    n = g.num_nodes
    for b in (([0], [n], [True]), ([-1], [0], [False])):
        with pytest.raises(ValueError, match="outside"):
            tup.apply_edge_batch(ts, tup.make_batch(*b, device="cpu"))


@pytest.mark.parametrize("headroom,min_slack", [(0.0, 0), (0.0, 1), (0.1, 2)])
def test_regrow_matches_reference(tmp_path, headroom, min_slack):
    """Little slack: most insert targets overflow their slab and regrow."""
    g, rs, ts = _setup("HBUBL", headroom=headroom, min_slack=min_slack)
    rx, tx = _executors(tmp_path)
    rb = rup.random_edge_batch(g, 400, 60, seed=5)
    kw = dict(headroom=0.3, min_slack=3, allow_rebuild=False)
    t = tup.apply_edge_batch(ts, _batch(rb), executor=tx, **kw)
    r = rup.apply_edge_batch(rs, rb, executor=rx, **kw)
    _same_update(t, r)
    assert t.regrown > 0 and not t.rebuilt


def test_rebuild_trigger_matches_reference(tmp_path):
    """Tombstones and appends eat the slack until the rebuild runs
    through the pipeline; its decisions join the batch's."""
    g, rs, ts = _setup("DBP", headroom=0.05, min_slack=1)
    rx, tx = _executors(tmp_path)
    rebuilt = []
    for seed in range(3):
        rb = rup.random_edge_batch(g, 100, 100, seed=seed)
        kw = dict(rebuild_slack_frac=0.3)
        t = tup.apply_edge_batch(ts, _batch(rb), executor=tx, **kw)
        r = rup.apply_edge_batch(rs, rb, executor=rx, **kw)
        _same_update(t, r)
        if t.rebuilt:
            rebuilt.append(seed)
            assert [s.name for s in t.report.stages] == [s.name for s in r.report.stages]
            assert t.report.decisions() == r.report.decisions()
        ts, rs = t.graph, r.graph
    # the first batch exhausts the 5% slack; the re-slack's 25% headroom lasts
    assert rebuilt == [0]
    ts2, rep = tup.rebuild_slack_csr(ts, executor=tx)
    rs2, _ = rup.rebuild_slack_csr(rs, executor=rx)
    _same_slack(ts2, rs2)
    assert rep.variant == "identity"


@pytest.mark.parametrize("n,method", [(4096, None), (4097, None), (20_000, None),
                                      (3000, "counting"), (3000, "sort"), (6000, "counting")])
def test_both_placement_paths_match_reference(tmp_path, n, method):
    """The counting placement at n <= 4096 and the stable argsort above
    it (and forced), on a graph of n vertices and many equal-source
    inserts."""
    rng = np.random.default_rng(n)
    m = 4 * n
    rg = R.COO(jnp.asarray(rng.integers(0, n, m).astype(np.int32)),
               jnp.asarray(rng.integers(0, n, m).astype(np.int32)), n)
    g, rs, ts = _setup(None, graph=rg)
    rx, tx = _executors(tmp_path)
    ins_src = np.concatenate([np.full(40, 7), rng.integers(0, n, 600)]).astype(np.int32)
    b = (ins_src, rng.integers(0, n, ins_src.size).astype(np.int32), np.ones(ins_src.size, bool))
    t = tup.apply_edge_batch(ts, tup.make_batch(*b, device="cpu"), executor=tx, method=method)
    r = rup.apply_edge_batch(rs, rup.make_batch(*b), executor=rx, method=method)
    _same_update(t, r)
    ranks = tup._insert_ranks(torch.from_numpy(ins_src), n, method)
    _eq(ranks, rup._insert_ranks(ins_src, n, method))


# ---------------------------------------------------------------------------
# Incremental kernels after a batch.
# ---------------------------------------------------------------------------


def _post_batch(name, ins, dels, seed):
    g = SUITE[name]
    rb = rup.random_edge_batch(g, ins, dels, seed=seed)
    rc0 = R.build_csr_baseline(g)
    rs = R.SlackCSR.from_csr(rc0)
    rx = rex.PBExecutor(cache_dir=None)
    rs1 = rup.apply_edge_batch(rs, rb, executor=rx).graph
    return g, rb, rc0, rs1.to_csr()


@pytest.mark.parametrize("name", ["DBP", "KRON", "EURO"])
@pytest.mark.parametrize("dels", [0, 20])
def test_bfs_incremental_matches_reference(tmp_path, name, dels):
    g, rb, rc0, rc1 = _post_batch(name, 120, dels, seed=4)
    rx, tx = _executors(tmp_path)
    tc0 = csr_from_numpy(np.asarray(rc0.offsets), np.asarray(rc0.neighs), g.num_nodes, device="cpu")
    tc1 = csr_from_numpy(np.asarray(rc1.offsets), np.asarray(rc1.neighs), g.num_nodes, device="cpu")
    s = int(np.argmax(np.diff(np.asarray(rc0.offsets))))
    rprev = rtrav.bfs(rc0, s, executor=rx, with_parents=False).dist
    tprev = ttrav.bfs(tc0, s, executor=tx, with_parents=False).dist
    _eq(tprev, rprev)
    rt, rdel = rup.touched_vertices(rb)
    tt, tdel = tup.touched_vertices(_batch(rb))
    t, tmode = ttrav.bfs_incremental(tc1, s, tprev, tt, has_deletes=tdel, executor=tx)
    r, rmode = rtrav.bfs_incremental(rc1, s, rprev, rt, has_deletes=rdel, executor=rx)
    assert tmode == rmode == ("full" if dels else "incremental")
    _eq(t.dist, r.dist)
    assert (t.parent is None) == (r.parent is None)
    assert (t.levels, t.converged, t.frontier_sizes, t.level_edges) == (
        r.levels, r.converged, r.frontier_sizes, r.level_edges)
    assert t.decisions == r.decisions
    # and the from-scratch answer on the post-batch graph
    _eq(t.dist, rtrav.bfs(rc1, s, executor=rx).dist)


def test_bfs_incremental_forced_method_and_validation(tmp_path):
    g, rb, rc0, rc1 = _post_batch("URND", 60, 0, seed=9)
    rx, tx = _executors(tmp_path)
    tc1 = csr_from_numpy(np.asarray(rc1.offsets), np.asarray(rc1.neighs), g.num_nodes, device="cpu")
    rprev = rtrav.bfs(rc0, 0, executor=rx).dist
    rt, _ = rup.touched_vertices(rb)
    for method in ("sort", "fused", "unbinned"):
        t, _ = ttrav.bfs_incremental(tc1, 0, torch.from_numpy(np.asarray(rprev)), rt,
                                     executor=tx, method=method)
        r, _ = rtrav.bfs_incremental(rc1, 0, rprev, rt, executor=rx, method=method)
        _eq(t.dist, r.dist)
        assert t.decisions == r.decisions
    with pytest.raises(ValueError, match="source"):
        ttrav.bfs_incremental(tc1, g.num_nodes, torch.from_numpy(np.asarray(rprev)), rt)


@pytest.mark.parametrize("name", ["DBP", "EURO", "HBUBL"])
@pytest.mark.parametrize("dels", [0, 30])
def test_incremental_components_and_pagerank_match_reference(name, dels):
    g, rb, rc0, rc1 = _post_batch(name, 150, dels, seed=6)
    rcoo0, rcoo1 = R.COO(*_coo_arrays(rc0), g.num_nodes), R.COO(*_coo_arrays(rc1), g.num_nodes)
    tcoo0, tcoo1 = _coo(rcoo0), _coo(rcoo1)
    _, has_del = tup.touched_vertices(_batch(rb))
    assert has_del == bool(dels)
    r_prev = R.connected_components_fused(rcoo0)
    t_prev = tcomp.connected_components_fused(tcoo0)
    _eq(t_prev.labels, r_prev.labels)
    t, tmode = tcomp.connected_components_incremental(tcoo1, t_prev.labels, has_deletes=has_del)
    r, rmode = R.connected_components_incremental(rcoo1, r_prev.labels, has_deletes=has_del)
    assert tmode == rmode
    _eq(t.labels, r.labels)
    assert t.iters == r.iters
    _eq(t.labels, R.connected_components_fused(rcoo1).labels)
    tp = tpr.pagerank_incremental(tcoo1, tpr.pagerank_incremental(tcoo0).ranks)
    rp = R.pagerank_incremental(rcoo1, R.pagerank_incremental(rcoo0).ranks)
    np.testing.assert_allclose(to_numpy(tp.ranks), np.asarray(rp.ranks), rtol=PR_RTOL,
                               atol=PR_ATOL)


def _coo_arrays(rc):
    off = np.asarray(rc.offsets)
    src = np.repeat(np.arange(rc.num_nodes), np.diff(off)).astype(np.int32)
    return jnp.asarray(src), rc.neighs


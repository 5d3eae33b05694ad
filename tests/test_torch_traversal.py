"""Traversal and radii parity: ``repro_torch.core.traversal`` / ``radii``
against ``repro.core.traversal`` / ``radii`` on the five smoke graphs.

Both sides get the same CSR (the reference's baseline build) and
executors with the same hardware fields and fresh cache directories.
BFS levels and parents, SSSP distances (one float32 add per tuple, then
an exact ``min``), k-core membership, eccentricities and every per-level
decision (method, bucketed ``stream_len``, level) must be equal;
personalized PageRank sums float32 in another order and agrees within
rtol 1e-5, atol 1e-7 (its ranks are at most 1).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import traversal as rtrav
from repro.core.plan import HardwareModel as RHW
from repro_torch.convert import csr_from_numpy, hardware_from_fields, to_numpy
from repro_torch.core import distributed_pb as tmesh
from repro_torch.core import executor as tex
from repro_torch.core import traversal as ttrav
from repro_torch.core.plan import HardwareModel as THW

tradii = importlib.import_module("repro_torch.core.radii")  # the package exports radii()

GRAPHS = ("DBP", "KRON", "URND", "EURO", "HBUBL")
PPR_RTOL, PPR_ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def graphs():
    """name -> (reference CSR, port CSR on the CPU, numpy weights)."""
    out = {}
    for name, g in R.graph_suite("smoke").items():
        rc = R.build_csr_baseline(g)
        tc = csr_from_numpy(np.asarray(rc.offsets), np.asarray(rc.neighs), rc.num_nodes,
                            device="cpu")
        w = (np.random.default_rng(8).random(rc.num_edges).astype(np.float32) + 0.1)
        out[name] = (rc, tc, w)
    return out


def _executors(tmp_path, which="h100", use_pallas=False):
    t = getattr(THW, which)()
    rhw = RHW(t.name, tuple(t.fast_levels), t.cbuffer_bytes, t.dram_bandwidth, t.fast_bandwidth)
    thw = hardware_from_fields(rhw.name, rhw.fast_levels, rhw.cbuffer_bytes,
                               rhw.dram_bandwidth, rhw.fast_bandwidth)
    return (R.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"), use_pallas=use_pallas),
            tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t"), use_pallas=use_pallas))


def _source(csr) -> int:
    return int(np.argmax(np.diff(np.asarray(csr.offsets))))


def _eq(t, r):
    np.testing.assert_array_equal(to_numpy(t), np.asarray(r))


def _same_run(t, r):
    """Every field of two TraversalResults, exactly."""
    _eq(t.dist, r.dist)
    if r.parent is None:
        assert t.parent is None
    else:
        _eq(t.parent, r.parent)
    assert (t.levels, t.converged, t.frontier_sizes, t.level_edges) == (
        r.levels, r.converged, r.frontier_sizes, r.level_edges)
    assert t.decisions == r.decisions


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000, 4096, 70_000])
@pytest.mark.parametrize("minimum", [1, 256])
def test_bucket_len_matches_reference(n, minimum):
    assert ttrav.bucket_len(n, minimum) == rtrav.bucket_len(n, minimum)


@pytest.mark.parametrize("count", [0, 1, 5, 37])
def test_expand_frontier_matches_reference(graphs, count):
    rc, tc, _ = graphs["KRON"]
    rng = np.random.default_rng(count)
    ids = np.zeros(64, np.int32)
    ids[:count] = rng.choice(rc.num_nodes, count, replace=False)
    be = 4096
    want = rtrav._expand_frontier(rc.offsets, rc.neighs, jnp.asarray(ids), count, be)
    got = ttrav._expand_frontier(tc.offsets, tc.neighs, torch.from_numpy(ids), count, be)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("which", ["h100", "tpu_v5e"])
@pytest.mark.parametrize("with_parents", [True, False])
def test_bfs_matches_reference(tmp_path, graphs, name, which, with_parents):
    rc, tc, _ = graphs[name]
    rx, tx = _executors(tmp_path, which)
    s = _source(rc)
    _same_run(ttrav.bfs(tc, s, executor=tx, with_parents=with_parents),
              rtrav.bfs(rc, s, executor=rx, with_parents=with_parents))


@pytest.mark.parametrize("method", ["sort", "counting", "pallas", "hierarchical", "fused",
                                    "unbinned"])
def test_bfs_forced_methods_match_reference(tmp_path, graphs, method):
    rc, tc, _ = graphs["KRON"]
    rx, tx = _executors(tmp_path)
    s = _source(rc)
    _same_run(ttrav.bfs(tc, s, executor=tx, method=method),
              rtrav.bfs(rc, s, executor=rx, method=method))


@pytest.mark.parametrize("max_iters", [0, 1, 3])
def test_bfs_truncated_matches_reference(tmp_path, graphs, max_iters):
    rc, tc, _ = graphs["URND"]
    rx, tx = _executors(tmp_path)
    s = _source(rc)
    got = ttrav.bfs(tc, s, executor=tx, max_iters=max_iters)
    _same_run(got, rtrav.bfs(rc, s, executor=rx, max_iters=max_iters))
    assert got.converged is False


def test_bfs_from_a_vertex_without_out_edges(tmp_path, graphs):
    rc, tc, _ = graphs["KRON"]
    rx, tx = _executors(tmp_path)
    s = int(np.flatnonzero(np.diff(np.asarray(rc.offsets)) == 0)[0])
    got = ttrav.bfs(tc, s, executor=tx)
    _same_run(got, rtrav.bfs(rc, s, executor=rx))
    assert got.level_edges == (0,) and got.frontier_sizes == (1, 0)


# every graph under the decided method, one graph under forced ones (the
# reference's per-level programs make the road graphs' 50 levels slow)
ONE_GRAPH = "URND"
GRAPH_METHODS = [(g, "auto") for g in GRAPHS]


@pytest.mark.parametrize("name,method", GRAPH_METHODS + [(ONE_GRAPH, "hierarchical"),
                                                       (ONE_GRAPH, "unbinned")])
def test_sssp_matches_reference(tmp_path, graphs, name, method):
    rc, tc, w = graphs[name]
    rx, tx = _executors(tmp_path)
    s = _source(rc)
    _same_run(ttrav.sssp(tc, torch.from_numpy(w), s, executor=tx, method=method),
              rtrav.sssp(rc, jnp.asarray(w), s, executor=rx, method=method))


@pytest.mark.parametrize("name,k", [(g, k) for g in GRAPHS for k in (0, 3)]
                         + [(g, k) for g in ("DBP", "KRON") for k in (2, 5)])
def test_k_core_matches_reference_and_oracle(tmp_path, graphs, name, k):
    rc, tc, _ = graphs[name]
    rx, tx = _executors(tmp_path)
    got = ttrav.k_core(tc, k, executor=tx)
    want = rtrav.k_core(rc, k, executor=rx)
    _eq(got.in_core, want.in_core)
    assert (got.rounds, got.converged, got.removed_per_round, got.decisions) == (
        want.rounds, want.converged, want.removed_per_round, want.decisions)
    oracle = ttrav.k_core_oracle(tc, k)
    np.testing.assert_array_equal(oracle, rtrav.k_core_oracle(rc, k))
    np.testing.assert_array_equal(to_numpy(got.in_core), oracle)


def _lanes(rc, b=4):
    return [int(v) for v in np.argsort(-np.diff(np.asarray(rc.offsets)), kind="stable")[:b]]


@pytest.mark.parametrize("name,method", GRAPH_METHODS + [
    (ONE_GRAPH, m) for m in ("sort", "fused", "unbinned")])
def test_bfs_batched_matches_reference_and_single_runs(tmp_path, graphs, name, method):
    rc, tc, _ = graphs[name]
    rx, tx = _executors(tmp_path)
    srcs = _lanes(rc)
    got = ttrav.bfs_batched(tc, srcs, executor=tx, method=method, with_parents=True)
    _same_run(got, rtrav.bfs_batched(rc, srcs, executor=rx, method=method, with_parents=True))
    for q, s in enumerate(srcs):
        one = ttrav.bfs(tc, s, executor=tx, method=method)
        assert torch.equal(got.dist[q], one.dist) and torch.equal(got.parent[q], one.parent)


@pytest.mark.parametrize("name,method", GRAPH_METHODS + [
    (ONE_GRAPH, m) for m in ("counting", "fused", "unbinned")])
def test_sssp_batched_matches_reference_and_single_runs(tmp_path, graphs, name, method):
    rc, tc, w = graphs[name]
    rx, tx = _executors(tmp_path)
    srcs = _lanes(rc)
    wt = torch.from_numpy(w)
    got = ttrav.sssp_batched(tc, wt, srcs, executor=tx, method=method)
    _same_run(got, rtrav.sssp_batched(rc, jnp.asarray(w), srcs, executor=rx, method=method))
    for q, s in enumerate(srcs):
        assert torch.equal(got.dist[q], ttrav.sssp(tc, wt, s, executor=tx, method=method).dist)


def test_batched_traversal_clamps_like_the_reference(tmp_path, graphs):
    """A decided method outside the batched set clamps to sort under a
    ``+batch-clamp`` tag; on this hardware hierarchical wins KRON's
    2^12-tuple levels."""
    rc, tc, _ = graphs["KRON"]
    small = RHW("tiny", (1024,), 64, 1e9, 1e10)
    rx = R.PBExecutor(hw=small, cache_dir=str(tmp_path / "r"))
    tx = tex.PBExecutor(hw=hardware_from_fields("tiny", (1024,), 64, 1e9, 1e10),
                        cache_dir=str(tmp_path / "t"))
    srcs = _lanes(rc)
    got = ttrav.bfs_batched(tc, srcs, executor=tx)
    _same_run(got, rtrav.bfs_batched(rc, srcs, executor=rx))
    assert any(d["source"].endswith("+batch-clamp") for d in got.decisions)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("sources", [None, "scalar", "array"])
def test_personalized_pagerank_matches_reference(tmp_path, graphs, name, sources):
    rc, tc, _ = graphs[name]
    rx, tx = _executors(tmp_path)
    src = {None: None, "scalar": _source(rc), "array": np.asarray(_lanes(rc, 3))}[sources]
    got = ttrav.personalized_pagerank(tc, src, iters=10, executor=tx)
    want = rtrav.personalized_pagerank(rc, src, iters=10, executor=rx)
    np.testing.assert_allclose(to_numpy(got.ranks), np.asarray(want.ranks),
                               rtol=PPR_RTOL, atol=PPR_ATOL)
    assert got.iters == want.iters and got.decisions == want.decisions
    one = None if sources == "array" else src
    if one is not None or sources is None:
        np.testing.assert_allclose(
            to_numpy(got.ranks), ttrav.personalized_pagerank_oracle(tc, one, iters=10),
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(
            ttrav.personalized_pagerank_oracle(tc, one, iters=10),
            rtrav.personalized_pagerank_oracle(rc, one, iters=10), rtol=1e-12, atol=0)


@pytest.mark.parametrize("method", ["sort", "counting", "fused", "unbinned"])
def test_personalized_pagerank_forced_methods(tmp_path, graphs, method):
    rc, tc, _ = graphs["DBP"]
    rx, tx = _executors(tmp_path)
    srcs = np.asarray(_lanes(rc, 2))
    got = ttrav.personalized_pagerank(tc, srcs, iters=5, executor=tx, method=method)
    want = rtrav.personalized_pagerank(rc, srcs, iters=5, executor=rx, method=method)
    np.testing.assert_allclose(to_numpy(got.ranks), np.asarray(want.ranks),
                               rtol=PPR_RTOL, atol=PPR_ATOL)
    assert got.decisions == want.decisions


@pytest.mark.parametrize("method", ["pallas", "hierarchical"])
def test_personalized_pagerank_rejects_binning_only_methods(graphs, method):
    _, tc, _ = graphs["DBP"]
    with pytest.raises(ValueError, match="supports methods"):
        ttrav.personalized_pagerank(tc, 0, method=method)


@pytest.mark.parametrize("name,k,max_iters", [(g, 4, 300) for g in GRAPHS]
                         + [(ONE_GRAPH, 3, 5), ("EURO", 2, 20)])
def test_radii_from_the_reference_sources(tmp_path, graphs, name, k, max_iters):
    """The reference's jax.random draw cannot be reproduced in torch, so
    the port's helper gets the reference's sources."""
    rc, tc, _ = graphs[name]
    rx, tx = _executors(tmp_path)
    want = R.radii(rc, k=k, max_iters=max_iters, seed=0, executor=rx)
    kk = max(1, min(k, rc.num_nodes))
    sources = np.asarray(jax.random.choice(jax.random.PRNGKey(0), rc.num_nodes, shape=(kk,),
                                           replace=False))
    got = tradii._radii_from_sources(tc, sources, max_iters, executor=tx)
    _eq(got.ecc, want.ecc)
    assert got.iters == int(want.iters) and got.converged == bool(want.converged)
    assert got.decisions == want.decisions


def _path_csrs(n=6):
    """A directed path 0 -> 1 -> ... -> n-1 in both frameworks."""
    off = np.concatenate([np.arange(n), [n - 1]]).astype(np.int32)
    nei = np.arange(1, n, dtype=np.int32)
    return R.CSR(jnp.asarray(off), jnp.asarray(nei), n), csr_from_numpy(off, nei, n, device="cpu")


def test_radii_draws_seeded_distinct_sources(tmp_path):
    rc, tc = _path_csrs()
    a = tradii.radii(tc, k=4, seed=3)
    b = tradii.radii(tc, k=4, seed=3)
    assert torch.equal(a.ecc, b.ecc) and a.decisions == b.decisions
    rx, tx = _executors(tmp_path)
    got = tradii.radii(tc, k=100, executor=tx)  # k is clamped to the vertex count
    want = R.radii(rc, k=100, executor=rx)
    assert sorted(got.ecc.tolist()) == sorted(np.asarray(want.ecc).tolist()) == [0, 1, 2, 3, 4, 5]
    assert got.iters == int(want.iters) == 6 and got.converged and bool(want.converged)


def test_traversal_errors(graphs, tmp_path):
    _, tc, w = graphs["URND"]
    n = tc.num_nodes
    wt = torch.from_numpy(w)
    for bad in (-1, n):
        with pytest.raises(ValueError, match="outside"):
            ttrav.bfs(tc, bad)
        with pytest.raises(ValueError, match="outside"):
            ttrav.sssp(tc, wt, bad)
        with pytest.raises(ValueError, match="outside"):
            ttrav.bfs_batched(tc, [0, bad])
    with pytest.raises(ValueError, match="unknown traversal method"):
        ttrav.bfs(tc, 0, method="magic")
    with pytest.raises(ValueError, match="unknown batched traversal method"):
        ttrav.sssp_batched(tc, wt, [0], method="hierarchical")
    with pytest.raises(ValueError, match="align"):
        ttrav.sssp(tc, wt[:-1], 0)
    with pytest.raises(ValueError, match="align"):
        ttrav.sssp_batched(tc, wt[:-1], [0])
    with pytest.raises(ValueError, match="k must be"):
        ttrav.k_core(tc, -1)
    with pytest.raises(ValueError, match="iters"):
        ttrav.personalized_pagerank(tc, 0, iters=0)
    with pytest.raises(ValueError, match="at least one source"):
        ttrav.bfs_batched(tc, [])
    # a mesh is taken now: on one rank every level is the single-device
    # reduce, as in the reference (more ranks: test_torch_sharded.py)
    rc, _, _ = graphs["URND"]
    rx, tx = _executors(tmp_path)
    tm, rm = tmesh.make_stream_mesh(1, device="cpu"), R.make_stream_mesh(1)
    got, want = ttrav.bfs(tc, 0, executor=tx, mesh=tm), rtrav.bfs(rc, 0, executor=rx, mesh=rm)
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    np.testing.assert_array_equal(to_numpy(got.parent), np.asarray(want.parent))
    got = ttrav.sssp(tc, wt, 0, executor=tx, mesh=tm)
    want = rtrav.sssp(rc, jnp.asarray(w), 0, executor=rx, mesh=rm)
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    got, want = ttrav.k_core(tc, 2, executor=tx, mesh=tm), rtrav.k_core(rc, 2, executor=rx, mesh=rm)
    np.testing.assert_array_equal(to_numpy(got.in_core), np.asarray(want.in_core))
    got = tradii._radii_from_sources(tc, [3, 17], executor=tx, mesh=tm)
    assert torch.equal(got.ecc, tradii._radii_from_sources(tc, [3, 17], executor=tx).ecc)
    assert tradii.radii(tc, k=2, executor=tx, mesh=tm).converged

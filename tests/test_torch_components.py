"""Connected-components parity: ``repro_torch.core.components`` against
``repro.core.components`` on the five smoke graphs.

int32 ``min`` is exact in every method, so labels must be equal and the
host loop must run as many rounds (``iters``) as the reference's
``while_loop``, also when ``max_iters`` cuts it short. Each side uses a
default executor with a fresh cache directory (the reference's TPU
model, the port's H100 model: at 1024 vertices both decide ``fused``).
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import components as RC
from repro_torch.convert import coo_from_numpy, to_numpy
from repro_torch.core import components as TC

GRAPHS = ("DBP", "KRON", "URND", "EURO", "HBUBL")


@pytest.fixture(scope="module", autouse=True)
def fresh_executors(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache")
    R.set_default_executor(R.PBExecutor(cache_dir=str(d / "r")))
    T.set_default_executor(T.PBExecutor(cache_dir=str(d / "t")))
    yield
    R.set_default_executor(None)
    T.set_default_executor(None)


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, g in R.graph_suite("smoke").items():
        tg = coo_from_numpy(np.asarray(g.src), np.asarray(g.dst), g.num_nodes, device="cpu")
        out[name] = (g, tg)
    return out


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got.labels), np.asarray(want.labels))
    assert isinstance(got.iters, int) and got.iters == int(want.iters)


def _min_vertex_labels(g) -> np.ndarray:
    """scipy's weak components, each labelled with its smallest vertex."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    s, d, n = np.asarray(g.src), np.asarray(g.dst), g.num_nodes
    _, comp = connected_components(sp.csr_matrix((np.ones(s.size), (s, d)), shape=(n, n)),
                                   directed=True, connection="weak")
    first = np.full(comp.max() + 1, n)
    np.minimum.at(first, comp, np.arange(n))
    return first[comp]


@pytest.mark.parametrize("name", GRAPHS)
def test_connected_components_baseline_matches_reference(graphs, name):
    g, tg = graphs[name]
    got = T.connected_components(tg)
    _same(got, R.connected_components(g))
    np.testing.assert_array_equal(to_numpy(got.labels), _min_vertex_labels(g))


# every graph under the decided method; forced methods on the two graphs of
# short label diameter (the road graphs' 50 rounds of the reference's
# interpret-mode kernels take 10-20 s a case)
FORCED = ("sort", "counting", "pallas", "hierarchical", "fused")


@pytest.mark.parametrize("name,method", [(g, None) for g in GRAPHS]
                         + [(g, m) for g in ("KRON", "URND") for m in FORCED])
def test_connected_components_fused_matches_reference(graphs, name, method):
    g, tg = graphs[name]
    _same(T.connected_components_fused(tg, method=method),
          R.connected_components_fused(g, method=method))


@pytest.mark.parametrize("name,method,bin_range", [(g, None, 1 << 14) for g in GRAPHS] + [
    (g, m, r) for g in ("KRON", "URND")
    for m, r in (("sort", 64), ("counting", 100), ("pallas", 64), ("hierarchical", 32))])
def test_connected_components_pb_matches_reference(graphs, name, method, bin_range):
    g, tg = graphs[name]
    _same(TC.connected_components_pb(tg, bin_range=bin_range, method=method),
          RC.connected_components_pb(g, bin_range=bin_range, method=method))


@pytest.mark.parametrize("name", ["KRON", "EURO"])
@pytest.mark.parametrize("max_iters", [0, 1, 3])
def test_truncated_rounds_match_reference(graphs, name, max_iters):
    g, tg = graphs[name]
    _same(T.connected_components(tg, max_iters=max_iters),
          R.connected_components(g, max_iters=max_iters))
    _same(T.connected_components_fused(tg, max_iters=max_iters),
          R.connected_components_fused(g, max_iters=max_iters))
    _same(TC.connected_components_pb(tg, max_iters=max_iters),
          RC.connected_components_pb(g, max_iters=max_iters))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("has_deletes", [False, True])
def test_connected_components_incremental_matches_reference(graphs, name, has_deletes):
    """The labels of the first half of the edges warm-start the whole
    edge list; the result is the from-scratch labelling either way."""
    g, tg = graphs[name]
    half = g.num_edges // 2
    before = R.connected_components_fused(R.COO(g.src[:half], g.dst[:half], g.num_nodes))
    want, wmode = R.connected_components_incremental(g, before.labels, has_deletes=has_deletes)
    tbefore = T.connected_components_fused(T.COO(tg.src[:half], tg.dst[:half], tg.num_nodes))
    _same(tbefore, before)
    got, mode = T.connected_components_incremental(
        tg, tbefore.labels, has_deletes=has_deletes)
    assert mode == wmode == ("full" if has_deletes else "incremental")
    _same(got, want)
    np.testing.assert_array_equal(to_numpy(got.labels), _min_vertex_labels(g))


def test_incremental_takes_labels_as_numpy(graphs):
    g, tg = graphs["URND"]
    labels = np.arange(g.num_nodes, dtype=np.int64)
    got, _ = T.connected_components_incremental(tg, labels)
    want, _ = R.connected_components_incremental(g, labels.astype(np.int32))
    _same(got, want)
    assert got.labels.dtype == torch.int32


def test_sharded_without_a_mesh_is_fused_and_a_mesh_raises(graphs):
    """Without a mesh and on a one-rank mesh the sharded entry point is the
    fused one, as in the reference; a mesh no longer raises (more ranks:
    ``test_torch_sharded.py``)."""
    g, tg = graphs["KRON"]
    _same(T.connected_components_sharded(tg), R.connected_components_sharded(g))
    _same(T.connected_components_sharded(tg, mesh=T.make_stream_mesh(1, device="cpu")),
          R.connected_components_sharded(g, mesh=R.make_stream_mesh(1)))


@pytest.mark.parametrize("n,edges", [(1, []), (4, []), (5, [(0, 0), (3, 3)]),
                                     (6, [(5, 0), (4, 1), (1, 5)])])
def test_degenerate_graphs(n, edges):
    s = np.asarray([e[0] for e in edges], np.int32)
    d = np.asarray([e[1] for e in edges], np.int32)
    import jax.numpy as jnp

    rg = R.COO(jnp.asarray(s), jnp.asarray(d), n)
    tg = coo_from_numpy(s, d, n, device="cpu")
    for tf, rf in ((T.connected_components, R.connected_components),
                   (T.connected_components_fused, R.connected_components_fused),
                   (TC.connected_components_pb, RC.connected_components_pb)):
        _same(tf(tg), rf(rg))

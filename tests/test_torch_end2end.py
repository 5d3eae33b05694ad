"""The slice end to end on the five smoke graphs, port against reference.

CSR and CSC builds are stable and must be identical. PageRank ranks are
float32 sums whose order may differ between the two frameworks, so they
agree within rtol 1e-5 / atol 1e-9 (observed differences are a few ulp);
``pagerank_incremental`` must run the same number of rounds. The
``use_pallas=True`` executor routes PB binning through the kernel-backed
method and must give identical CSRs and, on the CPU, identical ranks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.convert import to_numpy

GRAPHS = ("DBP", "KRON", "URND", "EURO", "HBUBL")
RTOL, ATOL = 1e-5, 1e-9


@pytest.fixture(scope="module", autouse=True)
def fresh_executors(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache")
    R.set_default_executor(R.PBExecutor(cache_dir=str(d / "r")))
    T.set_default_executor(T.PBExecutor(cache_dir=str(d / "t")))
    yield
    R.set_default_executor(None)
    T.set_default_executor(None)


@pytest.fixture(scope="module")
def suites():
    return R.graph_suite("smoke"), T.graph_suite("smoke", device="cpu")


def _csr_eq(t, r):
    assert t.num_nodes == r.num_nodes
    np.testing.assert_array_equal(to_numpy(t.offsets), np.asarray(r.offsets))
    np.testing.assert_array_equal(to_numpy(t.neighs), np.asarray(r.neighs))


BUILDS = {
    "oracle": (R.build_csr_oracle, T.build_csr_oracle),
    "baseline": (R.build_csr_baseline, T.build_csr_baseline),
    "pb_sort": (lambda g: R.build_csr_pb(g, 64), lambda g: T.build_csr_pb(g, 64)),
    "pb_counting": (
        lambda g: R.build_csr_pb(g, 64, method="counting"),
        lambda g: T.build_csr_pb(g, 64, method="counting"),
    ),
    "pb_pallas": (
        lambda g: R.build_csr_pb(g, 64, method="pallas"),
        lambda g: T.build_csr_pb(g, 64, method="pallas"),
    ),
    "pb_auto": (lambda g: R.build_csr_pb(g, method="auto"), lambda g: T.build_csr_pb(g, method="auto")),
    "cobra": (R.build_csr_cobra, T.build_csr_cobra),
    "build_csr_cobra_r32": (
        lambda g: R.build_csr(g, method="cobra", bin_range=32),
        lambda g: T.build_csr(g, method="cobra", bin_range=32),
    ),
    "csc_auto": (R.build_csc, T.build_csc),
}


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_builds_identical_to_reference(suites, name, build):
    rf, tf = BUILDS[build]
    _csr_eq(tf(suites[1][name]), rf(suites[0][name]))


@pytest.mark.parametrize("name", GRAPHS)
def test_csr_csc_pair_and_set_equality(suites, name):
    r, t = suites[0][name], suites[1][name]
    (tc, tt), (rc, rt) = T.build_csr_csc(t), R.build_csr_csc(r)
    _csr_eq(tc, rc)
    _csr_eq(tt, rt)
    assert T.csr_equal_as_sets(tc, T.build_csr_baseline(t))
    # the sharded build: the auto PB build without a mesh and on one rank
    # (more ranks: test_torch_sharded.py)
    _csr_eq(T.build_csr(t, method="sharded"), R.build_csr(r, method="sharded"))
    (sc, st) = T.build_csr_csc(t, method="sharded", mesh=T.make_stream_mesh(1, device="cpu"))
    (rsc, rst) = R.build_csr_csc(r, method="sharded", mesh=R.make_stream_mesh(1))
    _csr_eq(sc, rsc)
    _csr_eq(st, rst)


def _arms(mod, g, br, plan):
    """fig5's arms A-E through the normal entry points."""
    outdeg = mod.degrees_from_coo(g, by="src")
    return {
        "A": mod.pagerank_coo_scatter(g, iters=10).ranks,
        "B": mod.pagerank_csr_pull(mod.build_csr_baseline(mod.transpose_coo(g)), outdeg, iters=10).ranks,
        "C": mod.pagerank_pb(g, iters=10, bin_range=br).ranks,
        "D": mod.pagerank_pb(g, iters=10, bin_range=plan.final_bin_range).ranks,
        "E": mod.pagerank_fused(g, iters=10).ranks,
    }


@pytest.mark.parametrize("name", GRAPHS)
def test_pagerank_arms_within_tolerance(suites, name):
    r, t = suites[0][name], suites[1][name]
    n = t.num_nodes
    br = min(max(64, T.compromise_bin_range(n, T.HardwareModel.h100())), n)
    rp = R.CobraPlan.from_hardware(n)
    tp = T.CobraPlan.from_hardware(n)
    ra, ta = _arms(R, r, br, rp), _arms(T, t, br, tp)
    for arm in "ABCDE":
        np.testing.assert_allclose(to_numpy(ta[arm]), np.asarray(ra[arm]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(to_numpy(ta[arm]), to_numpy(ta["B"]), rtol=1e-4, atol=1e-8)
    for method in ("sort", "hierarchical"):
        np.testing.assert_allclose(
            to_numpy(T.pagerank_fused(t, method=method).ranks),
            np.asarray(R.pagerank_fused(r, method=method).ranks), rtol=RTOL, atol=ATOL,
        )


@pytest.mark.parametrize("name", GRAPHS)
def test_pagerank_incremental_same_rounds(suites, name):
    r, t = suites[0][name], suites[1][name]
    rc, tc = R.pagerank_incremental(r), T.pagerank_incremental(t)
    assert tc.iters == rc.iters
    np.testing.assert_allclose(to_numpy(tc.ranks), np.asarray(rc.ranks), rtol=RTOL, atol=ATOL)
    # warm start from five cold rounds (the same numbers on both sides)
    warm = np.asarray(R.pagerank_coo_scatter(r, iters=5).ranks)
    rw = R.pagerank_incremental(r, jnp.asarray(warm))
    tw = T.pagerank_incremental(t, torch.from_numpy(warm))
    assert tw.iters == rw.iters < rc.iters


def test_use_pallas_executor_gives_identical_results(suites, tmp_path):
    t = suites[1]["KRON"]
    n = t.num_nodes
    base = {
        "csr": T.build_csr_pb(T.transpose_coo(t), 64),
        "bins": T.pb_bin_edges(t, 64),
        "C": T.pagerank_pb(t, bin_range=64).ranks,
        "E": T.pagerank_fused(t).ranks,
    }
    old = T.get_default_executor()
    ex = T.PBExecutor(cache_dir=str(tmp_path), use_pallas=True)
    T.set_default_executor(ex)
    try:
        got = {
            "csr": T.build_csr_pb(T.transpose_coo(t), 64),
            "bins": T.pb_bin_edges(t, 64),
            "C": T.pagerank_pb(t, bin_range=64).ranks,
            "E": T.pagerank_fused(t).ranks,
        }
        forced = T.build_csr_pb(t, 64, method="pallas")
    finally:
        T.set_default_executor(old)
    assert any(e["method"] == "pallas" for e in ex.decision_log)
    for a, b in ((got["csr"].offsets, base["csr"].offsets), (got["csr"].neighs, base["csr"].neighs)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got["bins"], base["bins"]))
    assert torch.equal(got["C"], base["C"]) and torch.equal(got["E"], base["E"])
    assert T.csr_equal_as_sets(forced, T.build_csr_baseline(t)) and n == forced.num_nodes

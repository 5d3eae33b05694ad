"""Preprocessing parity: ``repro_torch.core`` reorder, SlackCSR, traffic
and ``PreprocessPipeline`` against ``repro.core`` on the smoke graphs.

Mappings, relabelled Edgelists, CSR/CSC layouts, slack slabs, modeled
bytes and the decision records of every stage must be equal. Two
variants cannot be: ``random`` draws from a torch generator (checked as a
seeded permutation, then the reference's draw is fed to the port's
relabel and build), and ``dbg``, whose bucket the port computes exactly
where the reference's float32 ``log2`` rounds below the integer at
degrees 8191 and 32767 and above it just under 2^k - 1 for k >= 21
(pinned below).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import reorder as rre
from repro.core import traffic as rtraffic
from repro.core.plan import HardwareModel as RHW
from repro_torch.convert import coo_from_numpy, csr_from_numpy, hardware_from_fields, to_numpy
from repro_torch.core import distributed_pb as tmesh
from repro_torch.core import executor as tex
from repro_torch.core import graph as tgraph
from repro_torch.core import preprocess as tpre
from repro_torch.core import reorder as tre
from repro_torch.core import traffic as ttraffic
from repro_torch.core.neighbor_populate import build_csr, build_slack_csr
from repro_torch.core.plan import HardwareModel as THW

GRAPHS = ("DBP", "KRON", "URND", "EURO", "HBUBL")
EXACT_VARIANTS = ("identity", "degree_sort", "hub_sort", "dbg")
SUITE = R.graph_suite("smoke")


def _coo(name):
    g = SUITE[name]
    return g, coo_from_numpy(np.asarray(g.src), np.asarray(g.dst), g.num_nodes, device="cpu")


def _csr(rc):
    return csr_from_numpy(np.asarray(rc.offsets), np.asarray(rc.neighs), rc.num_nodes,
                          device="cpu")


def _executors(tmp_path, which="h100"):
    t = getattr(THW, which)()
    rhw = RHW(t.name, tuple(t.fast_levels), t.cbuffer_bytes, t.dram_bandwidth, t.fast_bandwidth)
    thw = hardware_from_fields(rhw.name, rhw.fast_levels, rhw.cbuffer_bytes,
                               rhw.dram_bandwidth, rhw.fast_bandwidth)
    return (R.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r")),
            tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t")))


def _eq(t, r):
    a, b = to_numpy(t), np.asarray(r)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_csr(t, r):
    assert t.num_nodes == r.num_nodes
    _eq(t.offsets, r.offsets)
    _eq(t.neighs, r.neighs)


def _degrees(g):
    return np.bincount(np.asarray(g.src), minlength=g.num_nodes).astype(np.int32)


# ---------------------------------------------------------------------------
# Reorder variants.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("variant", EXACT_VARIANTS)
def test_reorder_variants_match_reference(name, variant):
    g, tc = _coo(name)
    deg = _degrees(g)
    want = rre.REORDER_VARIANTS[variant](jnp.asarray(deg), g.num_nodes, 0)
    _eq(tre.REORDER_VARIANTS[variant](torch.from_numpy(deg), g.num_nodes, 0), want)
    # through the executor's degree count
    _eq(tre.reorder_mapping(variant, tc.src, g.num_nodes),
        rre.reorder_mapping(variant, g.src, g.num_nodes))


def test_hub_sort_and_dbg_on_ties_and_zero_degrees():
    """Equal degrees, isolated vertices and one hub: stable order on both."""
    deg = np.asarray([0, 3, 3, 0, 9, 1, 1, 2, 0, 3, 7, 7], np.int32)
    for v in EXACT_VARIANTS:
        _eq(tre.REORDER_VARIANTS[v](torch.from_numpy(deg), deg.size, 0),
            rre.REORDER_VARIANTS[v](jnp.asarray(deg), deg.size, 0))


def _ref_dbg_bucket(deg):
    """The reference's bucket, its expression in ``_dbg_ids``."""
    return np.asarray(jnp.int32(jnp.floor(jnp.log2(jnp.asarray(deg).astype(jnp.float32) + 1.0))))


def test_dbg_bucket_is_exact_and_the_reference_differs_at_three_degrees():
    """Over degrees 0 .. 2^21 - 1 the port's bucket is the integer
    floor(log2(deg + 1)); the reference's float32 log2 falls one bucket
    short at exactly 8191 and 32767 and one bucket over at 2^21 - 2
    (log2 of 2^21 - 1 rounds to 21 in float32)."""
    deg = np.arange(1 << 21, dtype=np.int32)
    got = to_numpy(tre.dbg_bucket(torch.from_numpy(deg)))
    exact = np.asarray([(d + 1).bit_length() - 1 for d in range(1 << 21)], np.int64)
    np.testing.assert_array_equal(got, exact)
    ref = _ref_dbg_bucket(deg)
    assert sorted(np.flatnonzero(ref != got).tolist()) == [8191, 32767, (1 << 21) - 2]
    np.testing.assert_array_equal(ref[[8191, 32767, (1 << 21) - 2]] - got[[8191, 32767, (1 << 21) - 2]],
                                  [-1, -1, 1])


@pytest.mark.parametrize("k", [22, 23, 24])
def test_dbg_bucket_above_2_to_the_21(k):
    """Past 2^21 the reference's float32 log2 rounds a run of degrees just
    below 2^k - 1 up to bucket k; the port stays exact."""
    deg = np.arange((1 << k) - 40, (1 << k) + 40, dtype=np.int32)
    got = to_numpy(tre.dbg_bucket(torch.from_numpy(deg)))
    np.testing.assert_array_equal(got, [(int(d) + 1).bit_length() - 1 for d in deg])
    over = deg[_ref_dbg_bucket(deg) != got]
    assert over.size and (over < (1 << k) - 1).all() and (over >= (1 << k) - 17).all()


@pytest.mark.parametrize("pinned", [8191, 32767])
def test_dbg_mapping_diverges_only_at_the_pinned_degrees(pinned):
    """A vertex of the pinned degree: the reference files it one bucket
    low, behind the vertex of degree ``pinned - 1``'s bucket peers; with
    the degree one lower or higher, the mappings are equal."""
    base = np.asarray([5, 0, 40, 3, 1, 17, 2], np.int32)
    for d, equal in ((pinned - 1, True), (pinned, False), (pinned + 1, True)):
        deg = np.concatenate([base, [pinned // 2 + 1, d]]).astype(np.int32)
        got = to_numpy(tre.REORDER_VARIANTS["dbg"](torch.from_numpy(deg), deg.size, 0))
        want = np.asarray(rre.REORDER_VARIANTS["dbg"](jnp.asarray(deg), deg.size, 0))
        assert np.array_equal(got, want) == equal, (d, got, want)
        if d == pinned:  # the port's vertex of that degree leads, alone in its bucket
            assert got[-1] == 0 and want[-1] == 1


@pytest.mark.parametrize("seed", [0, 5])
def test_random_variant_is_a_seeded_permutation(seed):
    n = 1000
    deg = torch.zeros(n, dtype=torch.int32)
    a = tre.REORDER_VARIANTS["random"](deg, n, seed)
    b = tre.REORDER_VARIANTS["random"](deg, n, seed)
    c = tre.REORDER_VARIANTS["random"](deg, n, seed + 1)
    assert a.dtype == torch.int32
    assert torch.equal(torch.sort(a).values, torch.arange(n, dtype=torch.int32))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["DBP", "EURO"])
def test_reference_random_draw_through_the_ports_relabel_and_build(name):
    g, tc = _coo(name)
    ids = rre.reorder_mapping("random", g.src, g.num_nodes, seed=3)
    rl = rre.relabel_coo(g, ids)
    tl = tre.relabel_coo(tc, torch.from_numpy(np.asarray(ids)))
    _eq(tl.src, rl.src)
    _eq(tl.dst, rl.dst)
    _same_csr(build_csr(tl, method="baseline"), R.build_csr(rl, method="baseline"))


def test_unknown_variant_is_rejected():
    with pytest.raises(ValueError, match="unknown reorder variant"):
        tre.reorder_mapping("nope", torch.zeros(3, dtype=torch.int32), 3)


@pytest.mark.parametrize("method", ["baseline", "pb", "cobra", "auto"])
@pytest.mark.parametrize("variant", EXACT_VARIANTS)
def test_reorder_rebuild_matches_reference(method, variant):
    g, tc = _coo("KRON")
    tcsr, tids = tre.reorder_rebuild(tc, variant, method=method)
    rcsr, rids = rre.reorder_rebuild(g, variant, method=method)
    _eq(tids, rids)
    _same_csr(tcsr, rcsr)


def test_degree_sort_entry_points_match_reference():
    g, tc = _coo("DBP")
    _eq(tre.degree_sort_mapping(tc.src, g.num_nodes), rre.degree_sort_mapping(g.src, g.num_nodes))
    tcsr, tids = tre.degree_sort_rebuild(tc)
    rcsr, rids = rre.degree_sort_rebuild(g)
    _eq(tids, rids)
    _same_csr(tcsr, rcsr)


# ---------------------------------------------------------------------------
# SlackCSR.
# ---------------------------------------------------------------------------


def _same_slack(t, r):
    for f in ("offsets", "neighs", "counts"):
        _eq(getattr(t, f), getattr(r, f))
    assert t.num_nodes == r.num_nodes
    assert (t.capacity, t.num_occupied, t.num_edges) == (r.capacity, r.num_occupied, r.num_edges)
    assert t.slack_fraction == r.slack_fraction
    _eq(t.live_degrees(), r.live_degrees())


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("headroom,min_slack", [(0.25, 4), (0.0, 0), (1.0, 1), (0.1, 0)])
def test_slack_csr_round_trip_and_fields(name, headroom, min_slack):
    g, _ = _coo(name)
    rc = R.build_csr_baseline(g)
    r = R.SlackCSR.from_csr(rc, headroom=headroom, min_slack=min_slack)
    t = tgraph.SlackCSR.from_csr(_csr(rc), headroom=headroom, min_slack=min_slack)
    _same_slack(t, r)
    _same_csr(t.to_csr(), rc)  # from_csr(c).to_csr() == c
    _same_csr(t.to_csr(), r.to_csr())
    tco, rco = t.to_coo(), r.to_coo()
    _eq(tco.src, rco.src)
    _eq(tco.dst, rco.dst)


@pytest.mark.parametrize("name", ["KRON", "HBUBL"])
def test_slack_csr_with_tombstones_matches_reference(name):
    """Tombstoned occupied slots are dropped by every view, on both sides."""
    g, _ = _coo(name)
    rc = R.build_csr_baseline(g)
    r = R.SlackCSR.from_csr(rc)
    nei = np.asarray(r.neighs).copy()
    occ = np.flatnonzero(nei != R.TOMBSTONE)
    nei[np.random.default_rng(4).choice(occ, occ.size // 7, replace=False)] = R.TOMBSTONE
    r = r._replace(neighs=jnp.asarray(nei))
    t = tgraph.SlackCSR(torch.from_numpy(np.asarray(r.offsets)), torch.from_numpy(nei),
                        torch.from_numpy(np.asarray(r.counts)), r.num_nodes)
    _same_slack(t, r)
    _same_csr(t.to_csr(), r.to_csr())
    _eq(t.to_coo().src, r.to_coo().src)
    assert tgraph.TOMBSTONE == R.TOMBSTONE


@pytest.mark.parametrize("method", ["auto", "baseline", "cobra"])
def test_build_slack_csr_matches_reference(method):
    g, tc = _coo("KRON")
    _same_slack(build_slack_csr(tc, headroom=0.5, min_slack=2, method=method),
                R.build_slack_csr(g, headroom=0.5, min_slack=2, method=method))


def test_slack_csr_rejects_negative_headroom():
    c = tgraph.CSR(torch.zeros(2, dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="headroom"):
        tgraph.SlackCSR.from_csr(c, headroom=-0.1)
    with pytest.raises(ValueError, match="min_slack"):
        tgraph.SlackCSR.from_csr(c, min_slack=-1)


def test_empty_slack_csr():
    c = tgraph.CSR(torch.zeros(4, dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 3)
    t = tgraph.SlackCSR.from_csr(c, headroom=0.0, min_slack=0)
    assert t.capacity == 0 and t.slack_fraction == 1.0 and t.num_edges == 0
    _eq(t.to_csr().offsets, np.zeros(4, np.int32))


# ---------------------------------------------------------------------------
# Modeled stage bytes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", ["degrees", "mapping", "relabel", "build_csr", "build_csc",
                                   "slack"])
@pytest.mark.parametrize("build_method", ["pb", "baseline"])
@pytest.mark.parametrize("m,n", [(0, 1), (4096, 1024), (33_554_432, 4_194_304)])
def test_preproc_stage_bytes_match_reference(stage, build_method, m, n):
    assert ttraffic.preproc_stage_bytes(stage, m, n, build_method=build_method) == \
        rtraffic.preproc_stage_bytes(stage, m, n, build_method=build_method)


def test_preproc_stage_bytes_rejects_unknown_stage():
    with pytest.raises(ValueError, match="unknown preprocess stage"):
        ttraffic.preproc_stage_bytes("sort", 1, 1)


# ---------------------------------------------------------------------------
# The pipeline.
# ---------------------------------------------------------------------------


def _same_run(t, r, variant=True):
    _same_csr(t.csr, r.csr)
    if r.csc is None:
        assert t.csc is None
    else:
        _same_csr(t.csc, r.csc)
    _eq(t.degrees, r.degrees)
    if variant:
        _eq(t.new_ids, r.new_ids)
    if r.slack is None:
        assert t.slack is None
    else:
        _same_slack(t.slack, r.slack)
    tr, rr = t.report, r.report
    assert (tr.variant, tr.build_method, tr.num_nodes, tr.num_edges, tr.sharded) == (
        rr.variant, rr.build_method, rr.num_nodes, rr.num_edges, rr.sharded)
    assert [s.name for s in tr.stages] == [s.name for s in rr.stages]
    assert [s.modeled_bytes for s in tr.stages] == [s.modeled_bytes for s in rr.stages]
    assert tr.total_modeled_bytes == rr.total_modeled_bytes
    assert [s.decisions for s in tr.stages] == [s.decisions for s in rr.stages]
    assert tr.decisions() == rr.decisions()


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("variant", EXACT_VARIANTS)
def test_pipeline_matches_reference(tmp_path, name, variant):
    g, tc = _coo(name)
    rx, tx = _executors(tmp_path)
    kw = dict(variant=variant, slack_headroom=0.25)
    t = tpre.PreprocessPipeline(executor=tx, **kw).run(tc)
    r = R.PreprocessPipeline(executor=rx, **kw).run(g)
    _same_run(t, r)
    assert all(s.compile_seconds > 0 for s in t.report.stages)


@pytest.mark.parametrize("build_method", ["baseline", "pb", "cobra", "auto"])
@pytest.mark.parametrize("which", ["h100", "tpu_v5e", "cpu_xeon"])
def test_pipeline_build_methods_and_models_match_reference(tmp_path, build_method, which):
    g, tc = _coo("KRON")
    rx, tx = _executors(tmp_path, which)
    kw = dict(build_method=build_method, with_csc=build_method != "cobra", warmup=False)
    t = tpre.PreprocessPipeline(executor=tx, **kw).run(tc)
    r = R.PreprocessPipeline(executor=rx, **kw).run(g)
    _same_run(t, r)
    assert all(s.compile_seconds == 0.0 for s in t.report.stages)


def test_pipeline_random_variant_is_a_relabelled_build(tmp_path):
    """``random``'s draw differs from the reference's; everything after
    the mapping is the build of the relabelled Edgelist."""
    g, tc = _coo("URND")
    _, tx = _executors(tmp_path)
    t = tpre.PreprocessPipeline("random", executor=tx, seed=2, with_csc=False).run(tc)
    ids = t.new_ids
    assert torch.equal(torch.sort(ids).values, torch.arange(g.num_nodes, dtype=torch.int32))
    want = R.build_csr(rre.relabel_coo(g, jnp.asarray(to_numpy(ids))), method="baseline")
    _same_csr(t.csr, want)


def test_report_views(tmp_path):
    g, tc = _coo("EURO")
    rx, tx = _executors(tmp_path)
    t = tpre.PreprocessPipeline(executor=tx, slack_headroom=0.5).run(tc).report
    r = R.PreprocessPipeline(executor=rx, slack_headroom=0.5).run(g).report
    td, rd = t.as_dict(), r.as_dict()
    for d in (td, rd):
        d.pop("total_seconds")
        for s in d["stages"]:
            s.pop("seconds")
            s.pop("compile_seconds")
    assert td == rd
    assert t.stage("slack").modeled_bytes == r.stage("slack").modeled_bytes
    assert t.total_seconds == pytest.approx(sum(s.seconds for s in t.stages))
    assert t.total_compile_seconds == pytest.approx(sum(s.compile_seconds for s in t.stages))
    assert t.stage("degrees").describe().startswith("degrees: ")
    with pytest.raises(KeyError):
        t.stage("nope")


def test_pipeline_rejects_bad_arguments(tmp_path):
    # a mesh is taken now: on one rank the sharded stages are the
    # single-device ones, as in the reference (more ranks:
    # test_torch_sharded.py)
    g, tc = _coo("KRON")
    rx, tx = _executors(tmp_path)
    t = tpre.PreprocessPipeline(executor=tx, warmup=False,
                                mesh=tmesh.make_stream_mesh(1, device="cpu")).run(tc)
    r = R.PreprocessPipeline(executor=rx, warmup=False, mesh=R.make_stream_mesh(1)).run(g)
    _same_run(t, r)
    assert t.report.sharded and t.report.build_method == "sharded"
    with pytest.raises(ValueError, match="unknown reorder variant"):
        tpre.PreprocessPipeline("nope")
    with pytest.raises(ValueError, match="unknown build method"):
        tpre.PreprocessPipeline(build_method="nope")
    with pytest.raises(ValueError, match="slack_headroom"):
        tpre.PreprocessPipeline(slack_headroom=-1.0)


@pytest.mark.parametrize("args", [(10.0, 2.0, 1.0), (10.0, 1.0, 1.0), (3.0, 1.0, 2.0),
                                  (0.0, 0.5, 0.25)])
def test_amortization_iters_matches_reference(args):
    assert tpre.amortization_iters(*args) == R.amortization_iters(*args)

"""Sharded PB parity: ``repro_torch.core.distributed_pb`` and its graph
consumers against ``repro.core`` (mirrors ``tests/test_sharded.py`` case
for case; the LM side, ``moe_combine_sharded`` among it, is held in
``test_torch_mesh_train.py``).

The reference runs once, in a subprocess with 8 forced host devices; the
port runs in gloo groups of 1, 2, 4 and 8 spawned CPU ranks
(``torch_sharded_harness``), every rank on the same global inputs, and
every rank must return the same whole result. Tolerances: integer ops,
min, max, CSRs, labels, levels and SSSP distances exactly; float ``add``
rtol 1e-5, atol 1e-6 and PageRank rtol 1e-5, atol 1e-8 (the reference
test's). The info dicts and decision records' exchange fields depend on
the rank count, so they are held to the reference's at 8 ranks.
Topology-free properties run in-process.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import distributed_pb as dpb
from torch_sharded_harness import WORLDS, as_json, loads, run_port, run_reference, save_rank

REDUCE_TOL = dict(rtol=1e-5, atol=1e-6)
PR_TOL = dict(rtol=1e-5, atol=1e-8)
PR_ITERS = 5
RADII_K = 4


def _reduce_cases():
    """(name, idx key, val key, out_size, op, method, exact)."""
    cases = [
        ("eq_add_f32", "idx", "f32", 777, "add", "fused", False),  # non-divisible m and n
        ("eq_min_i32", "idx", "i32", 777, "min", "fused", True),
        ("eq_add_ones", "idx", "ones", 777, "add", "fused", True),  # the CSR degree stream
        ("eq_empty_shards", "idx_mod5", "ones", 5, "add", "fused", True),  # out_size < n_dev
        ("eq_short_stream", "idx_short", "ones_short", 777, "add", "fused", True),
        ("eq_rows_f32", "idx", "rows7", 777, "add", "fused", False),
        ("eq_sort", "idx", "ones", 777, "add", "sort", True),
        ("eq_counting", "idx", "ones", 777, "add", "counting", True),
    ]
    for F in (1, 3, 8):
        cases += [
            (f"rows_F{F}_add_i32", "ridx", f"ri{F}", 301, "add", "fused", True),
            (f"rows_F{F}_add_f32", "ridx", f"rf{F}", 301, "add", "fused", False),
            (f"rows_F{F}_max_f32", "ridx", f"rm{F}", 301, "max", "fused", True),
        ]
    return cases


REDUCE_CASES = _reduce_cases()
EXACT = {c[0]: c[6] for c in REDUCE_CASES}


def _graph_arrays(prefix, g):
    return {f"{prefix}_src": g.src.numpy(), f"{prefix}_dst": g.dst.numpy(),
            f"{prefix}_n": np.int64(g.num_nodes)}


def _write_inputs(workdir):
    rng = np.random.default_rng(0)
    m, n = 1001, 777
    idx = rng.integers(0, n, m).astype(np.int32)
    d = {
        "idx": idx,
        "f32": rng.standard_normal(m).astype(np.float32),
        "i32": rng.integers(0, 10_000, m).astype(np.int32),
        "ones": np.ones(m, np.int32),
        "idx_mod5": idx % 5,
        "idx_short": np.array([3, 1], np.int32),
        "ones_short": np.ones(2, np.int32),
        "rows7": rng.standard_normal((m, 7)).astype(np.float32),
    }
    rng = np.random.default_rng(4)
    d["ridx"] = rng.integers(0, 301, 1001).astype(np.int32)
    for F in (1, 3, 8):
        d[f"ri{F}"] = rng.integers(-9, 9, (1001, F)).astype(np.int32)
        d[f"rf{F}"] = rng.standard_normal((1001, F)).astype(np.float32)
        d[f"rm{F}"] = rng.standard_normal((1001, F)).astype(np.float32)
    rng = np.random.default_rng(0)
    d["ex_idx"] = rng.integers(0, 500, 2000).astype(np.int32)
    d["ex_val"] = rng.standard_normal(2000).astype(np.float32)
    g = T.gen_powerlaw(1 << 10, 4, seed=1, device="cpu")
    d.update(_graph_arrays("pl", g))
    d.update(_graph_arrays("road", T.gen_road(24, seed=4, device="cpu")))
    d.update(_graph_arrays("pre", T.gen_uniform(300, 4, seed=5, device="cpu")))
    csr = T.build_csr_baseline(g)
    d["trav_source"] = np.int64(int(np.argmax(np.diff(csr.offsets.numpy()))))
    d["trav_w"] = (np.random.default_rng(7).random(csr.num_edges) * 5 + 0.5).astype(np.float32)
    d["cases"] = np.asarray(json.dumps(REDUCE_CASES))
    np.savez(str(workdir / "inputs.npz"), **d)


REFERENCE = """
from repro.core import (COO, PreprocessPipeline, PBExecutor, bfs, build_csr_baseline,
                        build_csr_sharded, connected_components_sharded, k_core,
                        make_stream_mesh, pagerank_sharded, set_default_executor, sssp)
from repro.core.distributed_pb import shard_reduce_stream_info
from repro.core.radii import radii

mesh = make_stream_mesh(8)
for name, ik, vk, n, op, method, exact in json.loads(str(inputs["cases"])):
    got, info = shard_reduce_stream_info(jnp.asarray(inputs[ik]), jnp.asarray(inputs[vk]),
                                         out_size=n, mesh=mesh, op=op, method=method)
    out[name] = np.asarray(got)
    save_json(name + ":info", info)

def coo(p):
    return COO(jnp.asarray(inputs[p + "_src"]), jnp.asarray(inputs[p + "_dst"]), int(inputs[p + "_n"]))

set_default_executor(PBExecutor(cache_dir=os.path.abspath("ref_cache")))
g = coo("pl")
out["pagerank"] = np.asarray(pagerank_sharded(g, mesh, iters=%(iters)d).ranks)
c = connected_components_sharded(coo("road"), mesh)
out["cc_labels"], out["cc_iters"] = np.asarray(c.labels), np.int64(c.iters)
csr = build_csr_sharded(g, mesh)
out["csr_offsets"], out["csr_neighs"] = np.asarray(csr.offsets), np.asarray(csr.neighs)

ex = PBExecutor(cache_dir=os.path.abspath("ref_cache_ex"))
out["ex_out"] = np.asarray(ex.shard_reduce_stream(jnp.asarray(inputs["ex_idx"]),
                                                  jnp.asarray(inputs["ex_val"]), out_size=500, mesh=mesh))
save_json("ex_entry", ex.decision_log[-1])

csr = build_csr_baseline(g)
s = int(inputs["trav_source"])
b = bfs(csr, s, mesh=mesh, with_parents=True)
out["bfs_dist"], out["bfs_parent"], out["bfs_levels"] = (
    np.asarray(b.dist), np.asarray(b.parent), np.int64(b.levels))
out["sssp_dist"] = np.asarray(sssp(csr, jnp.asarray(inputs["trav_w"]), s, mesh=mesh).dist)
kc = k_core(csr, 3, mesh=mesh)
out["kcore_in"], out["kcore_rounds"] = np.asarray(kc.in_core), np.int64(kc.rounds)
out["radii_sources"] = np.asarray(jax.random.choice(
    jax.random.PRNGKey(0), csr.num_nodes, shape=(%(radii_k)d,), replace=False))
out["radii_ecc"] = np.asarray(radii(csr, k=%(radii_k)d, seed=0, mesh=mesh).ecc)

res = PreprocessPipeline(variant="degree_sort", mesh=mesh, warmup=False).run(coo("pre"))
out["pre_new_ids"] = np.asarray(res.new_ids)
out["pre_csr_offsets"], out["pre_csr_neighs"] = np.asarray(res.csr.offsets), np.asarray(res.csr.neighs)
out["pre_csc_offsets"], out["pre_csc_neighs"] = np.asarray(res.csc.offsets), np.asarray(res.csc.neighs)
save_json("pre_report", [res.report.sharded, res.report.build_method])
""" % {"iters": PR_ITERS, "radii_k": RADII_K}


def _port_ranks(rank, world, workdir):
    """One rank of the port's side: every case on the same global inputs."""
    import os

    from repro_torch.core.radii import _radii_from_sources

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    ref = dict(np.load(os.path.join(workdir, "ref.npz")))
    mesh = T.make_stream_mesh(device="cpu")
    out = {}
    for name, ik, vk, n, op, method, _ in json.loads(str(z["cases"])):
        got, info = dpb.shard_reduce_stream_info(
            torch.from_numpy(z[ik]), torch.from_numpy(z[vk]), out_size=n, mesh=mesh, op=op,
            method=method)
        out[name] = got.numpy()
        out[name + ":info"] = as_json(info)

    def coo(p):
        return T.COO(torch.from_numpy(z[p + "_src"]), torch.from_numpy(z[p + "_dst"]),
                     int(z[p + "_n"]))

    # every rank shares one cache directory: only rank 0 writes it
    T.set_default_executor(T.PBExecutor(cache_dir=os.path.join(workdir, f"cache_w{world}")))
    g = coo("pl")
    out["pagerank"] = T.pagerank_sharded(g, mesh, iters=PR_ITERS).ranks.numpy()
    c = T.connected_components_sharded(coo("road"), mesh)
    out["cc_labels"], out["cc_iters"] = c.labels.numpy(), np.int64(c.iters)
    csr = T.build_csr_sharded(g, mesh)
    out["csr_offsets"], out["csr_neighs"] = csr.offsets.numpy(), csr.neighs.numpy()
    orc = T.build_csr_oracle(g)
    out["csr_is_oracle"] = np.bool_(torch.equal(csr.offsets, orc.offsets)
                                    and torch.equal(csr.neighs, orc.neighs))

    ex = T.PBExecutor(cache_dir=os.path.join(workdir, f"cache_ex_w{world}"))
    out["ex_out"] = ex.shard_reduce_stream(
        torch.from_numpy(z["ex_idx"]), torch.from_numpy(z["ex_val"]), out_size=500,
        mesh=mesh).numpy()
    out["ex_entry"] = as_json(ex.decision_log[-1])

    csr = T.build_csr_baseline(g)
    s = int(z["trav_source"])
    b = T.bfs(csr, s, mesh=mesh, with_parents=True)
    out["bfs_dist"], out["bfs_parent"], out["bfs_levels"] = (
        b.dist.numpy(), b.parent.numpy(), np.int64(b.levels))
    out["bfs_meshes"] = as_json(sorted({json.dumps(d.get("mesh")) for d in b.decisions}))
    out["sssp_dist"] = T.sssp(csr, torch.from_numpy(z["trav_w"]), s, mesh=mesh).dist.numpy()
    kc = T.k_core(csr, 3, mesh=mesh)
    out["kcore_in"], out["kcore_rounds"] = kc.in_core.numpy(), np.int64(kc.rounds)
    out["radii_ecc"] = _radii_from_sources(csr, ref["radii_sources"], mesh=mesh).ecc.numpy()
    T.radii(csr, k=RADII_K, mesh=mesh)  # the entry point runs over the mesh too

    res = T.PreprocessPipeline(variant="degree_sort", mesh=mesh, warmup=False).run(coo("pre"))
    out["pre_new_ids"] = res.new_ids.numpy()
    out["pre_csr_offsets"], out["pre_csr_neighs"] = res.csr.offsets.numpy(), res.csr.neighs.numpy()
    out["pre_csc_offsets"], out["pre_csc_neighs"] = res.csc.offsets.numpy(), res.csc.neighs.numpy()
    out["pre_report"] = as_json([res.report.sharded, res.report.build_method])
    save_rank(workdir, world, rank, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("sharded")
    _write_inputs(wd)
    ref = run_reference(REFERENCE, wd)
    return ref, run_port(_port_ranks, wd)


def _close(got, want, exact, tol=REDUCE_TOL):
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c[0] for c in REDUCE_CASES])
def test_shard_reduce_matches_reference(runs, case, world):
    """shard_reduce_stream at every rank count against the reference on 8
    devices (which equals its single-device execute_reduce)."""
    ref, port = runs
    _close(port[world][case], ref[case], EXACT[case])


@pytest.mark.parametrize("case", [c[0] for c in REDUCE_CASES])
def test_shard_reduce_info_matches_reference_at_8(runs, case):
    ref, port = runs
    assert loads(port[8][case + ":info"]) == loads(ref[case + ":info"])


@pytest.mark.parametrize("world", WORLDS)
def test_one_rank_and_mesh_none_are_the_single_device_path(runs, world):
    """A group's info dict is all zeros only at one rank, where the call is
    execute_reduce itself."""
    _, port = runs
    info = loads(port[world]["eq_add_f32:info"])
    assert (info["pipeline_chunks"] == 1 and info["capacity"] == 0) == (world == 1)


@pytest.mark.parametrize("world", WORLDS)
def test_pagerank_sharded(runs, world):
    ref, port = runs
    _close(port[world]["pagerank"], ref["pagerank"], False, PR_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_components_sharded_labels_and_iters(runs, world):
    ref, port = runs
    _close(port[world]["cc_labels"], ref["cc_labels"], True)
    assert int(port[world]["cc_iters"]) == int(ref["cc_iters"])


@pytest.mark.parametrize("world", WORLDS)
def test_build_csr_sharded_equals_reference_and_oracle(runs, world):
    ref, port = runs
    for k in ("csr_offsets", "csr_neighs"):
        _close(port[world][k], ref[k], True)
    assert port[world]["csr_is_oracle"]


@pytest.mark.parametrize("world", WORLDS)
def test_executor_shard_reduce_stream(runs, world):
    ref, port = runs
    _close(port[world]["ex_out"], ref["ex_out"], False)
    got = loads(port[world]["ex_entry"])
    if world == 1:
        assert "mesh" not in got  # one rank: reduce_stream's own record
        return
    assert got["kind"] == "reduce" and got["mesh"] == {"shard": world}
    if world == 8:  # the exchange's facts depend on the rank count only
        want = loads(ref["ex_entry"])
        keys = ("kind", "mesh", "num_indices", "stream_len", "pipeline_chunks", "capacity",
                "capacity_source", "overflow", "packed", "op")
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("world", WORLDS)
def test_bfs_over_a_mesh(runs, world):
    ref, port = runs
    for k in ("bfs_dist", "bfs_parent", "bfs_levels"):
        _close(port[world][k], ref[k], True)
    meshes = loads(port[world]["bfs_meshes"])
    assert meshes == ([json.dumps({"shard": world})] if world > 1 else ["null"])


@pytest.mark.parametrize("world", WORLDS)
def test_sssp_and_k_core_over_a_mesh(runs, world):
    ref, port = runs
    for k in ("sssp_dist", "kcore_in", "kcore_rounds"):
        _close(port[world][k], ref[k], True)


@pytest.mark.parametrize("world", WORLDS)
def test_radii_over_a_mesh(runs, world):
    ref, port = runs
    _close(port[world]["radii_ecc"], ref["radii_ecc"], True)


@pytest.mark.parametrize("world", WORLDS)
def test_preprocess_pipeline_over_a_mesh(runs, world):
    ref, port = runs
    for k in ("pre_new_ids", "pre_csr_offsets", "pre_csr_neighs", "pre_csc_offsets",
              "pre_csc_neighs"):
        _close(port[world][k], ref[k], True)
    assert loads(port[world]["pre_report"]) == loads(ref["pre_report"]) == [True, "sharded"]


# -- in-process: topology-free properties -------------------------------------------


def test_key_includes_device_topology():
    """A single-device decision is never replayed for a sharded run: the
    cache key carries the rank count and, for sharded decisions, the mesh."""
    ex = T.PBExecutor()
    cpu = torch.device("cpu")
    k_plain = ex._key(1000, 8000, torch.float32, None, "reduce", "add", 0, cpu)
    assert ":d1" in k_plain  # one process, no group
    k_mesh = ex._key(1000, 8000, torch.float32, None, "reduce", "add", 0, cpu, (("shard", 8),))
    k_mesh2 = ex._key(1000, 8000, torch.float32, None, "reduce", "add", 0, cpu, (("shard", 4),))
    assert len({k_plain, k_mesh, k_mesh2}) == 3
    assert "shard8" in k_mesh and "shard4" in k_mesh2


def test_single_device_fallbacks():
    """mesh=None (and a one-rank mesh) is the single-device path, bit for
    bit; an order-sensitive op is refused on every entry point."""
    import jax.numpy as jnp

    import repro.core as R

    rng = np.random.default_rng(3)
    idx_np = rng.integers(0, 100, 500).astype(np.int32)
    val_np = rng.standard_normal(500).astype(np.float32)
    idx, val = torch.from_numpy(idx_np), torch.from_numpy(val_np)
    want = T.execute_reduce(idx, val, out_size=100, op="add", method="fused")
    for mesh in (None, T.make_stream_mesh(1, device="cpu")):
        assert torch.equal(T.shard_reduce_stream(idx, val, out_size=100, mesh=mesh), want)
        got2 = T.get_default_executor().shard_reduce_stream(idx, val, out_size=100, mesh=mesh)
        np.testing.assert_allclose(got2.numpy(), want.numpy(), rtol=1e-6)
    ref = R.shard_reduce_stream(jnp.asarray(idx_np), jnp.asarray(val_np), out_size=100, mesh=None)
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), **REDUCE_TOL)
    with pytest.raises(ValueError, match="commutative"):
        T.shard_reduce_stream(idx, val, out_size=100, op="concat")
    with pytest.raises(ValueError, match="commutative"):
        T.get_default_executor().shard_reduce_stream(idx, val, out_size=100, op="concat")


def test_empty_stream_identity():
    out = T.shard_reduce_stream(torch.zeros(0, dtype=torch.int32),
                                torch.zeros(0, dtype=torch.int32), out_size=7, op="min")
    assert torch.equal(out, torch.full((7,), np.iinfo(np.int32).max, dtype=torch.int32))


def test_make_stream_mesh_without_a_group():
    mesh = T.make_stream_mesh(device="cpu")
    assert mesh.size == 1 and mesh.shape == {"shard": 1} and mesh.group is None
    assert dpb.resolve_stream_axis(mesh) == "shard"
    assert dpb.resolve_stream_axis(T.make_stream_mesh(1, "rows", device="cpu")) == "rows"
    with pytest.raises(ValueError, match="ranks"):
        T.make_stream_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not in mesh axes"):
        dpb.resolve_stream_axis(mesh, "model")


def test_packing_is_bitwise():
    """The packed buffer is int32: float32 values ride by ``.view`` and come
    back bit for bit, NaN payloads and denormals included."""
    assert dpb.can_pack(torch.float32) and dpb.can_pack(torch.int32)
    assert not dpb.can_pack(torch.int16) and not dpb.can_pack(torch.float64)
    assert not dpb.can_pack(torch.bfloat16)
    bits = torch.tensor([0x7FC00001, 0x00000001, 0x007FFFFF, -1, 0], dtype=torch.int32)
    assert torch.equal(bits.view(torch.float32).view(torch.int32), bits)


def test_sharded_traffic_model_monotone():
    """Modeled per-rank device bytes fall with the rank count; ragged
    exchange bytes stay below padded; one rank is the fused counter."""
    from repro_torch.core import traffic

    for n, m in [(1 << 20, 1 << 23), (1 << 15, 1 << 17), (100, 1000)]:
        per_dev = [traffic.sharded_fused_hbm_bytes_per_device(m, n, k) for k in (1, 2, 4, 8, 16)]
        assert all(a > b for a, b in zip(per_dev, per_dev[1:])), (n, m, per_dev)
        assert per_dev[0] == traffic.fused_stream_bytes(m, n)
        ragged = traffic.sharded_exchange_bytes_per_device(m, 8)
        padded = traffic.sharded_exchange_bytes_per_device(m, 8, padded_capacity=m / 8)
        assert 0 < ragged < padded
    assert traffic.sharded_exchange_bytes_per_device(1 << 20, 1) == 0.0


def test_sharded_roofline():
    from repro_torch.roofline import PBStreamRoofline, ShardedPBStreamRoofline

    rl = ShardedPBStreamRoofline(num_tuples=1 << 27, num_indices=1 << 25, n_dev=8)
    assert rl.t_hbm > 0 and rl.t_ici > 0
    assert rl.bottleneck in ("hbm", "interconnect")
    assert rl.t_hbm < PBStreamRoofline(1 << 27, 1 << 25).t_fused
    fast = ShardedPBStreamRoofline(num_tuples=1 << 27, num_indices=1 << 25, n_dev=8, ici_bw=1e18)
    np.testing.assert_allclose(fast.speedup_ceiling, 8.0, rtol=1e-6)


def test_graph_cache_gen_version(tmp_path, monkeypatch):
    """Bumping GRAPH_GEN_VERSION regenerates a cached graph."""
    from repro_torch.core import graph as G

    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    calls = {"n": 0}

    def maker():
        calls["n"] += 1
        g = G.gen_uniform(64, 2, seed=9, device="cpu")
        return g.src.numpy(), g.dst.numpy(), g.num_nodes

    g1 = G.cached_graph("unit_v_test", maker, device="cpu")
    g2 = G.cached_graph("unit_v_test", maker, device="cpu")
    assert calls["n"] == 1 and torch.equal(g1.src, g2.src)
    monkeypatch.setattr(G, "GRAPH_GEN_VERSION", G.GRAPH_GEN_VERSION + 1)
    G.cached_graph("unit_v_test", maker, device="cpu")
    assert calls["n"] == 2
    G.cached_graph("unit_v_test", maker, device="cpu")
    assert calls["n"] == 2

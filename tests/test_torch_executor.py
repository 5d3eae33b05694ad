"""Executor parity: decisions, execute_binning and execute_reduce.

Decisions are compared field by field against the reference
``PBExecutor`` under the same hardware fields, each with a fresh cache
directory, so that no persisted entry turns an answer into a ``cache``
decision. Binning is bit-exact for every method; reductions are exact for
int32 and min/max, and float32 adds agree within rtol 1e-6 (the CPU sums
in stream order on both sides, but the reference's blockwise scan may
group the same terms differently).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as rex
from repro.core.plan import HardwareModel as RHW
from repro_torch.convert import hardware_from_fields, to_numpy
from repro_torch.core import executor as tex
from repro_torch.core.plan import CobraPlan, HardwareModel as THW

_JNP = {torch.float32: jnp.float32, torch.int32: jnp.int32}


def _hw(which):
    t = getattr(THW, which)()
    r = RHW(t.name, tuple(t.fast_levels), t.cbuffer_bytes, t.dram_bandwidth, t.fast_bandwidth)
    return r, hardware_from_fields(
        r.name, r.fast_levels, r.cbuffer_bytes, r.dram_bandwidth, r.fast_bandwidth
    )


def _same(td, rd):
    assert (td.method, td.bin_range, td.num_bins, td.source, td.f_tile) == (
        rd.method, rd.bin_range, rd.num_bins, rd.source, rd.f_tile,
    )
    if rd.plan is None:
        assert td.plan is None
    else:
        assert (td.plan.num_indices, td.plan.final_bin_range, td.plan.level_fanouts) == (
            rd.plan.num_indices, rd.plan.final_bin_range, rd.plan.level_fanouts,
        )


@pytest.mark.parametrize("which", ["h100", "tpu_v5e", "cpu_xeon"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_decide_matches_reference(tmp_path, which, use_pallas):
    rhw, thw = _hw(which)
    rx = rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"), use_pallas=use_pallas)
    tx = tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t"), use_pallas=use_pallas)
    ns = [1, 300, 1 << 10, 1 << 14, 1 << 18, 4_194_304, 32_000_000]
    ms = [100, 5000, 1 << 16, 1 << 20, 33_554_432]
    for n in ns:
        for m in ms:
            for br in (None, 64, 8192):
                for kind, dt in (("bin", torch.int32), ("reduce", torch.float32), ("reduce", torch.int32)):
                    for flat, feat in ((True, 0), (False, 8)):
                        if kind == "bin" and feat:
                            continue
                        kw = dict(bin_range=br, flat_values=flat, kind=kind, feature_dim=feat)
                        _same(tx.decide(n, m, dt, **kw), rx.decide(n, m, _JNP[dt], **kw))
                        for method in (None, "sort", "hierarchical", "fused"):
                            _same(
                                tx.decide_or_forced(method, n, m, dt, **kw),
                                rx.decide_or_forced(method, n, m, _JNP[dt], **kw),
                            )


def test_main_path_decisions_on_h100_model(tmp_path):
    """The decisions chip_smoke.py relies on: fused degree counts and
    PageRank at S2 and, under the H100 fit rule, at S3 (the two-pass
    kernel); S3's binning at the compromise range stays the two-pass
    hierarchical path."""
    from repro_torch.core.plan import compromise_bin_range
    from repro_torch.kernels.fused import fused_design

    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    assert ex.decide(4_194_304, 33_554_432, torch.int32, kind="reduce").method == "fused"
    for dt in (torch.int32, torch.float32):
        d = ex.decide(32_000_000, 128_000_000, dt, kind="reduce")
        assert d.method == "fused" and d.source == "analytic"
    assert fused_design(128_000_000, 32_000_000) == "two-pass"
    br = compromise_bin_range(32_000_000, ex.hw)
    d = ex.decide(32_000_000, 128_000_000, bin_range=br)
    assert d.method == "hierarchical" and d.plan.num_passes == 2
    d = ex.decide(32_000_000, 128_000_000, device="cpu")  # no table entry on the CPU
    assert d.method == "hierarchical" and d.plan.num_passes == 2 and d.source == "analytic"
    assert tex.PBExecutor(cache_dir=str(tmp_path), use_pallas=True).decide(
        4_194_304, 33_554_432, bin_range=8192
    ).method == "pallas"


def test_autotune_and_unported_kinds_raise(tmp_path):
    """The autotuner measures every candidate on the stream's device,
    caches the fastest under the port's namespace and a new executor
    reads it back; the update kind decides and reduces like a reduce
    under its own key, and a kind outside bin/reduce/update raises."""
    ex = tex.PBExecutor(autotune=True, cache_dir=str(tmp_path))
    d = ex.decide(3000, 20_000, torch.int32, device="cpu")
    assert d.source == "autotuned"
    blob = json.loads((tmp_path / "autotune.json").read_text())
    assert blob["version"] == tex._CACHE_SCHEMA_VERSION
    (key, entry), = blob["entries"].items()
    assert "torch:cpu" in key and entry["method"] == d.method
    assert set(entry["timings_us"]) == {"sort", "counting", "hierarchical"}
    again = tex.PBExecutor(cache_dir=str(tmp_path)).decide(3000, 20_000, torch.int32, device="cpu")
    assert (again.method, again.source) == (d.method, "cache")
    r = ex.decide(3000, 20_000, torch.float32, kind="reduce", op="min", device="cpu")
    assert r.source == "autotuned" and len(ex.cache.mem) == 2
    i, v = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    u = ex.decide(3000, 20_000, torch.float32, kind="update", op="min", device="cpu")
    assert u.source == "autotuned" and len(ex.cache.mem) == 3
    assert torch.equal(ex.reduce_stream(i, v, out_size=4, kind="update"),
                       torch.tensor([3.0, 0.0, 0.0, 0.0]))
    with pytest.raises(ValueError, match="kind"):
        ex.reduce_stream(i, v, out_size=4, kind="bin")
    with pytest.raises(ValueError, match="kind"):
        ex.decide(4, 3, kind="scatter")
    with pytest.raises(ValueError, match="commutative"):
        ex.reduce_stream(i, v, out_size=4, op="mul")


def _stream(n, m, seed, dtype=np.float32, rows=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m).astype(np.int32)
    shape = (m, rows) if rows else (m,)
    if dtype == np.int32:
        return idx, rng.integers(-50, 50, shape).astype(np.int32)
    return idx, rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("method", ["sort", "counting", "pallas", "hierarchical"])
@pytest.mark.parametrize("n,m,r", [(777, 3001, 100), (5000, 6000, 64), (10, 0, 4)])
def test_execute_binning_bit_exact(method, n, m, r):
    idx, val = _stream(n, m, seed=m)
    nb = -(-n // r)
    rplan = tplan = None
    if method == "hierarchical":
        from repro.core.plan import CobraPlan as RPlan

        rplan = RPlan.from_hardware(n, final_bin_range=r, max_fanout=4)
        tplan = CobraPlan.from_hardware(n, final_bin_range=r, max_fanout=4)
    want = rex.execute_binning(
        jnp.asarray(idx), jnp.asarray(val), bin_range=r, num_bins=nb, method=method,
        plan=rplan, block=512,
    )
    got = tex.execute_binning(
        torch.from_numpy(idx), torch.from_numpy(val), bin_range=r, num_bins=nb,
        method=method, plan=tplan,
    )
    for a, b in ((got.idx, want.idx), (got.val, want.val), (got.starts, want.starts)):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


@pytest.mark.parametrize("method", ["sort", "counting", "pallas", "hierarchical", "fused"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_execute_reduce_matches_reference(method, op, dtype):
    n, m = 1500, 7001
    idx, val = _stream(n, m, seed=3, dtype=dtype)
    plan_kw = {}
    if method == "hierarchical":
        from repro.core.plan import CobraPlan as RPlan

        plan_kw = dict(
            r=dict(plan=RPlan.from_hardware(n, final_bin_range=50, max_fanout=8)),
            t=dict(plan=CobraPlan.from_hardware(n, final_bin_range=50, max_fanout=8)),
        )
    want = rex.execute_reduce(
        jnp.asarray(idx), jnp.asarray(val), out_size=n, op=op, method=method,
        bin_range=50, **plan_kw.get("r", {}),
    )
    got = tex.execute_reduce(
        torch.from_numpy(idx), torch.from_numpy(val), out_size=n, op=op, method=method,
        bin_range=50, **plan_kw.get("t", {}),
    )
    if dtype == np.int32 or op != "add":
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", [None, "sort", "fused"])
def test_reduce_stream_rows_on_cpu(tmp_path, method):
    idx, val = _stream(200, 900, seed=9, rows=3)
    rx = rex.PBExecutor(cache_dir=str(tmp_path / "r"))
    tx = tex.PBExecutor(cache_dir=str(tmp_path / "t"))
    for op in ("add", "max"):
        want = rx.reduce_stream(jnp.asarray(idx), jnp.asarray(val), out_size=200, op=op, method=method)
        got = tx.reduce_stream(torch.from_numpy(idx), torch.from_numpy(val), out_size=200, op=op, method=method)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_bin_stream_and_scatter_add(tmp_path):
    idx, val = _stream(3000, 20000, seed=4)
    rx = rex.PBExecutor(cache_dir=str(tmp_path / "r"), use_pallas=True)
    tx = tex.PBExecutor(cache_dir=str(tmp_path / "t"), use_pallas=True)
    rb = rx.bin_stream(jnp.asarray(idx), jnp.asarray(val), num_indices=3000, bin_range=64)
    tb = tx.bin_stream(torch.from_numpy(idx), torch.from_numpy(val), num_indices=3000, bin_range=64)
    assert rx.decision_log[-1]["method"] == tx.decision_log[-1]["method"] == "pallas"
    np.testing.assert_array_equal(to_numpy(tb.idx), np.asarray(rb.idx))
    np.testing.assert_array_equal(to_numpy(tb.val), np.asarray(rb.val))
    np.testing.assert_allclose(
        to_numpy(tx.scatter_add(torch.from_numpy(idx), torch.from_numpy(val), out_size=3000)),
        np.asarray(rx.scatter_add(jnp.asarray(idx), jnp.asarray(val), out_size=3000)),
        rtol=1e-6, atol=1e-6,
    )


def test_default_executor_swap():
    old = tex.get_default_executor()
    try:
        ex = tex.PBExecutor(use_pallas=True)
        tex.set_default_executor(ex)
        assert tex.get_default_executor() is ex
        assert ex.hw == THW.h100()
    finally:
        tex.set_default_executor(old)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_execute_reduce_rows_matches_pallas_path(op, dtype):
    """Row-block values through ``execute_reduce(method="fused")`` with the
    reference's keywords, against the reference's Pallas rows kernel
    (``use_pallas=True``, interpret mode) at a ragged F-tile. Exact for
    int32 and min/max; a float32 add within atol 1e-4 (flush order)."""
    n, F = 257, 5
    idx, val = _stream(n, 800, seed=17, dtype=dtype, rows=F)
    order = np.argsort(idx, kind="stable")  # the GNN stream shape: sorted, in bounds
    idx, val = idx[order], val[order]
    kw = dict(out_size=n, op=op, method="fused", bin_range=64, sorted_within=1,
              in_bounds=True, f_tile=2)
    want = rex.execute_reduce(jnp.asarray(idx), jnp.asarray(val), use_pallas=True, **kw)
    got = tex.execute_reduce(torch.from_numpy(idx), torch.from_numpy(val), **kw)
    assert got.shape == (n, F) and got.dtype == torch.from_numpy(val).dtype
    if dtype == np.int32 or op != "add":
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4)


def test_reduce_stream_passes_the_decided_f_tile(tmp_path, monkeypatch):
    """``reduce_stream`` hands its decision's f_tile to ``execute_reduce``,
    as the reference does; the decision itself stays at parity."""
    seen = {}
    real = tex.execute_reduce

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(tex, "execute_reduce", spy)
    idx, val = _stream(300, 1000, seed=5, rows=16)
    tx = tex.PBExecutor(cache_dir=str(tmp_path / "t"))
    rx = rex.PBExecutor(cache_dir=str(tmp_path / "r"))
    tx.reduce_stream(torch.from_numpy(idx), torch.from_numpy(val), out_size=300, method="fused")
    want = rx.decide_or_forced("fused", 300, 1000, jnp.float32, kind="reduce", feature_dim=16)
    assert seen["f_tile"] == want.f_tile == 16


# -- the rest of the executor: fit rule, fallback tables, autotuner, sinks, batches ----


@pytest.mark.parametrize("which", ["tpu_v5e", "cpu_xeon"])
def test_fused_fits_follows_the_reference_rule_under_its_models(tmp_path, which):
    rhw, thw = _hw(which)
    rx = rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"))
    tx = tex.PBExecutor(hw=getattr(THW, which)(), cache_dir=str(tmp_path / "t"))
    assert thw == getattr(THW, which)()  # the reference's models carry no fused capacity
    for n in (1, 1000, 1 << 20, 4_194_304, 9_175_040, 16_777_216, 32_000_000, 1 << 26):
        for vb in (1, 2, 4, 8, 64):
            for m in (0, 1 << 20, 128_000_000):
                for flat in (True, False):
                    assert tx.fused_fits(n, vb, m, flat) == rx.fused_fits(n, vb)


@pytest.mark.parametrize("n,vb,m,flat,fits", [
    (6_553_600, 4, 1 << 30, False, True),     # half the L2: the reference's rule
    (6_553_601, 4, 1 << 20, False, False),    # rows keep that rule
    (32_000_000, 4, 128_000_000, True, True),  # S3: the two-pass kernel
    (1 << 26, 4, 128_000_000, True, True),    # 2048 slabs of 32768
    ((1 << 26) + 1, 4, 1000, True, False),    # past the slab limit
    (32_000_000, 8, 1000, True, False),       # the kernel takes 4-byte values
    (32_000_000, 2, 1000, True, False),
    (32_000_000, 4, 13_333_333_333, True, True),   # 6 bytes a tuple within 80 GB
    (32_000_000, 4, 13_333_333_334, True, False),
])
def test_fused_fits_under_the_h100_model(tmp_path, n, vb, m, flat, fits):
    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    assert ex.fused_fits(n, vb, m, flat) is fits
    assert ex.analytic_reduce_method(n, m, value_bytes=vb, flat=flat) == (
        "fused" if fits else ex.analytic_method(n, m))


def test_h100_model_capacity_is_the_kernels_bound():
    from repro_torch.kernels.fused import TWO_PASS_MAX_INDICES

    hw = THW.h100()
    assert hw.fused_max_indices == TWO_PASS_MAX_INDICES
    assert hw.fused_scratch_per_tuple == 6


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bucket", sorted(tex._FALLBACK_TABLE_H100[False]))
def test_h100_table_is_read_for_cuda_streams_only(tmp_path, use_pallas, bucket):
    a, b = bucket
    ex = tex.PBExecutor(cache_dir=str(tmp_path), use_pallas=use_pallas)
    d = ex.decide(1 << a, 1 << b, device="cuda")
    assert (d.method, d.source) == (tex._FALLBACK_TABLE_H100[use_pallas][bucket], "fallback-table")
    rhw, thw = _hw("h100")
    rx = rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"), use_pallas=use_pallas)
    want = rx.decide(1 << a, 1 << b, jnp.int32)
    _same(ex.decide(1 << a, 1 << b, device="cpu"), want)
    _same(tex.PBExecutor(hw=thw, cache_dir=str(tmp_path), use_pallas=use_pallas).decide(
        1 << a, 1 << b, device="cuda"), want)


def test_measure_methods_times_every_candidate(tmp_path):
    ex = tex.PBExecutor(cache_dir=str(tmp_path), use_pallas=True)
    for kind, feat, want in (("bin", 0, {"sort", "counting", "pallas", "hierarchical"}),
                             ("reduce", 0, {"sort", "counting", "pallas", "hierarchical", "fused"}),
                             ("reduce", 4, {"sort", "counting", "hierarchical", "fused"})):
        res = ex.measure_methods(500, 3000, torch.float32 if kind == "reduce" else torch.int32,
                                 flat_values=not feat, reps=2, kind=kind, feature_dim=feat,
                                 device="cpu")
        assert set(res["timings_us"]) == want
        assert res["method"] == min(res["timings_us"], key=res["timings_us"].get)
    assert "fused" not in ex._candidates(True, "reduce", stream_len=2**31)
    assert "pallas" not in ex._candidates(True, "bin", stream_len=2**31)
    assert ex._candidates(True, "reduce", stream_len=2**31 - 1) == ex._candidates(True, "reduce")


def test_measure_methods_raises_when_a_method_fails(tmp_path, monkeypatch):
    real = tex.execute_binning

    def broken(*a, method, **kw):
        if method == "counting":
            raise RuntimeError("counting broke")
        return real(*a, method=method, **kw)

    monkeypatch.setattr(tex, "execute_binning", broken)
    ex = tex.PBExecutor(autotune=True, cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="counting broke"):
        ex.decide(500, 3000, device="cpu")
    assert ex.cache.mem == {}


def test_decision_cache_merges_writers_and_survives_bad_files(tmp_path):
    a = tex._DecisionCache(str(tmp_path))
    b = tex._DecisionCache(str(tmp_path))
    a.put("k1", {"method": "sort"})
    b.put("k2", {"method": "counting"})
    blob = json.loads((tmp_path / "autotune.json").read_text())
    assert blob["entries"] == {"k1": {"method": "sort"}, "k2": {"method": "counting"}}
    assert not list(tmp_path.glob("autotune.json.tmp.*"))
    (tmp_path / "autotune.json").write_text("{torn")
    assert tex._DecisionCache(str(tmp_path)).mem == {}
    (tmp_path / "autotune.json").write_text(json.dumps({"version": 0, "entries": {"x": {}}}))
    assert tex._DecisionCache(str(tmp_path)).mem == {}
    blocker = tmp_path / "file"
    blocker.write_text("")
    c = tex._DecisionCache(str(blocker))
    c.put("k", {"method": "sort"})
    assert c.persist_ok is False and c.get("k") == {"method": "sort"}


def test_decision_sinks_match_the_reference(tmp_path):
    """Every decision goes to the log and to each sink; nested sinks that
    hold equal entries detach by identity; an unknown sink raises."""
    rhw, thw = _hw("h100")
    rx = rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"))
    tx = tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t"))
    logs = []
    for ex, dt in ((rx, jnp.float32), (tx, torch.float32)):
        outer, inner = [], []
        ex.add_decision_sink(outer)
        ex.decide(1000, 5000, dt, kind="reduce")
        ex.add_decision_sink(inner)
        ex.decide(300, 100)
        assert outer[1:] == inner and outer[1] is inner[0]
        ex.remove_decision_sink(inner)  # == outer[1:] but not the same list
        ex.decide(1 << 14, 1 << 16)
        assert len(inner) == 1 and len(outer) == 3
        with pytest.raises(ValueError, match="not registered"):
            ex.remove_decision_sink(list(inner))
        ex.remove_decision_sink(outer)
        ex.decide(5, 5)
        assert len(outer) == 3 and ex.decision_log[:3] == outer
        logs.append(outer)
    assert logs[0] == logs[1]


def test_decision_sinks_outlast_the_log_cap(tmp_path):
    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    sink = []
    ex.add_decision_sink(sink)
    for i in range(tex._DECISION_LOG_CAP + 10):
        ex.decide(100 + i, 1000)
    assert len(ex.decision_log) == tex._DECISION_LOG_CAP and len(sink) == tex._DECISION_LOG_CAP + 10
    assert ex.decision_log[-1] is sink[tex._DECISION_LOG_CAP - 1]


def _batch(B, n, m, seed, dtype=np.float32, rows=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (B, m)).astype(np.int32)
    shape = (B, m, rows) if rows else (B, m)
    if dtype == np.int32:
        return idx, rng.integers(-50, 50, shape).astype(np.int32)
    return idx, rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("method", [None, "sort", "counting", "fused"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reduce_streams_matches_reference_and_reduce_stream(tmp_path, method, op, dtype):
    """Each lane equals the reference's batched lane (float32 add within
    rtol 1e-6: the reference's fused lanes sum blockwise) and the port's
    own reduce_stream of that lane bit for bit."""
    rhw, thw = _hw("h100")
    rx = rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"))
    tx = tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t"))
    idx, val = _batch(3, 700, 5000, seed=11, dtype=dtype)
    want = rx.reduce_streams(jnp.asarray(idx), jnp.asarray(val), out_size=700, op=op, method=method)
    got = tx.reduce_streams(torch.from_numpy(idx), torch.from_numpy(val), out_size=700, op=op,
                            method=method)
    if dtype == np.int32 or op != "add":
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert tx.decision_log == rx.decision_log
    d = tx.decide_or_forced(method, 700, 5000, torch.from_numpy(val).dtype, kind="reduce", op=op,
                            device="cpu")
    for b in range(3):
        one = tx.reduce_stream(torch.from_numpy(idx[b]), torch.from_numpy(val[b]), out_size=700,
                               op=op, method=d.method)
        assert torch.equal(got[b], one)


@pytest.mark.parametrize("method", [None, "sort", "fused"])
def test_reduce_streams_rows_match_reference(tmp_path, method):
    idx, val = _batch(2, 300, 900, seed=12, rows=3)
    rx = rex.PBExecutor(cache_dir=str(tmp_path / "r"))
    tx = tex.PBExecutor(cache_dir=str(tmp_path / "t"))
    for op in ("add", "max"):
        want = rx.reduce_streams(jnp.asarray(idx), jnp.asarray(val), out_size=300, op=op,
                                 method=method)
        got = tx.reduce_streams(torch.from_numpy(idx), torch.from_numpy(val), out_size=300, op=op,
                                method=method)
        assert got.shape == (2, 300, 3)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_batched_streams_clamp_like_the_reference(tmp_path):
    """A decided method outside the batched set runs as sort and is logged
    under ``+batch-clamp``, as the reference logs it; a forced one raises."""
    tiny = ("tiny", (1024,), 64, 1e9, 1e10)
    rx = rex.PBExecutor(hw=RHW(*tiny), cache_dir=str(tmp_path / "r"), use_pallas=True)
    tx = tex.PBExecutor(hw=hardware_from_fields(*tiny), cache_dir=str(tmp_path / "t"),
                        use_pallas=True)
    idx, val = _batch(2, 5000, 8192, seed=13)
    ji, jv, ti, tv = jnp.asarray(idx), jnp.asarray(val), torch.from_numpy(idx), torch.from_numpy(val)
    np.testing.assert_allclose(
        to_numpy(tx.reduce_streams(ti, tv, out_size=5000)),
        np.asarray(rx.reduce_streams(ji, jv, out_size=5000)), rtol=1e-6, atol=1e-6)
    rb, tb = rx.bin_streams(ji, jv, num_indices=5000), tx.bin_streams(ti, tv, num_indices=5000)
    for a, b in ((tb.idx, rb.idx), (tb.val, rb.val), (tb.starts, rb.starts)):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    assert tb.bin_range == rb.bin_range
    assert tx.decision_log == rx.decision_log
    assert [e["source"] for e in tx.decision_log if "+batch-clamp" in e["source"]] == [
        "analytic+batch-clamp", "analytic+batch-clamp"]
    for bad in ("pallas", "hierarchical"):
        with pytest.raises(ValueError, match="batched reduce supports"):
            tx.reduce_streams(ti, tv, out_size=5000, method=bad)
    with pytest.raises(ValueError, match="batched binning supports"):
        tex.bin_streams_batched(ti, tv, bin_range=64, num_bins=79, method="pallas")
    with pytest.raises(ValueError, match=r"\(B, m\)"):
        tx.reduce_streams(ti[0], tv[0], out_size=5000)
    with pytest.raises(ValueError, match="commutative"):
        tx.reduce_streams(ti, tv, out_size=5000, op="mul")


@pytest.mark.parametrize("method", [None, "sort", "counting"])
@pytest.mark.parametrize("rows", [0, 2])
def test_bin_streams_and_scatter_add_batched_match_reference(tmp_path, method, rows):
    idx, val = _batch(3, 2000, 6000, seed=14, rows=rows)
    rhw, thw = _hw("h100")
    rx = rex.PBExecutor(hw=rhw, cache_dir=str(tmp_path / "r"))
    tx = tex.PBExecutor(hw=thw, cache_dir=str(tmp_path / "t"))
    ji, jv, ti, tv = jnp.asarray(idx), jnp.asarray(val), torch.from_numpy(idx), torch.from_numpy(val)
    rb = rx.bin_streams(ji, jv, num_indices=2000, bin_range=128, method=method)
    tb = tx.bin_streams(ti, tv, num_indices=2000, bin_range=128, method=method)
    for a, b in ((tb.idx, rb.idx), (tb.val, rb.val), (tb.starts, rb.starts)):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    np.testing.assert_allclose(
        to_numpy(tx.scatter_add_batched(ti, tv, out_size=2000)),
        np.asarray(rx.scatter_add_batched(ji, jv, out_size=2000)), rtol=1e-6, atol=1e-6)
    assert tx.decision_log == rx.decision_log


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_flattened_fused_lanes_keep_to_their_lane(tmp_path, op, monkeypatch):
    """Out-of-range indices are dropped, not moved to the next lane, and a
    batch wider than the kernel's index bound reduces lane by lane; both
    equal the lanes' own reductions bit for bit on the CPU."""
    import repro_torch.kernels.fused as kf

    rng = np.random.default_rng(15)
    idx = torch.from_numpy(rng.integers(-5, 505, (4, 3000)).astype(np.int32))
    val = torch.from_numpy(rng.normal(size=(4, 3000)).astype(np.float32))
    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    want = torch.stack([tex.execute_reduce(idx[b], val[b], out_size=500, op=op, method="fused")
                        for b in range(4)])
    calls = []
    real = tex.execute_reduce
    monkeypatch.setattr(tex, "execute_reduce", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    assert torch.equal(ex.reduce_streams(idx, val, out_size=500, op=op, method="fused"), want)
    assert len(calls) == 1
    monkeypatch.setattr(kf, "TWO_PASS_MAX_INDICES", 1999)  # 4 lanes x 500 no longer fit
    assert torch.equal(ex.reduce_streams(idx, val, out_size=500, op=op, method="fused"), want)
    assert len(calls) == 5

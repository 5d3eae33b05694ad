"""Executor parity: decisions, execute_binning and execute_reduce.

Decisions are compared field by field against the reference
``PBExecutor`` under the same hardware fields, each with a fresh cache
directory, so that no persisted entry turns an answer into a ``cache``
decision. Binning is bit-exact for every method; reductions are exact for
int32 and min/max, and float32 adds agree within rtol 1e-6 (the CPU sums
in stream order on both sides, but the reference's blockwise scan may
group the same terms differently).
"""
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
    """The decisions chip_smoke.py relies on: fused degree counts up to the
    L2 limit, the two-phase hierarchical path at the paper's scale."""
    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    assert ex.decide(4_194_304, 33_554_432, torch.int32, kind="reduce").method == "fused"
    d = ex.decide(32_000_000, 128_000_000, torch.int32, kind="reduce")
    assert d.method == "hierarchical" and d.plan.num_passes == 2
    assert tex.PBExecutor(cache_dir=str(tmp_path), use_pallas=True).decide(
        4_194_304, 33_554_432, bin_range=8192
    ).method == "pallas"


def test_autotune_and_unported_kinds_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tex.PBExecutor(autotune=True, cache_dir=str(tmp_path))
    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    i, v = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ex.reduce_stream(i, v, out_size=4, kind="update")
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

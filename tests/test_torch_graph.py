"""Port parity: graph containers, generators and planning.

The generators are the reference's numpy code, so the COO arrays must be
bit-identical; degrees, offsets, segment ids and plans are integer
results and must be equal. Everything runs on the CPU (``device="cpu"``).
"""
import numpy as np
import pytest
import torch

import repro.core.graph as rgraph
import repro.core.plan as rplan
import repro_torch.core.graph as tgraph
import repro_torch.core.plan as tplan
from repro_torch.convert import coo_from_numpy, hardware_from_fields, to_numpy

GRAPHS = ("DBP", "KRON", "URND", "EURO", "HBUBL")


@pytest.fixture(scope="module")
def suites():
    return rgraph.graph_suite("smoke"), tgraph.graph_suite("smoke", device="cpu")


@pytest.mark.parametrize("name", GRAPHS)
def test_smoke_graphs_bit_identical(suites, name):
    r, t = suites[0][name], suites[1][name]
    assert t.num_nodes == r.num_nodes and t.num_edges == r.num_edges
    assert t.src.dtype == torch.int32 and t.dst.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(t.src), np.asarray(r.src))
    np.testing.assert_array_equal(to_numpy(t.dst), np.asarray(r.dst))


@pytest.mark.parametrize("name", GRAPHS)
def test_degrees_offsets_segments_transpose_equal(suites, name):
    r, t = suites[0][name], suites[1][name]
    for by in ("src", "dst"):
        rd = rgraph.degrees_from_coo(r, by=by)
        td = tgraph.degrees_from_coo(t, by=by)
        np.testing.assert_array_equal(to_numpy(td), np.asarray(rd))
        ro = rgraph.offsets_from_degrees(rd)
        to = tgraph.offsets_from_degrees(td)
        np.testing.assert_array_equal(to_numpy(to), np.asarray(ro))
        np.testing.assert_array_equal(
            to_numpy(tgraph.segment_ids_from_offsets(to, t.num_edges)),
            np.asarray(rgraph.segment_ids_from_offsets(ro, r.num_edges)),
        )
    tt, rt = tgraph.transpose_coo(t), rgraph.transpose_coo(r)
    np.testing.assert_array_equal(to_numpy(tt.src), np.asarray(rt.src))
    np.testing.assert_array_equal(to_numpy(tt.dst), np.asarray(rt.dst))


def _hw_pair(which):
    if which == "h100":
        t = tplan.HardwareModel.h100()
        r = rplan.HardwareModel(
            t.name, tuple(t.fast_levels), t.cbuffer_bytes, t.dram_bandwidth, t.fast_bandwidth
        )
        return r, t
    r = getattr(rplan.HardwareModel, which)()
    t = hardware_from_fields(
        r.name, r.fast_levels, r.cbuffer_bytes, r.dram_bandwidth, r.fast_bandwidth
    )
    return r, t


@pytest.mark.parametrize("which", ["tpu_v5e", "cpu_xeon", "h100"])
@pytest.mark.parametrize("n", [1, 7, 1000, 1 << 18, 4_194_304, 32_000_000])
def test_plans_equal_under_same_hardware(which, n):
    r, t = _hw_pair(which)
    assert tplan.compromise_bin_range(n, t) == rplan.compromise_bin_range(n, r)
    assert tplan.binread_optimal_range(t) == rplan.binread_optimal_range(r)
    assert tplan.binning_optimal_num_bins(t) == rplan.binning_optimal_num_bins(r)
    assert tplan.num_bins_for_range(n, 97) == rplan.num_bins_for_range(n, 97)
    for kw in ({}, {"final_bin_range": 64}, {"max_fanout": 4}):
        rp = rplan.CobraPlan.from_hardware(n, r, **kw)
        tp = tplan.CobraPlan.from_hardware(n, t, **kw)
        assert (tp.num_indices, tp.final_bin_range, tp.level_fanouts) == (
            rp.num_indices, rp.final_bin_range, rp.level_fanouts,
        )
        assert tp.level_ranges() == rp.level_ranges() and tp.num_bins == rp.num_bins


def test_h100_model_fields_and_default():
    hw = tplan.HardwareModel.h100()
    assert tuple(hw.fast_levels) == (232_448, 50 * 2**20)
    assert hw.cbuffer_bytes == 128 and hw.dram_bandwidth == 3.35e12
    assert hw.fast_bandwidth == pytest.approx(33.45e12, rel=1e-3)
    assert tplan.CobraPlan.from_hardware(1 << 20) == tplan.CobraPlan.from_hardware(1 << 20, hw)
    # the fused accumulator limit the slice relies on: 4.2M vertices fit
    # half of L2, 32M do not
    assert 4_194_304 * 4 <= hw.fast_levels[-1] // 2 < 32_000_000 * 4


def test_graph_suite_without_device_follows_the_device_rule():
    if torch.cuda.is_available():
        g = tgraph.graph_suite("smoke")["URND"]
        assert g.src.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.graph_suite("smoke")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.gen_uniform(16, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        coo_from_numpy(np.zeros(1), np.zeros(1), 1)


@pytest.mark.parametrize(
    "make_r,make_t",
    [
        (lambda: rgraph.gen_uniform(300, 3, seed=7), lambda: tgraph.gen_uniform(300, 3, seed=7, device="cpu")),
        (lambda: rgraph.gen_kron(8, 3, seed=7), lambda: tgraph.gen_kron(8, 3, seed=7, device="cpu")),
        (lambda: rgraph.gen_powerlaw(300, 3, seed=7), lambda: tgraph.gen_powerlaw(300, 3, seed=7, device="cpu")),
        (lambda: rgraph.gen_road(9, seed=7), lambda: tgraph.gen_road(9, seed=7, device="cpu")),
        (lambda: rgraph.gen_bubbles(9, seed=7), lambda: tgraph.gen_bubbles(9, seed=7, device="cpu")),
    ],
)
def test_generators_bit_identical_other_seeds(make_r, make_t):
    r, t = make_r(), make_t()
    np.testing.assert_array_equal(to_numpy(t.src), np.asarray(r.src))
    np.testing.assert_array_equal(to_numpy(t.dst), np.asarray(r.dst))


def test_cached_graph_roundtrip_in_own_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    calls = []

    def maker():
        calls.append(1)
        return tgraph._uniform_np(64, 4, 11)

    a = tgraph.cached_graph("u64", maker, device="cpu")
    b = tgraph.cached_graph("u64", maker, device="cpu")
    assert len(calls) == 1 and (tmp_path / "graphs" / "u64.npz").exists()
    np.testing.assert_array_equal(to_numpy(a.src), to_numpy(b.src))
    np.testing.assert_array_equal(to_numpy(b.dst), np.asarray(rgraph.gen_uniform(64, 4, seed=11).dst))

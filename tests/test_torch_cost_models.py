"""The port's cost models (``core/traffic.py``, ``roofline.py``) against the
JAX package's.

Every traffic term and every roofline property is evaluated on a grid of
stream sizes under three machines' ``HardwareModel`` fields (the paper's
Xeon, the reference's TPU model and the port's H100 model), carried to
the port by ``convert.hardware_from_fields``; the rooflines get the
reference's peaks passed explicitly. The models are float arithmetic in
the same order on both sides, so each term must equal the reference's to
rel 1e-12 (in practice exactly). The last tests pin the port's own
defaults: the H100's peaks, and no constant of the reference's TPU in
``repro_torch/roofline.py``.
"""
import dataclasses
import math
import re
from pathlib import Path

import pytest

from repro import roofline as RR
from repro.core import plan as RP
from repro.core import traffic as RT
from repro_torch import roofline as TR
from repro_torch.convert import hardware_from_fields, plan_from_fields
from repro_torch.core import plan as TP
from repro_torch.core import traffic as TT

REL = 1e-12
# the reference's roofline defaults, passed explicitly to both packages
REF_PEAKS = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
REF_HBM = 819e9
REF_ICI = 50e9

SIZES = [(1, 1), (17, 5), (1000, 64), (123_457, 9_999), (1 << 21, 1 << 17), (1 << 25, 1 << 22)]
MACHINES = ["xeon", "tpu_v5e", "h100"]


def _ref_hw(name):
    if name == "xeon":
        return RP.HardwareModel.cpu_xeon()
    if name == "tpu_v5e":
        return RP.HardwareModel.tpu_v5e()
    h = TP.HardwareModel.h100()
    return RP.HardwareModel(h.name, tuple(h.fast_levels), h.cbuffer_bytes, h.dram_bandwidth,
                            h.fast_bandwidth)


def _hws(name):
    ref = _ref_hw(name)
    port = hardware_from_fields(ref.name, ref.fast_levels, ref.cbuffer_bytes,
                                ref.dram_bandwidth, ref.fast_bandwidth)
    return ref, port


def _plans(n, ref_hw):
    ref = RP.CobraPlan.from_hardware(n, ref_hw)
    return ref, plan_from_fields(ref.num_indices, ref.final_bin_range, ref.level_fanouts)


def _same(got, want, what=""):
    """Equal to rel 1e-12: floats by value (inf and None as themselves),
    containers element by element, dicts by key."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{what}[{i}]")
    elif isinstance(want, float) and not math.isfinite(want):
        assert got == want, what
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=REL, abs=0.0), what
    else:
        assert got == want, what


# ---------------------------------------------------------------------------
# traffic: (name, call(module, hw, m, n, plan)) for every ported term
# ---------------------------------------------------------------------------


TRAFFIC_TERMS = {
    "expected_access_ns": lambda M, hw, m, n, p: [M.expected_access_ns(w, hw)
                                                  for w in (0, 1.0, 8.0 * n, 64.0 * m, 1e12)],
    "skewed_access_ns": lambda M, hw, m, n, p: [M.skewed_access_ns(w, hw)
                                                for w in (0, 1.0, 8.0 * n, 64.0 * m, 1e12)],
    "PhaseCost.seconds": lambda M, hw, m, n, p: [
        M.PhaseCost(8.0 * m, float(m), 4.0 * n, 1.5, sk).seconds(hw) for sk in (False, True)],
    "binning_cost": lambda M, hw, m, n, p: M.binning_cost(m, max(1, n // 7), hw).seconds(hw),
    "binread_cost": lambda M, hw, m, n, p: M.binread_cost(m, max(1, n // 3), hw).seconds(hw),
    "baseline_cost": lambda M, hw, m, n, p: [
        M.baseline_cost(m, n, hw, randoms_per_tuple=r, skewed=sk).seconds(hw)
        for r in (1.0, 2.0) for sk in (False, True)],
    "neighpop_baseline_seconds": lambda M, hw, m, n, p: M.neighpop_baseline_seconds(m, n, hw),
    "pr_edgelist_iter_seconds": lambda M, hw, m, n, p: M.pr_edgelist_iter_seconds(m, n, hw),
    "pr_pull_iter_seconds": lambda M, hw, m, n, p: M.pr_pull_iter_seconds(m, n, hw),
    "pr_pb_iter_seconds": lambda M, hw, m, n, p: M.pr_pb_iter_seconds(m, n, max(1, n // 5), hw),
    "pr_cobra_iter_seconds": lambda M, hw, m, n, p: M.pr_cobra_iter_seconds(m, p, hw),
    "pb_two_phase_stream_bytes": lambda M, hw, m, n, p: [
        M.pb_two_phase_stream_bytes(m, n), M.pb_two_phase_stream_bytes(m, n, 12, 8)],
    "fused_stream_bytes": lambda M, hw, m, n, p: [
        M.fused_stream_bytes(m, n), M.fused_stream_bytes(m, n, 12, 8)],
    "fused_cost": lambda M, hw, m, n, p: M.fused_cost(m, n, hw, 12, 8).seconds(hw),
    "fused_seconds": lambda M, hw, m, n, p: M.fused_seconds(m, n, hw),
    "pr_fused_iter_seconds": lambda M, hw, m, n, p: M.pr_fused_iter_seconds(m, n, hw),
    "sharded_fused_hbm_bytes_per_device": lambda M, hw, m, n, p: [
        M.sharded_fused_hbm_bytes_per_device(m, n, d) for d in (0, 1, 4, 7)],
    "sharded_exchange_bytes_per_device": lambda M, hw, m, n, p: [
        M.sharded_exchange_bytes_per_device(m, d, padded_capacity=c)
        for d in (1, 4, 7) for c in (None, m / 3.0)],
    "sharded_exchange_chunk_bytes_per_device": lambda M, hw, m, n, p: [
        M.sharded_exchange_chunk_bytes_per_device(m, d, k, padded_capacity=c)
        for d in (1, 4) for k in (0, 1, 3) for c in (None, 5.0)],
    "sharded_pipelined_exchange_bytes_per_device": lambda M, hw, m, n, p: [
        M.sharded_pipelined_exchange_bytes_per_device(m, d, k, padded_capacity=c)
        for d in (1, 4) for k in (1, 2, 4) for c in (None, 5.0)],
    "exchange_collective_launches": lambda M, hw, m, n, p: [
        M.exchange_collective_launches(k, pk) for k in (0, 1, 3) for pk in (True, False)],
    "sharded_fused_seconds_per_device": lambda M, hw, m, n, p: [
        M.sharded_fused_seconds_per_device(m, n, d, hw, ici_bandwidth=REF_ICI)
        for d in (1, 4, 7)],
    "preproc_stage_bytes": lambda M, hw, m, n, p: [
        M.preproc_stage_bytes(s, m, n, b)
        for s in ("degrees", "mapping", "relabel", "build_csr", "build_csc", "slack")
        for b in ("pb", "baseline")],
    "traversal_level_bytes": lambda M, hw, m, n, p: [
        M.traversal_level_bytes(e, n, meth)
        for e in (0, 1, m) for meth in ("fused", "unbinned", "sort")],
    "traversal_bytes": lambda M, hw, m, n, p: [
        M.traversal_bytes([0, 1, m // 3, m], n, meth) for meth in ("fused", "unbinned", "sort")],
    "ppr_batch_bytes": lambda M, hw, m, n, p: [
        M.ppr_batch_bytes(m, n, b, it) for b in (0, 1, 8) for it in (1, 20)],
    "serving_tick_bytes": lambda M, hw, m, n, p: [
        M.serving_tick_bytes([0, 3, m], n, b, meth) for b in (1, 8) for meth in ("fused", "sort")],
    "serving_query_bytes": lambda M, hw, m, n, p: [
        M.serving_query_bytes([0, 3, m], n, b, meth) for b in (1, 8) for meth in ("fused", "sort")],
    "update_batch_bytes": lambda M, hw, m, n, p: [
        M.update_batch_bytes(b, n, t, meth)
        for b in (0, 4096) for t in (None, 99) for meth in ("fused", "sort")],
    "update_rebuild_bytes": lambda M, hw, m, n, p: [
        M.update_rebuild_bytes(m, n, b, h) for b in ("pb", "baseline") for h in (0.25, 1.0)],
    "update_crossover_batch": lambda M, hw, m, n, p: [
        M.update_crossover_batch(m, n, [1, 64, 4096, 1 << 20, 1 << 26], meth)
        for meth in ("fused", "sort")],
    "spmm_ftile_sweeps": lambda M, hw, m, n, p: [
        M.spmm_ftile_sweeps(F, ft) for F in (0, 1, 64, 130) for ft in (None, 0, 3, 500)],
    "spmm_bytes": lambda M, hw, m, n, p: [
        M.spmm_bytes(m, n, F, meth, f_tile=ft) for F in (1, 64)
        for meth in ("fused", "segment_sum", "two_phase") for ft in (None, 16)],
    "spmm_access_seconds": lambda M, hw, m, n, p: [
        M.spmm_access_seconds(m, n, F, meth, hw, bin_range=r, f_tile=ft) for F in (1, 64)
        for meth in ("fused", "segment_sum", "two_phase") for r in (None, 7) for ft in (None, 16)],
    "spmm_crossover_f": lambda M, hw, m, n, p: [
        M.spmm_crossover_f(m, n, [1, 2, 8, 64, 256], b, f_tile=ft)
        for b in ("two_phase", "segment_sum") for ft in (None, 4)],
    "pb_seconds": lambda M, hw, m, n, p: M.pb_seconds(m, n, max(1, n // 5), hw),
    "pb_ideal_seconds": lambda M, hw, m, n, p: M.pb_ideal_seconds(m, n, hw),
    "cobra_seconds": lambda M, hw, m, n, p: M.cobra_seconds(m, p, hw),
    "baseline_seconds": lambda M, hw, m, n, p: M.baseline_seconds(m, n, hw),
}


@pytest.mark.parametrize("size", SIZES, ids=[f"m{m}n{n}" for m, n in SIZES])
@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("term", sorted(TRAFFIC_TERMS))
def test_traffic_term_equals_the_reference(term, machine, size):
    m, n = size
    ref_hw, hw = _hws(machine)
    ref_plan, plan = _plans(n, ref_hw)
    fn = TRAFFIC_TERMS[term]
    _same(fn(TT, hw, m, n, plan), fn(RT, ref_hw, m, n, ref_plan), term)


def test_every_reference_traffic_function_has_a_twin_here():
    public = {k for k, v in vars(RT).items()
              if callable(v) and not k.startswith("_") and getattr(v, "__module__", "") == RT.__name__}
    assert public <= set(vars(TT)), sorted(public - set(vars(TT)))
    tested = {t.split(".")[0] for t in TRAFFIC_TERMS}
    untested = public - tested - {"degrees_stage_bytes", "mapping_stage_bytes",
                                  "relabel_stage_bytes", "csr_build_stage_bytes",
                                  "slack_build_stage_bytes"}  # through preproc_stage_bytes
    assert not untested, sorted(untested)


# ---------------------------------------------------------------------------
# rooflines: every property and method, reference peaks passed explicitly
# ---------------------------------------------------------------------------


def _props(obj, extra=()):
    """Every public property of ``obj``'s class, plus the named calls."""
    names = [k for k, v in vars(type(obj)).items() if isinstance(v, property)]
    out = {k: getattr(obj, k) for k in names}
    for name, args in extra:
        out[f"{name}{args}"] = getattr(obj, name)(*args)
    return out


def _rooflines(M, m, n):
    levels = (0, 3, m // 5, m, 7)
    return {
        "Roofline": (M.Roofline("arch", "shape", "mesh", 4, 3e15 * (m % 7 + 1), 8.0 * m, 1e3 * n,
                                2.5e15, **REF_PEAKS, memory_fit="fits",
                                collective_detail={"all-reduce": 1.0 * n}), [("row", ())]),
        "PBStreamRoofline": (M.PBStreamRoofline(m, n, 12, 8, hbm_bw=REF_HBM), []),
        "SpMMRoofline": (M.SpMMRoofline(m, n, 64, 16, hbm_bw=REF_HBM),
                         [("crossover_f", ([1, 4, 64],)),
                          ("crossover_f", ([1, 4, 64], "segment_sum"))]),
        "ShardedPBStreamRoofline": (
            M.ShardedPBStreamRoofline(m, n, 4, hbm_bw=REF_HBM, ici_bw=REF_ICI, pipeline_chunks=2),
            [("t_pipelined", (k,)) for k in (None, 1, 3, 8)]
            + [("hidden_exchange_fraction", (k,)) for k in (None, 1, 4)]
            + [("overlap_efficiency", (k,)) for k in (None, 1, 4)]
            + [("best_pipeline_chunks", (c,)) for c in (1, 4, 16)]),
        "ShardedPBStreamRoofline_padded": (
            M.ShardedPBStreamRoofline(m, n, 8, hbm_bw=REF_HBM, ici_bw=REF_ICI,
                                      padded_capacity=m / 8.0), [("t_pipelined", (2,))]),
        "ShardedPBStreamRoofline_one": (
            M.ShardedPBStreamRoofline(m, n, 1, hbm_bw=REF_HBM, ici_bw=REF_ICI),
            [("hidden_exchange_fraction", (2,))]),
        "TraversalRoofline": (M.TraversalRoofline(levels, n, hbm_bw=REF_HBM), []),
        "ServingRoofline": (M.ServingRoofline(float(n), 8, 1e-6 * (m % 1000 + 1)), []),
        "ServingRoofline_saturated": (M.ServingRoofline(1e9, 1, 1.0), []),
        "UpdateRoofline": (M.UpdateRoofline(m, n, 4096, hbm_bw=REF_HBM),
                           [("crossover_batch", ([1, 4096, 1 << 22, 1 << 28],))]),
        "UpdateRoofline_sort": (M.UpdateRoofline(m, n, 64, "sort", "baseline", hbm_bw=REF_HBM), []),
        "PreprocessRoofline": (M.PreprocessRoofline(m, n, hbm_bw=REF_HBM),
                               [("amortization_iters", (8.0 * m, 4.0 * m)),
                                ("amortization_iters", (4.0 * m, 8.0 * m))]),
        "PreprocessRoofline_single": (M.PreprocessRoofline(m, n, False, "baseline",
                                                           hbm_bw=REF_HBM), []),
    }


ROOFLINES = sorted(_rooflines(TR, 8, 2))


@pytest.mark.parametrize("size", SIZES, ids=[f"m{m}n{n}" for m, n in SIZES])
@pytest.mark.parametrize("name", ROOFLINES)
def test_roofline_properties_equal_the_reference(name, size):
    m, n = size
    got, extra = _rooflines(TR, m, n)[name]
    want, _ = _rooflines(RR, m, n)[name]
    _same(_props(got, extra), _props(want, extra), name)


@pytest.mark.parametrize("layers", [3, 94])
def test_extrapolate_equals_the_reference(layers):
    a = dict(flops=1e12, bytes_accessed=5e9, collective={"all-reduce": 1e6, "all-gather": 2.0},
             num_layers=2)
    b = dict(flops=3e12, bytes_accessed=7e9, collective={"all-reduce": 3e6, "all-to-all": 5.0},
             num_layers=6)
    got = TR.extrapolate(TR.CellCost(**a), TR.CellCost(**b), layers)
    want = RR.extrapolate(RR.CellCost(**a), RR.CellCost(**b), layers)
    _same(dataclasses.asdict(got), dataclasses.asdict(want))


def test_every_reference_roofline_class_has_a_twin_here():
    classes = {k for k, v in vars(RR).items() if isinstance(v, type) and v.__module__ == RR.__name__}
    assert classes <= set(vars(TR)), sorted(classes - set(vars(TR)))
    # the XLA-only terms are shims with no twin
    assert not {"hlo_bytes_accessed", "collective_bytes_from_hlo", "shape_bytes"} & set(vars(TR))


# ---------------------------------------------------------------------------
# the port's defaults
# ---------------------------------------------------------------------------


def test_the_defaults_are_the_h100s():
    assert (TP.H100_BF16_FLOPS, TP.H100_HBM_BW, TP.H100_NVLINK_BW) == (989e12, 3.35e12, 900e9)
    assert TP.HardwareModel.h100().dram_bandwidth == TP.H100_HBM_BW
    r = TR.Roofline("a", "s", "m", 1, 1.0, 1.0, 1.0, 1.0)
    assert (r.peak_flops, r.hbm_bw, r.ici_bw) == (989e12, 3.35e12, 900e9)
    sharded = TR.ShardedPBStreamRoofline(1, 1, 2)
    assert (sharded.hbm_bw, sharded.ici_bw) == (3.35e12, 900e9)
    for obj in (TR.PBStreamRoofline(1, 1), TR.SpMMRoofline(1, 1, 1), TR.TraversalRoofline((1,), 1),
                TR.UpdateRoofline(1, 1, 1), TR.PreprocessRoofline(1, 1)):
        assert obj.hbm_bw == 3.35e12, type(obj).__name__
    assert TT.ICI_BANDWIDTH == 900e9
    # the sharded seconds' default interconnect is NVLink: 2 (n-1)/n^2 m tuples over 900 GB/s
    hw = TP.HardwareModel.h100()
    m = 1 << 20
    local = TT.fused_cost(m // 4, 1 << 14, hw).seconds(hw)
    exch = TT.sharded_exchange_bytes_per_device(m, 4)
    assert TT.sharded_fused_seconds_per_device(m, 1 << 16, 4, hw) == local + exch / 900e9


def test_no_tpu_constant_in_the_port_roofline():
    src = Path(TR.__file__).read_text()
    for pat in (r"197e12", r"819e9", r"50e9", r"\btpu", r"v5e", r"\bICI\b", r"\bVMEM\b"):
        assert not re.search(pat, src, flags=re.IGNORECASE), pat

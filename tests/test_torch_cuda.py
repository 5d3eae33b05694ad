"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with ``nvcc`` and skip elsewhere (a CUDA
kernel has no CPU mode). They import neither JAX nor ``repro``, so they
also run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Histogram (uniform, one-key, hub, 13-bin zipf and out-of-range streams,
and views off a 16-byte boundary), positions (both designs: onesweep and
three-phase), the COBRA pass (both designs: onesweep and three-phase)
and the row scatter must be equal; the fused reduces (flat,
in both designs, and rows) are exact for int32 and min/max, and a
float32 add (fused or Bin-Read) may differ from the sequential sum by at
most 1e-5 of the magnitudes summed at an index (the order in which the
atomics land changes from run to run); bfloat16 Bin-Read within 1e-1.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pb import starts_from_counts
from repro_torch.kernels import ref as tref
from repro_torch.kernels.binning import (
    COBRA_ONESWEEP_MAX_BINS, cobra_binning_pass, cobra_pass_design, counting_positions)
from repro_torch.kernels.binread import binread_scatter_add
from repro_torch.kernels.fused import (
    cobra_bin_accumulate, cobra_bin_accumulate_rows, fused_plan)
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.scatter_rows import scatter_rows


def _rng(seed=0):
    return np.random.default_rng(seed)


def _stream(n, m, seed, dtype):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m).astype(np.int32)
    if dtype == np.int32:
        return idx, rng.integers(-50, 50, m).astype(np.int32)
    return idx, rng.normal(size=m).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _histogram_streams(m, num_bins, seed):
    """Keys of the histogram's skewed streams: uniform, one key, a hub (half
    of the stream on one key), the embedding gradient's 13-bin zipf ids
    (bin_range 4096 over 50,304 ids), and keys outside [0, num_bins),
    negatives included."""
    rng = _rng(seed)
    uniform = rng.integers(0, num_bins, m)
    hub = np.where(rng.random(m) < 0.5, num_bins // 3, uniform)
    zipf = np.minimum((rng.pareto(1.2, m) * 50).astype(np.int64), 50_303) // 4096
    outside = rng.integers(-num_bins - 3, 2 * num_bins + 3, m)
    return {"uniform": uniform, "one-key": np.full(m, num_bins - 1), "hub": hub, "zipf": zipf,
            "outside": outside}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 17, 5000, 300_001])
@pytest.mark.parametrize("num_bins", [2, 13, 257, 908, 65536])
def test_cuda_histogram_and_positions_match_plain(cuda, m, num_bins):
    for keys in _histogram_streams(m, num_bins, m).values():
        k = torch.from_numpy(keys.astype(np.int32)).to(cuda)
        counts = histogram(k, num_bins)
        assert torch.equal(counts, tref.histogram_ref(k, num_bins))
        starts = starts_from_counts(counts)[:-1].contiguous()
        assert torch.equal(
            counting_positions(k, starts, num_bins),
            tref.counting_positions_ref(k, starts, num_bins),
        )


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [1, 3, 4, 7, 8, 1023, 4097, 1 << 20])
@pytest.mark.parametrize("num_bins", [13, 512, 2203, 12288, 12289])
def test_cuda_histogram_unaligned_views(cuda, offset, m, num_bins):
    """A view that starts off a 16-byte boundary: the kernel counts the keys
    before the first boundary and after the last whole vector one by one."""
    for keys in _histogram_streams(m + offset, num_bins, m).values():
        k = torch.from_numpy(keys.astype(np.int32)).to(cuda)[offset:]
        assert torch.equal(histogram(k, num_bins), tref.histogram_ref(k, num_bins))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_cuda_fused_matches_plain(cuda, dtype, op):
    n = 100_003
    idx, val = _stream(n, 1_000_003, 7, dtype)
    idx[::97] = -1
    ti, tv = torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda)
    for r in (1024, n):
        got = cobra_bin_accumulate(ti, tv, n, r, -(-n // r), op)
        want = tref.scatter_reduce_ref(ti, tv, n, op)
        if dtype == np.int32 or op != "add":
            assert torch.equal(got, want)
        else:  # order of the atomics: 1e-5 of the magnitudes summed
            scale = tref.scatter_reduce_ref(ti, tv.abs(), n, "add")
            assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


# -- the one-pass designs: positions (onesweep) and fused (two-pass) ---------
# Positions must equal the plain version in both designs; the fused
# reduce is exact for int32 and min/max, float32 add within 1e-5 of the
# magnitudes summed at an index (as above).

POS_TILE = 16384  # csrc/positions.cu kPosTile: one onesweep tile
BIN_TILE = 8192  # csrc/fused.cu kBinTile: one tile of the two-pass binning


def _positions_vs_plain(keys, num_bins, design=None):
    starts = starts_from_counts(tref.histogram_ref(keys, num_bins))[:-1].contiguous()
    got = counting_positions(keys, starts, num_bins, design=design)
    want = tref.counting_positions_ref(keys, starts, num_bins)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [POS_TILE - 1, POS_TILE, POS_TILE + 1, 3 * POS_TILE + 1])
@pytest.mark.parametrize("num_bins", [2, 512, 2048])
@pytest.mark.parametrize("design", ["onesweep", "three-phase"])
def test_cuda_positions_at_tile_edges(cuda, m, num_bins, design):
    rng = _rng(m + num_bins)
    keys = rng.integers(-2, num_bins + 2, m).astype(np.int32)  # a few out of range
    _positions_vs_plain(torch.from_numpy(keys).to(cuda), num_bins, design)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bins", [2047, 2048, 2049, 4096])
def test_cuda_positions_on_both_sides_of_the_design_switch(cuda, num_bins):
    from repro_torch.kernels.binning import ONESWEEP_MAX_BINS, positions_design

    assert positions_design(num_bins) == ("onesweep" if num_bins <= ONESWEEP_MAX_BINS
                                          else "three-phase")
    keys = torch.from_numpy(_rng(num_bins).integers(0, num_bins, 200_003).astype(np.int32))
    _positions_vs_plain(keys.to(cuda), num_bins)
    if num_bins > ONESWEEP_MAX_BINS:
        with pytest.raises(ValueError, match="at most"):
            _positions_vs_plain(keys.to(cuda), num_bins, "onesweep")


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["one-key", "out-of-range", "empty-tiles"])
def test_cuda_positions_skewed_streams(cuda, stream):
    m, B = 5 * POS_TILE + 7, 512
    keys = _rng(3).integers(0, B, m).astype(np.int32)
    if stream == "one-key":
        keys[:] = B // 3
    elif stream == "out-of-range":
        keys[:] = np.where(keys % 2, -5, B)
    else:  # whole tiles of out-of-range keys between tiles of real ones
        keys[POS_TILE:3 * POS_TILE] = B + 1
    _positions_vs_plain(torch.from_numpy(keys).to(cuda), B)


@pytest.mark.cuda
def test_cuda_positions_past_2_to_the_30(cuda):
    """m = 2^30 + 17 with B = 2: each bin's count exceeds 2^29 and the
    later tiles' prefixes exceed 2^30, which a 30-bit count packed beside
    a 2-bit flag would cut (the status words are 64-bit)."""
    m = (1 << 30) + 17
    keys = (torch.arange(m, device=cuda, dtype=torch.int32) % 3 == 0).to(torch.int32)
    _positions_vs_plain(keys, 2)


def _fused_ok(got, want, ti, tv, n, op):
    if tv.dtype == torch.int32 or op != "add":
        return torch.equal(got, want)
    scale = tref.scatter_reduce_ref(ti, tv.abs(), n, "add")
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def _fused_values(m, dtype, cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-50, 50, (m,), device=cuda, generator=gen, dtype=torch.int32)
    return torch.randn(m, device=cuda, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["one-key", "hub"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("design", ["two-pass", "single-sweep"])
def test_cuda_fused_skewed_streams(cuda, stream, dtype, op, design):
    """2^25 tuples at S2's n: all to one index, or half of them to one hub
    (the S1 DBP shape of skew): the hot slab is cut into chunks."""
    n, m = 1 << 22, 1 << 25
    gen = torch.Generator(device=cuda).manual_seed(11)
    ti = torch.randint(0, n, (m,), device=cuda, generator=gen, dtype=torch.int32)
    if stream == "one-key":
        ti.fill_(n // 3 + 5)
    else:
        ti[torch.rand(m, device=cuda, generator=gen) < 0.5] = 12_345
    tv = _fused_values(m, dtype, cuda, 12)
    got = cobra_bin_accumulate(ti, tv, n, 8192, n // 8192, op, design=design)
    assert _fused_ok(got, tref.scatter_reduce_ref(ti, tv, n, op), ti, tv, n, op)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, BIN_TILE - 1, BIN_TILE, BIN_TILE + 1, 300_001])
@pytest.mark.parametrize("n", [50, 100_003, 1 << 22])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_cuda_fused_two_pass_at_tile_edges(cuda, m, n, dtype, op):
    """The two-pass design forced at small m: ragged tiles, a last slab
    shorter than the others, untouched slabs, out-of-range tuples."""
    idx = _rng(m).integers(-3, n + 3, m).astype(np.int32)
    ti = torch.from_numpy(idx).to(cuda)
    tv = _fused_values(m, dtype, cuda, m)
    r = min(n, 4096)
    got = cobra_bin_accumulate(ti, tv, n, r, -(-n // r), op, design="two-pass")
    assert _fused_ok(got, tref.scatter_reduce_ref(ti, tv, n, op), ti, tv, n, op)


RED_STAGE = 4096  # csrc/fused.cu kRedStage: tuples a reduce stage holds
BIN_STAGES, RED_STAGES = 2, 3  # csrc/fused.cu kBinStages, kRedStages: the rings' depths


def _two_pass_vs_plain(ti, tv, n, op):
    got = cobra_bin_accumulate(ti, tv, n, 512, -(-n // 512), op, design="two-pass")
    return _fused_ok(got, tref.scatter_reduce_ref(ti, tv, n, op), ti, tv, n, op)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles, extra", [(1, 0), (BIN_STAGES, -1), (BIN_STAGES, 0),
                                          (BIN_STAGES, 1), (3 * BIN_STAGES, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_fused_two_pass_at_ring_edges(cuda, tiles, extra, dtype):
    """The binning ring at its edges: one tile, and every persistent
    block's ring of stages used once (one tuple short of it, exactly, one
    tuple more: a block's second phase of a stage) and three times over."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    m = (1 if tiles == 1 else sms * tiles) * BIN_TILE + extra
    n = 1 << 20
    ti = torch.randint(0, n, (m,), device=cuda, generator=torch.Generator(device=cuda)
                       .manual_seed(m), dtype=torch.int32)
    tv = _fused_values(m, dtype, cuda, m)
    for op in ("add", "min", "max"):
        assert _two_pass_vs_plain(ti, tv, n, op), op


@pytest.mark.cuda
@pytest.mark.parametrize("per_slab", [1, RED_STAGE - 1, RED_STAGE, RED_STAGE + 1,
                                      RED_STAGES * RED_STAGE, RED_STAGES * RED_STAGE + 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_fused_two_pass_at_reduce_stage_edges(cuda, per_slab, dtype):
    """Two slabs of 256 (n = 512) holding per_slab tuples each: a work item
    of one stage less or more one tuple, and of the whole ring of stages."""
    n = 512
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fused_plan(2 * per_slab, n, sms)[:2] == (8, 2)
    gen = torch.Generator(device=cuda).manual_seed(per_slab)
    ti = torch.cat([torch.randint(b * 256, (b + 1) * 256, (per_slab,), device=cuda, generator=gen,
                                  dtype=torch.int32) for b in range(2)])
    ti = ti[torch.randperm(ti.shape[0], device=cuda, generator=gen)]
    tv = _fused_values(ti.shape[0], dtype, cuda, per_slab)
    for op in ("add", "min", "max"):
        assert _two_pass_vs_plain(ti, tv, n, op), op


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_cuda_fused_two_pass_splits_a_slab_into_chunks(cuda, extra):
    """16 slabs of 256; slab 0 holds four chunks (half the stream) less or
    more one tuple, so its last work item holds a tuple or none past the
    fourth; the first chunk stores the slab, the others merge."""
    n, m = 4096, 1 << 20
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    shift, slabs, chunk = fused_plan(m, n, sms)
    assert (shift, slabs, chunk) == (8, 16, m // 8)
    gen = torch.Generator(device=cuda).manual_seed(7)
    hot = 4 * chunk + extra
    ti = torch.cat([torch.randint(0, 256, (hot,), device=cuda, generator=gen, dtype=torch.int32),
                    torch.randint(256, n, (m - hot,), device=cuda, generator=gen,
                                  dtype=torch.int32)])
    ti = ti[torch.randperm(m, device=cuda, generator=gen)]
    for dtype in (torch.float32, torch.int32):
        tv = _fused_values(m, dtype, cuda, 8)
        for op in ("add", "min", "max"):
            assert _two_pass_vs_plain(ti, tv, n, op), (dtype, op)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_fused_two_pass_unaligned_views(cuda, dtype):
    """idx and val that start off a 16-byte boundary (views one element
    in) go to the bulk copies as aligned copies: the result is the aligned
    call's, bit for bit for int32, and the plain version's."""
    m, n = 3 * BIN_TILE + 5, 1 << 16
    gen = torch.Generator(device=cuda).manual_seed(3)
    ti = torch.randint(0, n, (m + 1,), device=cuda, generator=gen, dtype=torch.int32)
    tv = _fused_values(m + 1, dtype, cuda, 4)
    for a, b in ((1, 0), (0, 1), (1, 1)):
        vi, vv = ti[a:a + m], tv[b:b + m]
        assert (vi.data_ptr() % 16 != 0) == bool(a) and (vv.data_ptr() % 16 != 0) == bool(b)
        got = cobra_bin_accumulate(vi, vv, n, 512, n // 512, design="two-pass")
        assert _fused_ok(got, tref.scatter_reduce_ref(vi, vv, n), vi, vv, n, "add")
        if dtype == torch.int32:
            assert torch.equal(got, cobra_bin_accumulate(vi.clone(), vv.clone(), n, 512, n // 512,
                                                         design="two-pass"))


@pytest.mark.cuda
def test_cuda_fused_design_rule(cuda):
    from repro_torch.kernels.fused import (
        TWO_PASS_MAX_INDICES, TWO_PASS_MIN_M, fused_design)

    assert fused_design(TWO_PASS_MIN_M, 1 << 22) == "two-pass"
    assert fused_design(TWO_PASS_MIN_M - 1, 1 << 22) == "single-sweep"
    assert fused_design(1 << 25, TWO_PASS_MAX_INDICES + 1) == "single-sweep"
    ti = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        cobra_bin_accumulate(ti, torch.ones(4, device=cuda), TWO_PASS_MAX_INDICES + 1,
                             1 << 20, 65, design="two-pass")
    before = cobra_bin_accumulate.launches
    cobra_bin_accumulate(ti, torch.ones(4, device=cuda), 8, 8, 1, design="two-pass")
    assert cobra_bin_accumulate.launches == before + 1


# -- the kernels of the second slice ----------------------------------------
# Rows reduce: int32 and min/max equal, float32 add within 1e-5 of the
# magnitudes summed per entry (order of the atomics). COBRA pass, row
# scatter: equal (bit copies). Bin-Read: float32 within 1e-5 of the
# summed magnitudes, bfloat16 within atol 1e-1 (tests/test_kernels.py).


def _rows_ok(got, want, ti, tv, n, op):
    if tv.dtype == torch.int32 or op != "add":
        return torch.equal(got, want)
    scale = tref.scatter_reduce_ref(ti, tv.abs(), n, "add")
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("F", [1, 3, 8, 7, 128, 260])
@pytest.mark.parametrize("order", ["random", "sorted"])
def test_cuda_rows_matches_plain(cuda, dtype, op, F, order):
    n, m = 5003, 40_007
    rng = _rng(F)
    idx = rng.integers(0, n, m).astype(np.int32)
    if order == "sorted":
        idx.sort()
    idx[::101] = -1
    idx[::103] = n + 7
    ti = torch.from_numpy(idx).to(cuda)
    if dtype == torch.int32:
        tv = torch.from_numpy(rng.integers(-50, 50, (m, F)).astype(np.int32)).to(cuda)
    else:
        tv = torch.from_numpy(rng.normal(size=(m, F)).astype(np.float32)).to(cuda)
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, -(-n // 512), op, f_tile=1)
    want = tref.scatter_reduce_ref(ti, tv, n, op)
    assert got.shape == (n, F) and _rows_ok(got, want, ti, tv, n, op)


@pytest.mark.cuda
def test_cuda_rows_edges(cuda):
    ti = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = cobra_bin_accumulate_rows(ti, torch.zeros(0, 4, device=cuda), 10, 5, 2, "min")
    assert out.shape == (10, 4) and bool((out == torch.finfo(torch.float32).max).all())
    ti = torch.arange(6, dtype=torch.int32, device=cuda)
    assert cobra_bin_accumulate_rows(ti, torch.zeros(6, 0, device=cuda), 6, 3, 2).shape == (6, 0)
    # a strided view is refused, never copied behind the caller's back
    with pytest.raises(ValueError, match="contiguous"):
        cobra_bin_accumulate_rows(ti, torch.zeros(4, 6, device=cuda).t(), 6, 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [65536 * 128 + 4, 65536 * 32 + 1])
def test_cuda_rows_wider_than_the_grid(cuda, F):
    """More column slices than grid.y holds (65,535): the tile walk gives
    each block a run of slices (16-byte lanes, then scalar lanes)."""
    n = 3
    gen = torch.Generator(device=cuda).manual_seed(F)
    ti = torch.tensor([0, 2, 0, 1, -1], dtype=torch.int32, device=cuda)
    tv = torch.randn(5, F, device=cuda, generator=gen)
    got = cobra_bin_accumulate_rows(ti, tv, n, 2, 2, "add")
    want = tref.scatter_reduce_ref(ti, tv, n, "add")
    assert got.shape == (n, F) and _rows_ok(got, want, ti, tv, n, "add")


@pytest.mark.cuda
def test_cuda_rows_past_int32_elements(cuda):
    """m * F > 2^31: the rows are addressed with 64-bit offsets."""
    n, m, F = 1 << 20, (1 << 25) + 3, 64
    gen = torch.Generator(device=cuda).manual_seed(1)
    ti = torch.randint(0, n, (m,), device=cuda, generator=gen, dtype=torch.int32).sort().values
    tv = torch.randn(m, F, device=cuda, generator=gen)
    assert m * F > 2**31
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, n // 512, "add")
    want = tref.scatter_reduce_ref(ti, tv, n, "add")
    del tv
    assert bool(((got - want).abs() <= 1e-4 * want.abs().max() + 1e-6).all())
    assert float(got[-1].abs().sum()) > 0  # the last rows were reached


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4095, 4097, 8191, 8192, 8193, 300_001])
@pytest.mark.parametrize("num_bins", [1, 2, 257, 2203, 4096, 4097, 12288])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("design", ["onesweep", "three-phase"])
def test_cuda_cobra_pass_matches_plain(cuda, m, num_bins, dtype, design):
    """Both designs around their tiles (4096 tuples three-phase, 8192
    onesweep) and on both sides of the onesweep design's 4096 bins."""
    rng = _rng(m + num_bins)
    keys = torch.from_numpy(rng.integers(0, num_bins, m).astype(np.int32)).to(cuda)
    for k in (keys, torch.full_like(keys, num_bins // 2)):
        idx = torch.from_numpy(rng.integers(0, 1 << 30, m).astype(np.int32)).to(cuda)
        val = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(cuda)
        val = val if dtype == torch.float32 else val.view(torch.int32)
        starts = starts_from_counts(tref.histogram_ref(k, num_bins))[:-1].contiguous()
        if design == "onesweep" and num_bins > COBRA_ONESWEEP_MAX_BINS:
            with pytest.raises(ValueError, match="onesweep"):
                cobra_binning_pass(k, idx, val, starts, num_bins, design=design)
            return
        got = cobra_binning_pass(k, idx, val, starts, num_bins, design=design)
        want = tref.binned_stream_ref(k, idx, val, num_bins)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1].dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["one-key", "hub", "clustered"])
@pytest.mark.parametrize("num_bins", [289, 2203, 4096])
@pytest.mark.parametrize("design", ["onesweep", "three-phase"])
def test_cuda_cobra_pass_skewed_streams(cuda, stream, num_bins, design):
    """Skewed keys at 3 x 2^20 tuples: one key; a hub taking half of the
    stream; keys sorted by a coarser level (a second COBRA level's input),
    so a tile sees a few bins."""
    m = 3 << 20
    gen = torch.Generator(device=cuda).manual_seed(num_bins)
    keys = torch.randint(0, num_bins, (m,), device=cuda, generator=gen, dtype=torch.int32)
    if stream == "one-key":
        keys.fill_(num_bins - 1)
    elif stream == "hub":
        keys[torch.rand(m, device=cuda, generator=gen) < 0.5] = num_bins // 3
    else:
        keys = torch.sort(keys).values
    idx = torch.arange(m, device=cuda, dtype=torch.int32)
    val = torch.randn(m, device=cuda, generator=gen)
    starts = starts_from_counts(tref.histogram_ref(keys, num_bins))[:-1].contiguous()
    got = cobra_binning_pass(keys, idx, val, starts, num_bins, design=design)
    want = tref.binned_stream_ref(keys, idx, val, num_bins)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_cobra_pass_design_rule(cuda):
    assert cobra_pass_design(COBRA_ONESWEEP_MAX_BINS) == "onesweep"
    assert cobra_pass_design(COBRA_ONESWEEP_MAX_BINS + 1) == "three-phase"
    k = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="design"):
        cobra_binning_pass(k, k, k, torch.zeros(2, dtype=torch.int32, device=cuda), 2,
                           design="radix")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,R,d", [(4, 16, 8, 1), (8, 64, 32, 4), (16, 128, 128, 8),
                                     (3, 1000, 64, 6), (5, 3001, 100, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_binread_matches_plain(cuda, B, L, R, d, dtype):
    rng = _rng(B * L + d)
    idx = np.stack([rng.integers(b * R, (b + 1) * R, L) for b in range(B)]).astype(np.int32)
    idx[:, -3:] = -1
    idx[0, : L // 2] = 1  # a hot index: duplicates coalesce
    ti = torch.from_numpy(idx).to(cuda)
    tv = torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32)).to(cuda).to(dtype)
    got = binread_scatter_add(ti, tv, R)
    want = tref.binread_scatter_add_ref(ti, tv, R)
    assert got.dtype == dtype and got.shape == (B * R, d)
    if dtype == torch.bfloat16:
        assert bool(((got.float() - want.float()).abs() <= 1e-1).all())
    else:
        scale = tref.binread_scatter_add_ref(ti, tv.abs(), R)
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


# Bin-Read's tile-sorted design (csrc/binread.cu): 4096-position tiles of one
# bin row, a counting sort by local index, runs applied with vector
# reductions, a side path for in-range indices outside their bin. bfloat16
# sums can reach |x| ~ 100 here (one index over every row of a bin): held
# within one bfloat16 rounding step of the plain output, 2^-7 |want|, plus
# the reference's atol 1e-1.
BINREAD_CASES = ["all-padding", "mid-row-padding", "out-of-bin", "out-of-range", "one-index",
                 "wide-range"]


def _binread_layout(case, B, L, d, seed):
    """(idx, val, R) of one padded layout; idx as int64 numpy, val float32."""
    rng = _rng(seed)
    R = 5000 if case == "wide-range" else 64  # 5000 > the sort's 4096 keys: all on the side path
    idx = np.stack([rng.integers(b * R, (b + 1) * R, L) for b in range(B)]).astype(np.int64)
    hit = rng.random(idx.shape)
    if case == "all-padding":  # every other bin holds nothing but padding
        idx[1::2] = -1
    elif case == "mid-row-padding":
        idx[hit < 0.3] = -1
    elif case == "out-of-bin":  # in range, but in another bin's range
        idx[hit < 0.2] = rng.integers(0, B * R, int((hit < 0.2).sum()))
    elif case == "out-of-range":  # dropped wherever they stand: < -1 and >= B * R too
        idx[hit < 0.3] = rng.choice([-1, -2, -1000, B * R, B * R + 7, 2**31 - 1],
                                    int((hit < 0.3).sum()))
    elif case == "one-index":  # one index over every row of bin 0: runs across tiles
        idx[0] = 3
    idx[:, -5:] = -1
    val = rng.normal(size=(B, L, d)).astype(np.float32)
    return idx, val, R


def _binread_ok(got, want, scale, dtype):
    if dtype == torch.bfloat16:
        diff = (got.float() - want.float()).abs()
        return bool((diff <= 2.0**-7 * want.float().abs() + 1e-1).all())
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", BINREAD_CASES)
@pytest.mark.parametrize("d", [1, 3, 256, 1000])
@pytest.mark.parametrize("L", [9000, 9001])  # three tiles; 9001: indices off a 16-byte row
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_binread_edge_streams(cuda, case, d, L, dtype):
    B = 3
    idx, val, R = _binread_layout(case, B, L, d, seed=d + L)
    ti = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    tv = torch.from_numpy(val).to(cuda).to(dtype)
    before = binread_scatter_add.launches
    got = binread_scatter_add(ti, tv, R)
    want = tref.binread_scatter_add_ref(ti, tv, R)
    scale = tref.binread_scatter_add_ref(ti, tv.abs(), R).float()
    torch.cuda.synchronize()
    assert binread_scatter_add.launches == before + 1
    assert got.dtype == dtype and got.shape == (B * R, d)
    assert _binread_ok(got, want, scale, dtype)
    if case == "all-padding":
        assert not bool(got[R:2 * R].any())  # a bin no tuple reaches stays zero


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_binread_unaligned_values(cuda, d, dtype):
    """val one element past an aligned start: the kernel takes scalar
    columns instead of 16- or 8-byte loads and vector reductions."""
    B, L = 2, 5003
    idx, val, R = _binread_layout("out-of-bin", B, L, d, seed=d)
    ti = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    flat = torch.zeros(B * L * d + 1, device=cuda, dtype=dtype)
    tv = flat[1:].view(B, L, d)
    tv.copy_(torch.from_numpy(val).to(cuda).to(dtype))
    assert tv.data_ptr() % 16 != 0
    got = binread_scatter_add(ti, tv, R)
    want = tref.binread_scatter_add_ref(ti, tv, R)
    scale = tref.binread_scatter_add_ref(ti, tv.abs(), R).float()
    assert _binread_ok(got, want, scale, dtype)


# The narrow-row walk of csrc/pb_rows.cuh (rows of at most 4 lanes: F <= 16
# with 16-byte loads, F <= 4 otherwise) against the plain version, around
# it (F = 31, 32 take the wide walk): sorted, random, long runs that cross
# a step and a chunk, one destination for the whole stream, and indices
# out of range (negative ones too). m is not a multiple of 32.
ROWS_ORDERS = ["sorted", "random", "runs", "one-destination"]


def _rows_stream(order, n, m, seed):
    rng = _rng(seed)
    if order == "one-destination":
        idx = np.full(m, n // 2, np.int64)
    elif order == "runs":  # runs of 1 to 300 rows
        idx = np.repeat(rng.integers(0, n, m // 50), rng.integers(1, 300, m // 50))[:m]
    else:
        idx = rng.integers(0, n, m)
        if order == "sorted":
            idx.sort()
    bad = rng.random(m) < 0.01
    idx[bad] = rng.choice([-1, -7, n, n + 11], int(bad.sum()))
    return idx.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 8, 12, 16, 31, 32])
@pytest.mark.parametrize("order", ROWS_ORDERS)
def test_cuda_rows_narrow_walk(cuda, dtype, op, F, order):
    n, m = 3001, 100_003
    ti = torch.from_numpy(_rows_stream(order, n, m, seed=F)).to(cuda)
    rng = _rng(F + 1)
    if dtype == torch.int32:
        tv = torch.from_numpy(rng.integers(-50, 50, (m, F)).astype(np.int32)).to(cuda)
    else:
        tv = torch.from_numpy(rng.normal(size=(m, F)).astype(np.float32)).to(cuda)
    before = cobra_bin_accumulate_rows.launches
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, -(-n // 512), op)
    want = tref.scatter_reduce_ref(ti, tv, n, op)
    assert cobra_bin_accumulate_rows.launches == before + 1
    assert got.shape == (n, F) and _rows_ok(got, want, ti, tv, n, op)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 8, 16])
@pytest.mark.parametrize("op", ["add", "max"])
def test_cuda_rows_narrow_walk_long_chunks(cuda, F, op):
    """m large enough that a warp's chunk takes many steps (m / (rows a
    step x two waves of warps)), on a sorted stream with hubs."""
    n, m = 50_000, 6_000_011
    gen = torch.Generator(device=cuda).manual_seed(F)
    ti = torch.randint(0, n, (m,), device=cuda, generator=gen, dtype=torch.int32)
    ti[: m // 3] = 17  # a hub: one run across many chunks
    ti = ti.sort().values
    tv = torch.randn(m, F, device=cuda, generator=gen)
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, -(-n // 512), op)
    want = tref.scatter_reduce_ref(ti, tv, n, op)
    assert _rows_ok(got, want, ti, tv, n, op)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "min"])
def test_cuda_rows_at_the_gnn_shape(cuda, op):
    """S2's GNN layer: gen_uniform(2^22, 8)'s destination-sorted stream of
    2^25 rows at F = 64 (the wide walk)."""
    n, m, F = 1 << 22, 1 << 25, 64
    gen = torch.Generator(device=cuda).manual_seed(2)
    ti = torch.randint(0, n, (m,), device=cuda, generator=gen, dtype=torch.int32).sort().values
    tv = torch.randn(m, F, device=cuda, generator=gen)
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, n // 512, op)
    want = tref.scatter_reduce_ref(ti, tv, n, op)
    assert _rows_ok(got, want, ti, tv, n, op)


# The tile walk of csrc/pb_rows.cuh (rows wider than 4 lanes: F >= 17 with
# 16-byte rows, F >= 5 otherwise) against the plain version: five orders
# (destination-sorted, uniform, zipf token ids whose tiles are sorted in
# shared memory, one destination, a hub taking half of the rows), 1% of
# the indices -1, -7, n or n + 11; scalar lanes at F = 17, 31, 33 and
# 1000 % 4 == 0 but 1000 / 4 lanes not a power of two; bfloat16 for add.
TILE_ORDERS = ["sorted", "random", "zipf", "one-destination", "hub"]


def _tile_stream(order, n, m, seed):
    rng = _rng(seed)
    if order == "one-destination":
        idx = np.full(m, n // 2, np.int64)
    elif order == "zipf":
        idx = np.minimum((rng.pareto(1.2, m) * 20).astype(np.int64), n - 1)
    elif order == "hub":
        idx = np.where(rng.random(m) < 0.5, n // 3, rng.integers(0, n, m))
    else:
        idx = rng.integers(0, n, m)
        if order == "sorted":
            idx.sort()
    bad = rng.random(m) < 0.01
    idx[bad] = rng.choice([-1, -7, n, n + 11], int(bad.sum()))
    return idx.astype(np.int32)


def _tile_values(m, F, dtype, cuda, seed, offset=0):
    """(m, F) values; ``offset`` elements past the start of their storage
    (1: rows off a 16-byte boundary, so every lane loads one column)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if dtype == torch.int32:
        flat = torch.randint(-50, 50, (m * F + offset,), device=cuda, generator=gen,
                             dtype=torch.int32)
    else:
        flat = torch.randn(m * F + offset, device=cuda, generator=gen).to(dtype)
    return flat[offset:].view(m, F)


def _tile_ok(got, want, ti, tv, n, op):
    if tv.dtype != torch.bfloat16:
        return _rows_ok(got, want, ti, tv, n, op)
    if op != "add":
        return torch.equal(got, want)
    scale = tref.scatter_reduce_ref(ti, tv.float().abs(), n)
    diff = (got.float() - want.float()).abs()
    return bool((diff <= 2.0**-7 * want.float().abs() + 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("F", [17, 20, 31, 32, 33, 64, 128, 1000, 1536, 4096])
@pytest.mark.parametrize("order", TILE_ORDERS)
@pytest.mark.parametrize("dtype,op", [(torch.float32, "add"), (torch.float32, "min"),
                                      (torch.float32, "max"), (torch.int32, "add"),
                                      (torch.int32, "min"), (torch.int32, "max"),
                                      (torch.bfloat16, "add")])
def test_cuda_rows_tile_walk(cuda, F, order, dtype, op):
    from repro_torch.kernels.fused import rows_design

    n, m = 2003, 20_011
    ti = torch.from_numpy(_tile_stream(order, n, m, seed=F)).to(cuda)
    tv = _tile_values(m, F, dtype, cuda, seed=F + 1)
    assert rows_design(F) == "tile"
    before = cobra_bin_accumulate_rows.launches
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, -(-n // 512), op)
    assert cobra_bin_accumulate_rows.launches == before + 1
    want = tref.scatter_reduce_ref(ti, tv, n, op)
    assert got.shape == (n, F) and got.dtype == dtype and _tile_ok(got, want, ti, tv, n, op)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [20, 64, 1536])
@pytest.mark.parametrize("order", ["sorted", "zipf"])
@pytest.mark.parametrize("dtype,op", [(torch.float32, "add"), (torch.float32, "max"),
                                      (torch.int32, "min"), (torch.bfloat16, "add")])
def test_cuda_rows_tile_walk_unaligned_rows(cuda, F, order, dtype, op):
    """Values one element past a 16-byte boundary: the tile walk with one
    column a lane and scalar atomics (F = 20 and 64 leave the narrow walk's
    reach too: 20 and 64 lanes)."""
    from repro_torch.kernels.fused import rows_design

    n, m = 701, 9_001
    ti = torch.from_numpy(_tile_stream(order, n, m, seed=F + 2)).to(cuda)
    tv = _tile_values(m, F, dtype, cuda, seed=F + 3, offset=1)
    assert tv.data_ptr() % 16 != 0 and rows_design(F, aligned=False) == "tile"
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, -(-n // 512), op)
    want = tref.scatter_reduce_ref(ti, tv, n, op)
    assert _tile_ok(got, want, ti, tv, n, op)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "max"])
def test_cuda_rows_past_int32_elements_in_token_order(cuda, op):
    """m * F > 2^31 in an unsorted stream (every tile sorted in shared
    memory), with indices -1 and >= n: 64-bit row offsets through the
    tile's positions."""
    n, m, F = 1 << 20, (1 << 25) + 3, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    ti = torch.randint(-2, n + 2, (m,), device=cuda, generator=gen, dtype=torch.int32)
    tv = torch.randn(m, F, device=cuda, generator=gen)
    assert m * F > 2**31
    got = cobra_bin_accumulate_rows(ti, tv, n, 512, n // 512, op)
    want = tref.scatter_reduce_ref(ti, tv, n, op)
    if op == "add":
        scale = tref.scatter_reduce_ref(ti, tv.abs(), n, "add")
        del tv
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    else:
        del tv
        assert torch.equal(got, want)
    assert float(got[-1].abs().sum()) > 0  # the last rows were reached


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1), (64, 8), (1000, 3), (4097, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_cuda_scatter_rows_matches_plain(cuda, m, d, dtype):
    rng = _rng(m * d)
    x = torch.from_numpy(rng.integers(-100, 100, (m, d)).astype(np.float32)).to(cuda).to(dtype)
    pos = rng.permutation(m + 5)[:m].astype(np.int32)
    pos[::7] = -1
    tp = torch.from_numpy(pos).to(cuda)
    got = scatter_rows(x, tp, m + 5)
    assert torch.equal(got, tref.scatter_rows_ref(x, tp, m + 5))


# -- the flash-attention kernel (third slice) ---------------------------------
# Against its plain version on the same inputs, elementwise: float32 within
# atol 1e-4 (tests/test_kernels.py:217); bfloat16 within one bfloat16
# rounding step of the plain output, |got - want| <= 2^-7 |want| + 1e-4,
# since both round one float32 value (the floor covers float32 summation
# order near 0). A flat 5e-2 would be as large as a causal output at long S.


def _flash_close(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return bool((diff <= 1e-4).all())
    return bool((diff <= 2.0**-7 * want.float().abs() + 1e-4).all())


def _qkv(cuda, B, H, KH, Sq, Skv, hd, dtype, seed=0, cancel=False):
    """Unit-normal q, k, v; with ``cancel``, v = +-1 alternating by key, so
    that every output nearly cancels (a bf16-rounded P fails the check)."""
    rng = _rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, Sq, hd)).astype(np.float32)).to(cuda, dtype)
    k = torch.from_numpy(rng.normal(size=(B, KH, Skv, hd)).astype(np.float32)).to(cuda, dtype)
    v = torch.from_numpy(rng.normal(size=(B, KH, Skv, hd)).astype(np.float32)).to(cuda, dtype)
    if cancel:
        sign = 1.0 - 2.0 * (torch.arange(Skv, device=cuda) % 2)
        v = sign[None, None, :, None].expand(B, KH, Skv, hd).to(dtype).contiguous()
    return q, k, v


def _flash_vs_plain(cuda, B, H, KH, Sq, Skv, hd, causal, dtype, **kw):
    from repro_torch.kernels.flashattn import flash_attention, flash_attention_ref

    q, k, v = _qkv(cuda, B, H, KH, Sq, Skv, hd, dtype, **kw)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert _flash_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,Sq,Skv,hd", [
    (1, 2, 1, 128, 128, 16), (2, 4, 2, 256, 256, 32), (1, 12, 2, 1, 1, 128),
    (1, 12, 2, 7, 7, 128), (1, 12, 2, 513, 513, 128), (2, 6, 6, 100, 100, 64),
    (1, 12, 2, 256, 512, 128), (1, 4, 1, 300, 65, 16),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain(cuda, B, H, KH, Sq, Skv, hd, causal, dtype):
    _flash_vs_plain(cuda, B, H, KH, Sq, Skv, hd, causal, dtype, seed=Sq + hd)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("S", [100, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bf16_head_dims_with_qwen_grouping(cuda, hd, S, causal):
    _flash_vs_plain(cuda, 2, 12, 2, S, S, hd, causal, torch.bfloat16, seed=S + hd)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 15, 63, 65, 127, 129])
@pytest.mark.parametrize("Skv", [1, 15, 63, 65, 127, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bf16_ragged_tile_edges(cuda, Sq, Skv, causal):
    """Lengths around the 64-row tiles, Sq < Skv and Sq > Skv included."""
    _flash_vs_plain(cuda, 1, 12, 2, Sq, Skv, 128, causal, torch.bfloat16, seed=Sq * 1000 + Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,Sq,Skv,hd", [
    (1, 2, 2, 128, 128, 16), (1, 12, 2, 512, 512, 128), (1, 12, 2, 2048, 2048, 128),
    (1, 12, 2, 100, 1000, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bf16_where_outputs_cancel(cuda, B, H, KH, Sq, Skv, hd, causal):
    """v = +-1 alternating by key: a kernel that rounds P to bf16 once fails
    here (tests/test_torch_flashattn.py emulates both)."""
    _flash_vs_plain(cuda, B, H, KH, Sq, Skv, hd, causal, torch.bfloat16, seed=hd, cancel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,Sq,Skv", [
    (1, 32, 32, 1024, 1024), (1, 32, 32, 1000, 1000), (1, 8, 2, 333, 333), (2, 4, 4, 65, 130),
    (1, 4, 1, 129, 63),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_at_head_dim_80(cuda, B, H, KH, Sq, Skv, causal, dtype):
    """zamba2's heads (32 of 80, a KV head each) and ragged, grouped and
    Sq != Skv cases at head_dim 80: in bfloat16 two TMA boxes a row, 64
    and 16 columns (csrc/flashattn.cu, Cols)."""
    _flash_vs_plain(cuda, B, H, KH, Sq, Skv, 80, causal, dtype, seed=Sq + Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bf16_at_head_dim_80_where_outputs_cancel(cuda, causal):
    _flash_vs_plain(cuda, 1, 32, 32, 1024, 1024, 80, causal, torch.bfloat16, seed=80, cancel=True)


@pytest.mark.cuda
def test_cuda_flash_bf16_reads_unaligned_q(cuda):
    """q one element off a 16-byte boundary, which TMA cannot read, goes to
    the kernel as an aligned copy; the result equals the aligned call's."""
    from repro_torch.kernels.flashattn import flash_attention

    B, H, KH, S, hd = 1, 4, 2, 70, 64
    q, k, v = _qkv(cuda, B, H, KH, S, S, hd, torch.bfloat16, seed=11)
    off = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(q.shape)
    off.copy_(q)
    assert off.data_ptr() % 16
    assert torch.equal(flash_attention(off, k, v), flash_attention(q, k, v))


@pytest.mark.cuda
def test_cuda_flash_kernels_route_by_dtype(cuda):
    """The bf16 kernels are Hopper's: wgmma (HGMMA) fed by TMA (UTMALDG)
    in their SASS and no mma.sync (HMMA), in each of the ten
    instantiations (head dims 16, 32, 64, 80, 128 x blocks of 64 and 128
    queries); the float32 kernels run on CUDA cores, with none of them."""
    from repro_torch.kernels import _lib

    sass = _lib.kernel_sass("flash_fwd_")
    bf16 = {n: body for n, body in sass.items() if "flash_fwd_bf16_kernel" in n}
    f32 = {n: body for n, body in sass.items() if "flash_fwd_f32_kernel" in n}
    assert len(bf16) == 10 and len(f32) == 5
    assert all("HGMMA" in b and "UTMALDG" in b and "HMMA" not in b for b in bf16.values())
    assert not any(op in b for b in f32.values() for op in ("HGMMA", "UTMALDG", "HMMA"))


def _flash_blocks_run(fn) -> set:
    """The (head_dim, consumer warpgroups) of every bf16 flash kernel one
    call of ``fn`` launched (``torch.profiler``'s kernel names)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    return {tuple(map(int, m.groups())) for n in names
            for m in [re.search(r"flash_fwd_bf16_kernel<(\d+), (\d+)>", n)] if m}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bf16_both_blocks(cuda, hd, causal):
    """The host's choice of block: 128 queries (two consumer warpgroups)
    where that grid fills the card's SMs, else 64 (two blocks an SM); both
    held to the plain version."""
    from repro_torch.kernels.flashattn import flash_attention

    for B, nwg in ((1, 1), (12, 2)):  # 12 x 12 heads x 3 tiles of 128 >= 132 SMs; 1 x 12 x 3 not
        _flash_vs_plain(cuda, B, 12, 2, 300, 300, hd, causal, torch.bfloat16, seed=hd + B)
        q, k, v = _qkv(cuda, B, 12, 2, 300, 300, hd, torch.bfloat16, seed=hd)
        assert _flash_blocks_run(lambda: flash_attention(q, k, v, causal=causal)) == {(hd, nwg)}


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 63, 64, 65, 127, 128, 129, 255, 257])
@pytest.mark.parametrize("Skv", [1, 63, 64, 65, 127, 128, 129, 255, 257])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,hd", [(1, 128), (12, 128), (12, 80)])
def test_cuda_flash_bf16_ragged_edges_of_both_blocks(cuda, Sq, Skv, causal, B, hd):
    """Lengths around the 64-key tiles and the 64- and 128-query blocks:
    B 1 takes 64-query blocks, B 12 128-query blocks, at hd 128 (two
    64-column boxes) and 80 (64 + 16)."""
    _flash_vs_plain(cuda, B, 12, 2, Sq, Skv, hd, causal, torch.bfloat16,
                    seed=Sq * 1000 + Skv + B)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(200, 200), (192, 192), (300, 260), (260, 300), (129, 200)])
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_cuda_flash_bf16_diagonal_tile_across_two_warpgroups(cuda, Sq, Skv, hd):
    """A 128-query block whose diagonal crosses two 64-key tiles: the
    first is wholly visible to the second warpgroup and holds the first's
    diagonal, the second is wholly masked for the first warpgroup's rows
    (it runs them, and they come out unchanged) and holds the second's
    diagonal; the last block's second warpgroup holds few or no real
    queries, and Sq != Skv puts the block's last visible key inside a
    tile."""
    _flash_vs_plain(cuda, 12, 12, 2, Sq, Skv, hd, True, torch.bfloat16, seed=Sq + Skv + hd)


@pytest.mark.cuda
def test_cuda_flash_reads_strided_layout(cuda):
    """(B, S, H, hd) activations passed as transposed views: read in place,
    output with q's strides, equal to the contiguous call."""
    from repro_torch.kernels.flashattn import flash_attention

    B, S, H, KH, hd = 2, 200, 12, 2, 128
    rng = _rng(3)
    qs = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32)).to(cuda, torch.bfloat16)
    ks = torch.from_numpy(rng.normal(size=(B, S, KH, hd)).astype(np.float32)).to(cuda, torch.bfloat16)
    vs = torch.from_numpy(rng.normal(size=(B, S, KH, hd)).astype(np.float32)).to(cuda, torch.bfloat16)
    got = flash_attention(qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2))
    want = flash_attention(*(t.transpose(1, 2).contiguous() for t in (qs, ks, vs)))
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(48, torch.float32), (256, torch.bfloat16),
                                      (64, torch.float16)])
def test_cuda_flash_raises_on_what_it_does_not_take(cuda, hd, dtype):
    from repro_torch.kernels.flashattn import flash_attention

    q = torch.zeros(1, 2, 8, hd, device=cuda, dtype=dtype)
    k = torch.zeros(1, 1, 8, hd, device=cuda, dtype=dtype)
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    assert flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["address", "stride"])
def test_cuda_flash_raises_on_unaligned_kv(cuda, which):
    """k and v are read by TMA (in bfloat16) or 16-byte loads: a view that
    starts or steps off a 16-byte boundary raises before any launch."""
    from repro_torch.kernels.flashattn import flash_attention

    B, H, KH, S, hd = 2, 4, 2, 8, 16
    q = torch.zeros(B, H, S, hd, device=cuda, dtype=torch.bfloat16)
    if which == "address":  # one element (2 bytes) past an aligned start
        k = torch.zeros(B * KH * S * hd + 1, device=cuda, dtype=torch.bfloat16)[1:]
        k = k.view(B, KH, S, hd)
    else:  # rows of hd + 1 elements: a position stride of 34 bytes
        k = torch.zeros(B, KH, S, hd + 1, device=cuda, dtype=torch.bfloat16)[..., :hd]
    good = torch.zeros(B, KH, S, hd, device=cuda, dtype=torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, good)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, good, k)
    assert flash_attention.launches == before


# -- the traversal slice on the card against the CPU ------------------------------

TRAV_GRAPHS = ("DBP", "KRON", "URND", "EURO", "HBUBL")


def _trav_pair(cuda, name):
    """One smoke graph on the card and on the CPU: (coo, csr, weights) each."""
    import repro_torch.core as T

    out = []
    for dev in (cuda, "cpu"):
        g = T.graph_suite("smoke", device=dev)[name]
        csr = T.build_csr_baseline(g)
        w = torch.from_numpy(np.random.default_rng(8).random(csr.num_edges).astype(np.float32)
                             + 0.1).to(dev)
        out.append((g, csr, w))
    return out


def _trav_source(csr):
    return int(np.argmax(np.diff(csr.offsets.cpu().numpy())))


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAV_GRAPHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_cuda_single_source_traversal_equals_cpu(cuda, name, use_pallas, tmp_path):
    """BFS (levels, parents), SSSP, k-core and radii run the fused kernel
    (or, with use_pallas, the kernel-backed binning where decided) and
    equal the CPU run exactly, decisions included but for the device."""
    import repro_torch.core as T
    from repro_torch.core import traversal as tt

    (_, gc, wc), (_, cc, wp) = _trav_pair(cuda, name)
    s = _trav_source(cc)
    ex = T.PBExecutor(cache_dir=str(tmp_path), use_pallas=use_pallas)
    for fn in (lambda c, w: tt.bfs(c, s, executor=ex),
               lambda c, w: tt.sssp(c, w, s, executor=ex),
               lambda c, w: tt.bfs(c, s, executor=ex, method="fused")):
        a, b = fn(gc, wc), fn(cc, wp)
        assert torch.equal(a.dist.cpu(), b.dist)
        assert (a.parent is None) == (b.parent is None)
        if a.parent is not None:
            assert torch.equal(a.parent.cpu(), b.parent)
        assert (a.levels, a.frontier_sizes, a.level_edges) == (b.levels, b.frontier_sizes,
                                                              b.level_edges)
    for k in (2, 3):
        a, b = tt.k_core(gc, k, executor=ex), tt.k_core(cc, k, executor=ex)
        assert torch.equal(a.in_core.cpu(), b.in_core)
        assert torch.equal(b.in_core, torch.from_numpy(tt.k_core_oracle(cc, k)))
    a, b = T.radii(gc, k=4, executor=ex), T.radii(cc, k=4, executor=ex)
    assert torch.equal(a.ecc.cpu(), b.ecc) and (a.iters, a.converged) == (b.iters, b.converged)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAV_GRAPHS)
@pytest.mark.parametrize("method", ["auto", "sort", "fused"])
def test_cuda_batched_traversal_and_ppr_equal_cpu(cuda, name, method, tmp_path):
    """Batched BFS/SSSP lanes equal the CPU's bit for bit and their own
    single-source runs; PPR within rtol 2e-4, atol 1e-6: float32 adds in
    another order, and DBP's hub sums hundreds of contributions an
    iteration (observed: 1.3e-5 relative)."""
    import repro_torch.core as T
    from repro_torch.core import traversal as tt

    (_, gc, wc), (_, cc, wp) = _trav_pair(cuda, name)
    srcs = [int(v) for v in np.argsort(-np.diff(cc.offsets.numpy()), kind="stable")[:4]]
    ex = T.PBExecutor(cache_dir=str(tmp_path))
    a = tt.bfs_batched(gc, srcs, executor=ex, method=method, with_parents=True)
    b = tt.bfs_batched(cc, srcs, executor=ex, method=method, with_parents=True)
    assert torch.equal(a.dist.cpu(), b.dist) and torch.equal(a.parent.cpu(), b.parent)
    for q, s in enumerate(srcs):
        one = tt.bfs(gc, s, executor=ex, method=method)
        assert torch.equal(a.dist[q], one.dist) and torch.equal(a.parent[q], one.parent)
    a = tt.sssp_batched(gc, wc, srcs, executor=ex, method=method)
    b = tt.sssp_batched(cc, wp, srcs, executor=ex, method=method)
    assert torch.equal(a.dist.cpu(), b.dist)
    for q, s in enumerate(srcs):
        assert torch.equal(a.dist[q], tt.sssp(gc, wc, s, executor=ex, method=method).dist)
    for sources in (None, srcs[0], srcs):
        a = tt.personalized_pagerank(gc, sources, iters=10, executor=ex, method=method)
        b = tt.personalized_pagerank(cc, sources, iters=10, executor=ex, method=method)
        torch.testing.assert_close(a.ranks.cpu(), b.ranks, rtol=2e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAV_GRAPHS)
@pytest.mark.parametrize("method", [None, "sort", "counting", "pallas", "hierarchical", "fused"])
def test_cuda_connected_components_equal_cpu(cuda, name, method, tmp_path):
    import repro_torch.core as T
    from repro_torch.core import components as tc

    (gd, _, _), (gp, _, _) = _trav_pair(cuda, name)
    T.set_default_executor(T.PBExecutor(cache_dir=str(tmp_path)))
    try:
        fns = [lambda g: T.connected_components_fused(g, method=method),
               lambda g: T.connected_components(g)]
        if method != "fused":  # the PB form bins: fused is a reduce method only
            fns.append(lambda g: tc.connected_components_pb(g, bin_range=64, method=method))
        for fn in fns:
            a, b = fn(gd), fn(gp)
            assert torch.equal(a.labels.cpu(), b.labels) and a.iters == b.iters
        half = gp.num_edges // 2
        for g in (gd, gp):
            prev = T.connected_components_fused(T.COO(g.src[:half], g.dst[:half], g.num_nodes))
            r, mode = T.connected_components_incremental(g, prev.labels, method=method)
            assert mode == "incremental"
            assert torch.equal(r.labels.cpu(), T.connected_components_fused(gp).labels)
    finally:
        T.set_default_executor(None)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(1, 1000, 5000), (4, 3000, 20000), (8, 1 << 19, 1 << 20),
                                   (2, 1 << 25, 1 << 22), (3, 1 << 25, 1 << 16)])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_cuda_reduce_streams_lanes_equal_reduce_stream(cuda, B, n, m, op, dtype, tmp_path):
    """Flattened fused lanes (one launch while B * n <= 2^26, else a launch
    per lane) and the binning methods: each lane equals reduce_stream of
    that lane, exactly but for float32 add (1e-5 of the summed
    magnitudes); out-of-range indices are dropped, not moved to a
    neighbouring lane (negative ones only for fused: a negative bin id is
    undefined input to binning)."""
    from repro_torch.core import executor as tex
    from repro_torch.kernels.fused import cobra_bin_accumulate

    rng = _rng(B * 7 + m)
    ex = tex.PBExecutor(cache_dir=str(tmp_path))
    for method in ("fused", "sort", "counting"):
        lo = -3 if method == "fused" else 0
        idx = torch.from_numpy(rng.integers(lo, n + 3, (B, m)).astype(np.int32)).to(cuda)
        if dtype == torch.int32:
            val = torch.from_numpy(rng.integers(-50, 50, (B, m)).astype(np.int32)).to(cuda)
        else:
            val = torch.from_numpy(rng.normal(size=(B, m)).astype(np.float32)).to(cuda)
        before = cobra_bin_accumulate.launches
        got = ex.reduce_streams(idx, val, out_size=n, op=op, method=method)
        if method == "fused":
            assert cobra_bin_accumulate.launches - before == (1 if B * n <= 1 << 26 else B)
        for b in range(B):
            want = ex.reduce_stream(idx[b], val[b], out_size=n, op=op, method=method)
            if dtype == torch.float32 and op == "add":
                scale = tref.scatter_reduce_ref(idx[b], val[b].abs(), n, "add")
                assert bool(((got[b] - want).abs() <= 1e-5 * scale + 1e-6).all())
            else:
                assert torch.equal(got[b], want)


# -- the graph-serving slice on the card against the CPU -----------------------------


def _coo_pair(cuda, name):
    import repro_torch.core as T

    return T.graph_suite("smoke", device=cuda)[name], T.graph_suite("smoke", device="cpu")[name]


def _same_slack(a, b):
    for f in ("offsets", "neighs", "counts"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f))


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAV_GRAPHS)
@pytest.mark.parametrize("variant", ["identity", "random", "degree_sort", "hub_sort", "dbg"])
def test_cuda_preprocess_pipeline_equals_cpu(cuda, name, variant, tmp_path):
    """Every stage on the card (the degree count through the fused
    kernel) gives the CPU's mapping, CSR, CSC and slack slab."""
    import repro_torch.core as T

    gc, gp = _coo_pair(cuda, name)
    ex = T.PBExecutor(cache_dir=str(tmp_path))
    kw = dict(variant=variant, slack_headroom=0.25, executor=ex, seed=4)
    a, b = T.PreprocessPipeline(**kw).run(gc), T.PreprocessPipeline(**kw).run(gp)
    for x, y in ((a.new_ids, b.new_ids), (a.degrees, b.degrees), (a.csr.offsets, b.csr.offsets),
                 (a.csr.neighs, b.csr.neighs), (a.csc.neighs, b.csc.neighs)):
        assert torch.equal(x.cpu(), y)
    _same_slack(a.slack, b.slack)
    assert [s.name for s in a.report.stages] == [s.name for s in b.report.stages]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["DBP", "KRON", "HBUBL"])
@pytest.mark.parametrize("method", [None, "sort", "counting", "fused"])
@pytest.mark.parametrize("ins,dels", [(300, 0), (300, 60), (3000, 300)])
def test_cuda_apply_edge_batch_equals_cpu(cuda, name, method, ins, dels, tmp_path):
    """Slot placement, tombstones, regrow and the accounting on the card
    equal the CPU's; the batch's two delta reduces are update streams."""
    import repro_torch.core as T

    gc, gp = _coo_pair(cuda, name)
    ex = T.PBExecutor(cache_dir=str(tmp_path))
    sc = T.SlackCSR.from_csr(T.build_csr_baseline(gc), headroom=0.1, min_slack=1)
    sp = T.SlackCSR.from_csr(T.build_csr_baseline(gp), headroom=0.1, min_slack=1)
    b = T.random_edge_batch(gp, ins, dels, seed=ins + dels)
    a = T.apply_edge_batch(sc, T.make_batch(*b, device=cuda), executor=ex, method=method)
    r = T.apply_edge_batch(sp, b, executor=ex, method=method)
    _same_slack(a.graph, r.graph)
    assert (a.rebuilt, a.regrown, a.inserted, a.deleted, a.missed_deletes, a.slack_fraction) == (
        r.rebuilt, r.regrown, r.inserted, r.deleted, r.missed_deletes, r.slack_fraction)
    assert all(d["kind"] == "update" for d in a.decisions[:2])
    merged = T.build_csr_baseline(T.merge_batch_coo(gc, T.make_batch(*b, device=cuda)))
    assert T.csr_equal_as_sets(a.graph.to_csr(), merged)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAV_GRAPHS)
def test_cuda_bfs_incremental_equals_cpu_and_full_bfs(cuda, name, tmp_path):
    import repro_torch.core as T

    gc, gp = _coo_pair(cuda, name)
    ex = T.PBExecutor(cache_dir=str(tmp_path))
    b = T.random_edge_batch(gp, 200, 0, seed=1)
    out = []
    for g, dev in ((gc, cuda), (gp, "cpu")):
        csr0 = T.build_csr_baseline(g)
        s = _trav_source(csr0)
        prev = T.bfs(csr0, s, executor=ex).dist
        nb = T.make_batch(*b, device=dev)
        csr1 = T.apply_edge_batch(T.SlackCSR.from_csr(csr0), nb, executor=ex).graph.to_csr()
        touched, has_del = T.touched_vertices(nb)
        res, mode = T.bfs_incremental(csr1, s, prev, touched, has_deletes=has_del, executor=ex)
        assert mode == "incremental"
        assert torch.equal(res.dist, T.bfs(csr1, s, executor=ex).dist)
        out.append(res)
    a, r = out
    assert torch.equal(a.dist.cpu(), r.dist)
    assert (a.levels, a.frontier_sizes, a.level_edges) == (r.levels, r.frontier_sizes,
                                                          r.level_edges)


@pytest.mark.cuda
@pytest.mark.parametrize("max_batch", [1, 4])
def test_cuda_frontend_replay_equals_cpu(cuda, max_batch, tmp_path):
    """A FakeClock replay with update queries on the card gives the CPU's
    tick log and latencies, its integer and SSSP answers exactly and its
    PPR / PageRank answers within rtol 2e-4, atol 1e-6."""
    import repro_torch.core as T
    from repro_torch.serving import graph_frontend as F

    def replay(dev):
        suite = T.graph_suite("smoke", device=dev)
        fe = F.GraphFrontend(executor=T.PBExecutor(cache_dir=str(tmp_path)),
                             max_batch=max_batch, clock=F.FakeClock(), tick_cost=0.004)
        for name in ("DBP", "EURO"):
            fe.register_graph(name, suite[name], seed=2)
        fe.warmup(probe=False)
        rng = np.random.default_rng(5)
        kinds = ("bfs", "sssp", "ppr", "pagerank", "kcore", "update")

        def make(r, i):
            name = ("DBP", "EURO")[i % 2]
            kind = kinds[i % len(kinds)]
            q = F.GraphQuery(tenant=f"t{i % 3}", graph=name, kind=kind,
                             source=int(rng.integers(0, 1024)), iters=5)
            if kind == "update":
                q.batch = T.random_edge_batch(suite[name], 40, 8, seed=i)
            return q

        return fe, F.replay_trace(fe, F.poisson_trace(1000.0, 36, make, seed=3))

    (fa, ra), (fb, rb) = replay(cuda), replay("cpu")
    assert fa.tick_log == fb.tick_log
    assert [q.latency for q in ra.completed] == [q.latency for q in rb.completed]
    for qa, qb in zip(ra.completed, rb.completed):
        if qa.kind in ("ppr", "pagerank"):
            np.testing.assert_allclose(qa.result, qb.result, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(qa.result, qb.result)


# -- the training slice: backward paths on the card ---------------------------
# Flash's backward is the plain function's gradient in float32 on both
# sides (the kernel is only the forward): held to the forward's rule. The
# PB embedding backward is a float32 add by the rows kernel, within 1e-5
# of the magnitudes summed at a row, then one bfloat16 rounding.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,q_block", [(300, 128), (1024, 512)])
def test_cuda_flash_backward_matches_the_cpu(cuda, dtype, S, q_block):
    from repro_torch.kernels.flashattn import flash_attention

    q, k, v = _qkv(cuda, 1, 12, 2, S, S, 128, torch.float32, seed=S)
    go = torch.from_numpy(_rng(S + 1).normal(size=q.shape).astype(np.float32))
    grads = {}
    for side, d in (("card", cuda), ("cpu", torch.device("cpu"))):
        args = [x.to(d, dtype).requires_grad_() for x in (q, k, v)]
        before = flash_attention.launches
        out = flash_attention(*args, causal=True, q_block=q_block)
        assert flash_attention.launches == before + (side == "card")
        assert out.grad_fn is not None
        grads[side] = torch.autograd.grad(out, args, go.to(d, dtype))
    for a, b in zip(grads["card"], grads["cpu"]):
        assert a.dtype == dtype and _flash_close(a.cpu(), b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pb_embedding_backward_runs_the_rows_kernel(cuda, dtype):
    from repro_torch.models.layers import _pb_take

    rng = _rng(20)
    V, d = 5000, 256
    ids = rng.integers(0, V, (4, 512)).astype(np.int32)
    ids[0, :100] = V - 1  # a hot row
    g = rng.normal(size=(4, 512, d)).astype(np.float32)
    table = torch.zeros(V, d, dtype=dtype, device=cuda, requires_grad=True)
    before = cobra_bin_accumulate_rows.launches
    out = _pb_take(table, torch.from_numpy(ids).to(cuda))
    (got,) = torch.autograd.grad(out, table, torch.from_numpy(g).to(cuda, dtype))
    assert cobra_bin_accumulate_rows.launches == before + 1 and got.dtype == dtype
    rows = torch.from_numpy(g).to(dtype).float().reshape(-1, d).double()
    flat = torch.from_numpy(ids.reshape(-1)).long()
    want = torch.zeros(V, d, dtype=torch.float64).index_add_(0, flat, rows)
    scale = torch.zeros(V, d, dtype=torch.float64).index_add_(0, flat, rows.abs())
    tol = 1e-5 * scale + 1e-6 + (2.0**-8 * want.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((got.cpu().double() - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["tokens", "random"])
@pytest.mark.parametrize("m,F,n", [(2048 * 8, 4096, 2048), (32, 4096, 4), (1000, 64, 97),
                                   (5000, 12, 300), (777, 130, 50)])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_cuda_rows_kernel_takes_bfloat16(cuda, order, m, F, n, op):
    """bfloat16 rows (the MoE combine's, k = 8 a token in token order, and
    any order with indices out of range): float32 sums rounded once,
    within one bfloat16 step of the plain version's (which rounds the same
    float32 sum, summed in another order); min/max equal."""
    rng = _rng(21)
    if order == "tokens":
        idx = np.repeat(np.arange(n, dtype=np.int32), m // n)
    else:
        idx = rng.integers(-3, n + 3, m).astype(np.int32)
    val = torch.from_numpy(rng.normal(size=(len(idx), F)).astype(np.float32)).to(cuda, torch.bfloat16)
    ti = torch.from_numpy(idx).to(cuda)
    got = cobra_bin_accumulate_rows(ti, val, n, n, 1, op)
    want = tref.scatter_reduce_ref(ti, val, n, op)
    assert got.dtype == torch.bfloat16 and got.shape == (n, F)
    if op != "add":
        assert torch.equal(got, want)
        return
    scale = tref.scatter_reduce_ref(ti, val.float().abs(), n)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 2.0**-7 * want.float().abs() + 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 300])
def test_cuda_moe_layer_dispatch_methods_agree_and_launch_the_kernels(cuda, T):
    """One full-width qwen3-moe layer (d 4096, 128 experts of 1536, top-8,
    bfloat16): sort and counting dispatch route bit for bit and give equal
    outputs; counting launches the histogram and positions kernels once,
    both launch the row scatter and the rows kernel once."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.params import winit_

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), num_layers=1)
    moe = L.MoE(cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            winit_(p, gen, cfg.d_ff ** -0.5 if name == "w2" else None)
    x = torch.randn(1, T, cfg.d_model, device=cuda, generator=gen).to(torch.bfloat16)
    out = {}
    with torch.inference_mode():
        for method in ("sort", "counting"):
            c = dataclasses.replace(cfg, moe_dispatch_method=method)
            K.reset_launch_counts()
            out[method] = L.moe_apply(moe, x, c)
            counts = K.launch_counts()
            assert counts["scatter_rows"] == 1 and counts["cobra_bin_accumulate_rows"] == 1
            want = 1 if method == "counting" else 0
            assert counts["histogram"] == want and counts["counting_positions"] == want
    assert torch.equal(out["sort"], out["counting"]) and out["sort"].dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("method", ["sort", "counting"])
def test_cuda_moe_backward_launches_the_kernels_and_equals_the_cpu(cuda, method, cf):
    """The MoE layer's backward on the card: the dispatch's backward
    launches the rows kernel and the combine's the row scatter, once each
    beside the forward's one of each; float32 gradients in x and every
    weight equal the CPU's (plain versions) within 1e-4 of max |g| (sums of
    k rows in another order)."""
    import copy
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.params import winit_

    cfg = dataclasses.replace(
        get_config("qwen3-moe-235b-a22b"), num_layers=1, d_model=256, d_ff=128, num_experts=16,
        top_k=4, capacity_factor=cf, moe_dispatch_method=method, param_dtype="float32",
        compute_dtype="float32")
    moe = L.MoE(cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            winit_(p, gen, cfg.d_ff ** -0.5 if name == "w2" else None)
    x = torch.randn(2, 96, cfg.d_model, device=cuda, generator=gen)
    g = torch.randn(2, 96, cfg.d_model, device=cuda, generator=gen)
    grads = {}
    for side, layer in (("card", moe), ("cpu", copy.deepcopy(moe).to("cpu"))):
        d = layer.wr.device
        xs = x.to(d).requires_grad_()
        K.reset_launch_counts()
        out = L.moe_apply(layer, xs, cfg)
        fwd = K.launch_counts()
        grads[side] = torch.autograd.grad(out, [xs, layer.wr, layer.w1, layer.w3, layer.w2],
                                          g.to(d))
        bwd = K.launch_counts()
        if side == "card":
            assert fwd["scatter_rows"] == 1 and fwd["cobra_bin_accumulate_rows"] == 1
            assert bwd["scatter_rows"] == 2 and bwd["cobra_bin_accumulate_rows"] == 2
    for a, b in zip(grads["card"], grads["cpu"]):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())


# -- the vlm and encdec slice: cross-attention and Whisper's encoder ----------
# Flash with causal=False at Sq != Skv: llama-3.2-vision-11b's cross layers
# (32 query heads over 8 KV heads of 128) over its 1,601 image rows, not a
# multiple of the 64-key tile; Whisper's encoder (8 heads of 64, 1,500
# frames) and its decoder's cross-attention. The backward is the plain
# function's, non-causal, over every key.


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,Sq,Skv,hd", [
    (1, 32, 8, 1, 1601, 128), (1, 32, 8, 300, 1601, 128), (1, 32, 8, 1024, 1601, 128),
    (1, 8, 8, 1500, 1500, 64), (4, 8, 8, 448, 1500, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_at_the_cross_attention_shapes(cuda, B, H, KH, Sq, Skv, hd, dtype):
    _flash_vs_plain(cuda, B, H, KH, Sq, Skv, hd, False, dtype, seed=Sq + Skv)


@pytest.mark.cuda
def test_cuda_flash_bf16_cross_attention_where_outputs_cancel(cuda):
    _flash_vs_plain(cuda, 1, 32, 8, 300, 1601, 128, False, torch.bfloat16, seed=3, cancel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cross_attention_backward_matches_the_cpu(cuda, dtype):
    from repro_torch.kernels.flashattn import flash_attention

    q, k, v = _qkv(cuda, 1, 8, 2, 300, 1601, 128, torch.float32, seed=9)
    go = torch.from_numpy(_rng(10).normal(size=q.shape).astype(np.float32))
    grads = {}
    for side, d in (("card", cuda), ("cpu", torch.device("cpu"))):
        args = [x.to(d, dtype).requires_grad_() for x in (q, k, v)]
        out = flash_attention(*args, causal=False, q_block=128)
        grads[side] = torch.autograd.grad(out, args, go.to(d, dtype))
    for a, b in zip(grads["card"], grads["cpu"]):
        assert a.dtype == dtype and _flash_close(a.cpu(), b, dtype)

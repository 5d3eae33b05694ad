"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with ``nvcc`` and skip elsewhere (a CUDA
kernel has no CPU mode). They import neither JAX nor ``repro``, so they
also run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Histogram, positions (both designs: onesweep and three-phase), the
COBRA pass and the row scatter must be equal; the fused reduces (flat,
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
from repro_torch.kernels.binning import cobra_binning_pass, counting_positions
from repro_torch.kernels.binread import binread_scatter_add
from repro_torch.kernels.fused import cobra_bin_accumulate, cobra_bin_accumulate_rows
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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 17, 5000, 300_001])
@pytest.mark.parametrize("num_bins", [2, 257, 908, 65536])
def test_cuda_histogram_and_positions_match_plain(cuda, m, num_bins):
    keys = torch.from_numpy(_rng(m).integers(0, num_bins, m).astype(np.int32)).to(cuda)
    for k in (keys, torch.full_like(keys, num_bins - 1)):
        counts = histogram(k, num_bins)
        assert torch.equal(counts, tref.histogram_ref(k, num_bins))
        starts = starts_from_counts(counts)[:-1].contiguous()
        assert torch.equal(
            counting_positions(k, starts, num_bins),
            tref.counting_positions_ref(k, starts, num_bins),
        )


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
@pytest.mark.parametrize("m", [1, 4095, 4097, 300_001])
@pytest.mark.parametrize("num_bins", [1, 2, 257, 4096, 12288])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_cuda_cobra_pass_matches_plain(cuda, m, num_bins, dtype):
    rng = _rng(m + num_bins)
    keys = torch.from_numpy(rng.integers(0, num_bins, m).astype(np.int32)).to(cuda)
    for k in (keys, torch.full_like(keys, num_bins // 2)):
        idx = torch.from_numpy(rng.integers(0, 1 << 30, m).astype(np.int32)).to(cuda)
        val = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(cuda)
        val = val if dtype == torch.float32 else val.view(torch.int32)
        starts = starts_from_counts(tref.histogram_ref(k, num_bins))[:-1].contiguous()
        got = cobra_binning_pass(k, idx, val, starts, num_bins)
        want = tref.binned_stream_ref(k, idx, val, num_bins)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1].dtype == dtype


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
def test_cuda_flash_bf16_reads_unaligned_q(cuda):
    """q one element off a 16-byte boundary takes the element loads of the
    Q tile; the result equals the aligned call's."""
    from repro_torch.kernels.flashattn import flash_attention

    B, H, KH, S, hd = 1, 4, 2, 70, 64
    q, k, v = _qkv(cuda, B, H, KH, S, S, hd, torch.bfloat16, seed=11)
    off = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(q.shape)
    off.copy_(q)
    assert off.data_ptr() % 16
    assert torch.equal(flash_attention(off, k, v), flash_attention(q, k, v))


@pytest.mark.cuda
def test_cuda_flash_kernels_route_by_dtype(cuda):
    """The bf16 kernels run on the tensor cores (HMMA in their SASS), the
    float32 kernels on CUDA cores."""
    from repro_torch.kernels import _lib

    sass = _lib.kernel_sass("flash_fwd_")
    bf16 = {n: body for n, body in sass.items() if "flash_fwd_bf16_kernel" in n}
    f32 = {n: body for n, body in sass.items() if "flash_fwd_f32_kernel" in n}
    assert len(bf16) == 4 and len(f32) == 4
    assert all("HMMA" in body for body in bf16.values())
    assert not any("HMMA" in body for body in f32.values())


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
    """k and v are staged with 16-byte loads: a view that starts or steps
    off a 16-byte boundary raises before any launch."""
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

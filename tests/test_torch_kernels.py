"""The three ported kernels' plain versions against the Pallas kernels.

The Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_fused.py`` run them, on the same grids. On the CPU each
wrapper runs its plain version, which is what is held against them here.
Tolerances: histogram and positions are integer results and must be
equal; the fused reduce is exact for int32 and for min/max, and a
float32 add is compared with atol 1e-4 (the reference's own tolerance in
``test_fused.py``: the Pallas kernel sums in flush order).

The CUDA kernels themselves are held against the same plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.binning import counting_positions_pallas
from repro.kernels.fused import cobra_bin_accumulate_pallas, cobra_bin_accumulate_rows_pallas
from repro_torch.convert import to_numpy
from repro_torch.kernels import ref as tref
from repro_torch.kernels.binning import counting_positions
from repro_torch.kernels.fused import cobra_bin_accumulate, cobra_bin_accumulate_rows
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.ops import pb_binning


def _rng(seed=0):
    return np.random.default_rng(seed)


def _eq(t, r):
    np.testing.assert_array_equal(to_numpy(t), np.asarray(r))


# -- histogram (grid of tests/test_kernels.py:23-36) -------------------------


@pytest.mark.parametrize("m", [17, 256, 5000])
@pytest.mark.parametrize("num_bins", [2, 64, 257])
@pytest.mark.parametrize("block", [64, 1024])
def test_histogram_matches_pallas(m, num_bins, block):
    keys = _rng(m + num_bins).integers(0, num_bins, m).astype(np.int32)
    want = rops.histogram(jnp.asarray(keys), num_bins, block=block)
    _eq(histogram(torch.from_numpy(keys), num_bins), want)


def test_histogram_ignores_out_of_range_keys():
    keys = np.asarray([0, 1, 5, 5, 9, 9, 9, -2], np.int32)
    got = histogram(torch.from_numpy(keys), 6)
    _eq(got, [1, 1, 0, 0, 0, 2])
    # the Pallas kernel ignores the same keys (its one-hot spans [0, B))
    _eq(got, rops.histogram(jnp.asarray(keys), 6, block=4))


# -- counting positions (grid of tests/test_kernels.py:44-64) ----------------


@pytest.mark.parametrize(
    "m,num_bins,block", [(100, 8, 32), (5000, 64, 512), (777, 13, 256), (1, 1, 32)]
)
def test_counting_positions_matches_pallas(m, num_bins, block):
    keys = _rng(m).integers(0, num_bins, m).astype(np.int32)
    counts = np.bincount(keys, minlength=num_bins)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1].astype(np.int32)
    want = counting_positions_pallas(
        jnp.asarray(keys), jnp.asarray(starts), num_bins=num_bins, block=block
    )
    got = counting_positions(torch.from_numpy(keys), torch.from_numpy(starts), num_bins)
    _eq(got, want)
    _eq(got, rref.counting_positions_ref(jnp.asarray(keys), jnp.asarray(starts), num_bins))


def test_counting_positions_all_one_key_and_padding():
    keys = np.full(1000, 4, np.int32)
    keys[[3, 500]] = 9  # out of range: -1, as the Pallas kernel gives padding
    starts = np.zeros(9, np.int32)
    got = counting_positions(torch.from_numpy(keys), torch.from_numpy(starts), 9)
    want = counting_positions_pallas(jnp.asarray(keys), jnp.asarray(starts), num_bins=9, block=256)
    _eq(got, want)
    assert int(got[3]) == -1 and int(got[999]) == 997


def test_pb_binning_matches_pallas_composition():
    idx = _rng(5).integers(0, 1000, 3001).astype(np.int32)
    val = _rng(6).normal(size=3001).astype(np.float32)
    want = rops.pb_binning(jnp.asarray(idx), jnp.asarray(val), bin_range=64, num_bins=16, block=512)
    got = pb_binning(torch.from_numpy(idx), torch.from_numpy(val), bin_range=64, num_bins=16)
    _eq(got.idx, want.idx)
    _eq(got.val, want.val)
    _eq(got.starts, want.starts)


# -- fused bin-and-accumulate (grid of tests/test_fused.py:47-72) ------------


def _stream(n, m, seed, dtype):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m).astype(np.int32)
    if dtype == np.int32:
        return idx, rng.integers(-50, 50, m).astype(np.int32)
    return idx, rng.normal(size=m).astype(np.float32)


def _assert_reduce(got, want, dtype, op):
    if dtype == np.int32 or op != "add":
        _eq(got, want)
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_fused_matches_pallas(dtype, op):
    n = 777  # non-pow2: ragged final bin
    idx, val = _stream(n, 3001, 1, dtype)
    want = cobra_bin_accumulate_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=n, bin_range=100, num_bins=8,
        op=op, block=256, cap=512, interpret=True,
    )
    got = cobra_bin_accumulate(torch.from_numpy(idx), torch.from_numpy(val), n, 100, 8, op)
    _assert_reduce(got, want, dtype, op)
    _assert_reduce(got, rref.scatter_reduce_ref(jnp.asarray(idx), jnp.asarray(val), n, op=op), dtype, op)


def test_fused_single_bin_and_empty():
    n = 50
    idx, val = _stream(n, 400, 3, np.float32)
    want = cobra_bin_accumulate_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=n, bin_range=n, num_bins=1,
        block=128, cap=512,
    )
    got = cobra_bin_accumulate(torch.from_numpy(idx), torch.from_numpy(val), n, n, 1)
    _assert_reduce(got, want, np.float32, "add")
    for op in ("add", "min", "max"):
        empty = cobra_bin_accumulate(
            torch.zeros(0, dtype=torch.int32), torch.zeros(0), 10, 5, 2, op
        )
        rempty = cobra_bin_accumulate_pallas(
            jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.float32),
            num_indices=10, bin_range=5, num_bins=2, op=op,
        )
        _eq(empty, rempty)


def test_fused_drops_negative_indices_as_the_pallas_kernel_does():
    """The Pallas kernel drops a -1 tuple; the reference's jnp path
    (``_fused_reduce_jnp``) wraps it to the last index. The port follows
    the kernel: out-of-range tuples, negative ones included, are dropped."""
    idx = np.asarray([0, 5, 7, -1, 6], np.int32)
    val = np.asarray([1, 2, 3, 10, 4], np.float32)
    want = cobra_bin_accumulate_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=8, bin_range=4, num_bins=2,
        block=8, cap=8,
    )
    got = cobra_bin_accumulate(torch.from_numpy(idx), torch.from_numpy(val), 8, 4, 2)
    _eq(got, want)
    assert float(got[7]) == 3.0
    _eq(tref.scatter_reduce_ref(torch.from_numpy(idx), torch.from_numpy(val), 8), want)


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_rows_plain_version_takes_bfloat16_as_the_moe_combine_sends_it(op):
    """The MoE combine's stream: k = 8 bfloat16 rows a token, in token
    order. The plain version reduces in float32 and rounds once (what the
    rows kernel does on the card), so it equals the float32 reduction of
    the same values rounded to bfloat16, bit for bit. Against the Pallas
    kernel, which sums each token's run in one float32 dot and rounds it
    to bfloat16: min/max equal, an add within one bfloat16 step
    (at most 2^-7 |want|) plus the float32 order (1e-5 * sum |v|)."""
    T, k, F = 96, 8, 32
    idx = np.repeat(np.arange(T, dtype=np.int32), k)
    val = torch.from_numpy(_rng(41).normal(size=(T * k, F)).astype(np.float32)).to(torch.bfloat16)
    ti = torch.from_numpy(idx)
    got = cobra_bin_accumulate_rows(ti, val, T, T, 1, op)
    assert got.dtype == torch.bfloat16 and got.shape == (T, F)
    f32 = tref.scatter_reduce_ref(ti, val.float(), T, op)
    _eq(got.view(torch.int16), f32.to(torch.bfloat16).view(torch.int16))
    want = cobra_bin_accumulate_rows_pallas(
        jnp.asarray(idx), jnp.asarray(val.float().numpy()).astype(jnp.bfloat16), num_indices=T,
        bin_range=T, num_bins=1, op=op, block=256, cap=512, interpret=True,
    )
    want = np.asarray(want.astype(jnp.float32))
    if op == "add":
        scale = tref.scatter_reduce_ref(ti, val.float().abs(), T, op).numpy()
        diff = np.abs(got.float().numpy() - want)
        assert (diff <= 2.0**-7 * np.abs(want) + 1e-5 * scale).all(), float(diff.max())
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_fused_argument_checks():
    i, v = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    with pytest.raises(ValueError, match="commutative"):
        cobra_bin_accumulate(i, v, 4, 4, 1, op="mul")
    with pytest.raises(ValueError, match="cover the domain"):
        cobra_bin_accumulate(i, v, 10, 4, 2)
    with pytest.raises(ValueError, match="flat accumulate"):
        cobra_bin_accumulate(i, torch.ones(3, 2), 4, 4, 1)


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        histogram(keys, 4)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        counting_positions(keys, torch.zeros(4, dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cobra_bin_accumulate(keys, torch.ones(4, device="meta"), 4, 4, 1)


# -- the other oracles of kernels/ref.py ---------------------------------------


def test_other_oracles_match_reference():
    rng = _rng(21)
    keys = rng.integers(0, 9, 300).astype(np.int32)
    idx = rng.integers(0, 50, 300).astype(np.int32)
    val = rng.integers(0, 1000, 300).astype(np.int32)
    for a, b in zip(
        tref.binned_stream_ref(torch.from_numpy(keys), torch.from_numpy(idx), torch.from_numpy(val), 9),
        rref.binned_stream_ref(jnp.asarray(keys), jnp.asarray(idx), jnp.asarray(val), 9),
    ):
        _eq(a, b)
    ip = rng.integers(-1, 32, (4, 6)).astype(np.int32)  # -1 marks padding
    vp = rng.normal(size=(4, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        to_numpy(tref.binread_scatter_add_ref(torch.from_numpy(ip), torch.from_numpy(vp), 8)),
        np.asarray(rref.binread_scatter_add_ref(jnp.asarray(ip), jnp.asarray(vp), 8)),
        rtol=1e-6, atol=1e-6,
    )
    x = rng.normal(size=(10, 4)).astype(np.float32)
    pos = np.asarray([3, -1, 0, 7, 2, -1, 9, 1, 5, 4], np.int32)
    _eq(
        tref.scatter_rows_ref(torch.from_numpy(x), torch.from_numpy(pos), 12),
        rref.scatter_rows_ref(jnp.asarray(x), jnp.asarray(pos), 12),
    )

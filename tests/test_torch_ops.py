"""The second slice's kernels and ``ops`` entry points against the reference.

The Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_fused.py`` run them; on the CPU each port wrapper runs its
plain version, which is what is held against them here (the CUDA kernels
are held against the same plain versions on the card by
``tests/test_torch_cuda.py``). Tolerances:

- the rows reduce is exact for int32 and min/max; a float32 add within
  atol 1e-4 (``test_fused.py``'s own: the Pallas kernel sums in flush
  order);
- COBRA passes, binned streams and row scatters are equal;
- Bin-Read float32 within atol 1e-5 and bfloat16 within atol 1e-1, as
  ``tests/test_kernels.py:139`` allows (the two round at other places);
- ``pb_scatter_add_full`` within atol 1e-4 (``tests/test_kernels.py:191``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pb as rpb
from repro.core.plan import CobraPlan as RPlan
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.fused import cobra_bin_accumulate_rows_pallas
from repro_torch.convert import plan_from_fields, to_numpy
from repro_torch.core import pb as tpb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.binning import cobra_binning_pass as cobra_pass_kernel
from repro_torch.kernels.fused import cobra_bin_accumulate_rows

_T = {np.float32: torch.float32, np.int32: torch.int32}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _eq(t, r):
    np.testing.assert_array_equal(to_numpy(t), np.asarray(r))


def _rows(n, m, F, dtype, seed):
    rng = _rng(seed)
    idx = rng.integers(0, n, m).astype(np.int32)
    if dtype == np.int32:
        return idx, rng.integers(-50, 50, (m, F)).astype(np.int32)
    return idx, rng.normal(size=(m, F)).astype(np.float32)


# -- the rows reduce (grid of tests/test_fused.py:75-120) --------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_rows_reduce_matches_pallas_with_ragged_f_tile(dtype, op):
    """f_tile = 3 over F = 7 is the Pallas kernel's ragged last tile."""
    n, F = 301, 7
    idx, val = _rows(n, 600, F, dtype, 31)
    want = cobra_bin_accumulate_rows_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=n, bin_range=50, num_bins=7,
        op=op, block=256, cap=512, f_tile=3, interpret=True,
    )
    got = cobra_bin_accumulate_rows(
        torch.from_numpy(idx), torch.from_numpy(val), n, 50, 7, op, f_tile=3
    )
    assert got.dtype == _T[dtype] and got.shape == (n, F)
    if dtype == np.float32 and op == "add":
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4)
    else:
        _eq(got, want)


def test_rows_reduce_edges_match_pallas():
    """Empty stream, F = 0 and a single bin hold the reference's shapes and
    identities; the size checks come after the empty returns."""
    empty = cobra_bin_accumulate_rows(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, 4), 10, 5, 2, "max"
    )
    want = cobra_bin_accumulate_rows_pallas(
        jnp.zeros((0,), jnp.int32), jnp.zeros((0, 4), jnp.float32),
        num_indices=10, bin_range=5, num_bins=2, op="max",
    )
    _eq(empty, want)
    idx, val = _rows(40, 300, 1, np.float32, 33)
    fless = cobra_bin_accumulate_rows(
        torch.from_numpy(idx), torch.zeros(300, 0), 40, 5, 1  # bins do not cover: F = 0 first
    )
    assert fless.shape == (40, 0)
    one = cobra_bin_accumulate_rows(torch.from_numpy(idx), torch.from_numpy(val), 40, 40, 1)
    want = cobra_bin_accumulate_rows_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=40, bin_range=40, num_bins=1,
        block=128, cap=512, interpret=True,
    )
    np.testing.assert_allclose(to_numpy(one), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="cover"):
        cobra_bin_accumulate_rows(torch.from_numpy(idx), torch.from_numpy(val), 40, 5, 1)
    with pytest.raises(ValueError, match="f_tile"):
        cobra_bin_accumulate_rows(torch.from_numpy(idx), torch.from_numpy(val), 40, 40, 1,
                                  f_tile=2)
    with pytest.raises(ValueError, match="commutative"):
        cobra_bin_accumulate_rows(torch.from_numpy(idx), torch.from_numpy(val), 40, 40, 1,
                                  op="concat")


def test_rows_reduce_drops_out_of_range_rows():
    idx = np.asarray([0, 5, 7, -1, 6, 9], np.int32)
    val = np.arange(12, dtype=np.float32).reshape(6, 2)
    got = to_numpy(cobra_bin_accumulate_rows(torch.from_numpy(idx), torch.from_numpy(val), 8, 4, 2))
    want = np.zeros((8, 2), np.float32)
    for k, v in zip(idx, val):
        if 0 <= k < 8:
            want[k] += v
    np.testing.assert_array_equal(got, want)


# -- the COBRA pass and hierarchical COBRA binning ---------------------------


@pytest.mark.parametrize("m,n,bin_range", [(3000, 1000, 64), (777, 4096, 512), (1, 10, 10)])
def test_cobra_binning_pass_matches_reference(m, n, bin_range):
    idx = _rng(m + n).integers(0, n, m).astype(np.int32)
    val = _rng(m).integers(-1000, 1000, m).astype(np.int32)
    nb = -(-n // bin_range)
    want = rops.cobra_binning_pass(jnp.asarray(idx), jnp.asarray(val), bin_range=bin_range,
                                   num_bins=nb)
    got = tops.cobra_binning_pass(torch.from_numpy(idx), torch.from_numpy(val),
                                  bin_range=bin_range, num_bins=nb)
    _eq(got.idx, want.idx)
    _eq(got.val, want.val)
    _eq(got.starts, want.starts)
    assert got.bin_range == want.bin_range and got.idx.shape == (m,)


def test_cobra_binning_matches_reference_over_two_passes():
    n, m = 1000, 3000
    idx = _rng(5).integers(0, n, m).astype(np.int32)
    val = _rng(6).integers(-1000, 1000, m).astype(np.int32)
    rplan = RPlan(n, 8, (5, 25))
    tplan = plan_from_fields(rplan.num_indices, rplan.final_bin_range, rplan.level_fanouts)
    assert tplan.level_ranges() == [200, 8]
    want = rops.cobra_binning(jnp.asarray(idx), jnp.asarray(val), rplan)
    got = tops.cobra_binning(torch.from_numpy(idx), torch.from_numpy(val), tplan)
    for a, b in zip((got.idx, got.val, got.starts), (want.idx, want.val, want.starts)):
        _eq(a, b)
    with pytest.raises(ValueError, match="bins"):
        tops.cobra_binning(torch.from_numpy(idx), torch.from_numpy(val), tplan,
                           max_bins_per_pass=100)


def test_cobra_binning_keeps_float_values():
    """The reference declares its value output int32 (ROADMAP.md, Queue 3),
    so float32 values are held against the stable-sort oracle instead."""
    n, m, r = 1000, 2500, 40
    idx = _rng(7).integers(0, n, m).astype(np.int32)
    val = _rng(8).normal(size=m).astype(np.float32)
    got = tops.cobra_binning_pass(torch.from_numpy(idx), torch.from_numpy(val), bin_range=r,
                                  num_bins=-(-n // r))
    want_i, want_v = rref.binned_stream_ref(jnp.asarray(idx // r), jnp.asarray(idx),
                                            jnp.asarray(val), -(-n // r))
    assert got.val.dtype == torch.float32
    _eq(got.idx, want_i)
    _eq(got.val, want_v)
    # the kernel's own plain version on its own arguments
    keys = tpb.bin_ids(torch.from_numpy(idx), r)
    starts = tpb.starts_from_counts(tref.histogram_ref(keys, -(-n // r)))[:-1]
    k_idx, k_val = cobra_pass_kernel(keys, torch.from_numpy(idx), torch.from_numpy(val), starts,
                                     -(-n // r))
    _eq(k_idx, want_i)
    _eq(k_val, want_v)


# -- Bin-Read (grid of tests/test_kernels.py:128-150) ------------------------


@pytest.mark.parametrize("B,L,R,d", [(4, 16, 8, 1), (8, 64, 32, 4), (16, 128, 128, 8)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_binread_matches_reference(B, L, R, d, dtype):
    r = _rng(B * L)
    idx = np.stack([r.integers(b * R, (b + 1) * R, L) for b in range(B)]).astype(np.int32)
    idx[:, -3:] = -1
    val = r.normal(size=(B, L, d)).astype(np.float32)
    want = rops.binread_scatter_add(jnp.asarray(idx), jnp.asarray(val, dtype), bin_range=R)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = tops.binread_scatter_add(torch.from_numpy(idx), torch.from_numpy(val).to(tdt), R)
    assert got.dtype == tdt and got.shape == (B * R, d)
    atol = 1e-5 if dtype == jnp.float32 else 1e-1
    np.testing.assert_allclose(
        to_numpy(got.float()), np.asarray(want, np.float32), atol=atol
    )


def test_binread_coalesces_duplicates():
    idx = torch.tensor([[1, 1, 1, 2, 2, 3, -1, -1]], dtype=torch.int32)
    out = tops.binread_scatter_add(idx, torch.ones(1, 8, 2), 4)
    np.testing.assert_allclose(to_numpy(out[:, 0]), [0.0, 3.0, 2.0, 1.0])


# -- row scatter (grid of tests/test_kernels.py:158-177) ---------------------


@pytest.mark.parametrize("m,d", [(64, 8), (1000, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_scatter_rows_matches_reference(m, d, dtype):
    r = _rng(m * d)
    x = r.integers(-100, 100, (m, d)).astype(np.float32)
    pos = r.permutation(m).astype(np.int32)
    pos[::5] = -1
    want = rops.scatter_rows(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(pos), m,
                             block=32)
    got = tops.scatter_rows(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos), m)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(to_numpy(got.float()), np.asarray(want, np.float32))


def test_scatter_rows_drops_negative_positions():
    got = tops.scatter_rows(torch.ones(4, 2), torch.tensor([0, -1, 2, -1], dtype=torch.int32), 4)
    np.testing.assert_array_equal(to_numpy(got).sum(axis=1), [2.0, 0.0, 2.0, 0.0])


# -- padded layout and the whole pipeline ------------------------------------


def test_padded_bin_layout_matches_reference():
    n, m, r = 300, 1000, 32
    idx = _rng(9).integers(0, n, m).astype(np.int32)
    val = _rng(10).normal(size=(m, 3)).astype(np.float32)
    nb = -(-n // r)
    rb = rpb.binning(jnp.asarray(idx), jnp.asarray(val), r, nb, method="sort")
    tb = tpb.binning(torch.from_numpy(idx), torch.from_numpy(val), r, nb, method="sort")
    L = int(np.max(np.diff(np.asarray(rb.starts)))) - 2  # truncates the longest bins
    want_i, want_v = rops.padded_bin_layout(rb, nb, L)
    got_i, got_v = tops.padded_bin_layout(tb, nb, L)
    _eq(got_i, want_i)
    _eq(got_v, want_v)


@pytest.mark.parametrize("m,n,d,bin_range", [(2000, 512, 8, 64), (4096, 4096, 4, 256)])
def test_pb_scatter_add_full_matches_reference(m, n, d, bin_range):
    r = _rng(m + n)
    idx = r.integers(0, n, m).astype(np.int32)
    upd = r.normal(size=(m, d)).astype(np.float32)
    want = rops.pb_scatter_add_full(jnp.asarray(idx), jnp.asarray(upd), n,
                                    bin_range=bin_range, block=512)
    got = tops.pb_scatter_add_full(torch.from_numpy(idx), torch.from_numpy(upd), n,
                                   bin_range=bin_range)
    assert got.shape == (n, d)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4)
    dense = np.zeros((n, d), np.float64)
    np.add.at(dense, idx, upd)
    np.testing.assert_allclose(to_numpy(got), dense, atol=1e-4)


def test_binread_adds_out_of_bin_indices_as_the_oracle_does():
    """The Pallas kernel drops an index outside its own bin's range (its
    one-hot spans that range), while ``ref.binread_scatter_add_ref`` adds
    it at its global row. The port follows the oracle (ROADMAP.md,
    Queue 3); a layout from ``padded_bin_layout`` never holds such an
    index, so the two agree on every path."""
    idx = np.asarray([[0, 5, -1, -1], [6, 1, 7, -1]], np.int32)
    val = np.ones((2, 4, 1), np.float32)
    got = to_numpy(tops.binread_scatter_add(torch.from_numpy(idx), torch.from_numpy(val), 4))
    want = rref.binread_scatter_add_ref(jnp.asarray(idx), jnp.asarray(val), 4)
    np.testing.assert_array_equal(got, np.asarray(want))
    pallas = np.asarray(rops.binread_scatter_add(jnp.asarray(idx), jnp.asarray(val), bin_range=4))
    np.testing.assert_array_equal(got[:, 0] - pallas[:, 0], [0, 1, 0, 0, 0, 1, 0, 0])

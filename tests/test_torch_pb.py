"""Port parity: PB primitives and COBRA hierarchical binning.

Binning is a stable partition, so every binned stream, destination and
count must be bit-identical to the reference's; min/max and int32 adds
are exact, and float32 adds run the same sequential order on the CPU, so
they are compared exactly too. Inputs are made from a seed with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cobra as rcobra
from repro.core import pb as rpb
from repro.core.plan import CobraPlan as RPlan
from repro_torch.convert import plan_from_fields, to_numpy
from repro_torch.core import cobra as tcobra
from repro_torch.core import pb as tpb


def _stream(n, m, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m).astype(np.int32)
    if np.issubdtype(dtype, np.integer):
        val = rng.integers(-50, 50, m).astype(dtype)
    else:
        val = rng.normal(size=m).astype(dtype)
    return idx, val


def _eq(t, r):
    np.testing.assert_array_equal(to_numpy(t), np.asarray(r))


# ragged m (not a multiple of the reference's 2048 block) and the empty stream
SHAPES = [(777, 3001, 100), (64, 5000, 7), (1000, 0, 50), (50, 1, 50), (4096, 4096, 32)]


@pytest.mark.parametrize("n,m,r", SHAPES)
@pytest.mark.parametrize("method", ["sort", "counting"])
def test_binning_bit_exact(n, m, r, method):
    idx, val = _stream(n, m, seed=n + m)
    nb = -(-n // r)
    want = rpb.binning(jnp.asarray(idx), jnp.asarray(val), r, nb, method=method)
    got = tpb.binning(torch.from_numpy(idx), torch.from_numpy(val), r, nb, method=method)
    _eq(got.idx, want.idx)
    _eq(got.val, want.val)
    _eq(got.starts, want.starts)
    assert got.bin_range == r and got.num_bins == nb


@pytest.mark.parametrize("m,nb", [(1, 1), (3001, 8), (5000, 64), (2048, 1), (4097, 300)])
def test_counting_permutation_and_inverse_bit_exact(m, nb):
    bids = np.random.default_rng(m).integers(0, nb, m).astype(np.int32)
    rd, rc = rpb.counting_permutation(jnp.asarray(bids), nb)
    td, tc = tpb.counting_permutation(torch.from_numpy(bids), nb)
    _eq(td, rd)
    _eq(tc, rc)
    _eq(tpb.inverse_permutation(td), rpb.inverse_permutation(rd))


def test_counting_permutation_all_one_key():
    bids = np.full(5000, 3, np.int32)
    rd, _ = rpb.counting_permutation(jnp.asarray(bids), 8)
    td, _ = tpb.counting_permutation(torch.from_numpy(bids), 8)
    _eq(td, rd)


@pytest.mark.parametrize(
    "n,m,fields",
    [(2048, 4096, (2048, 32, (8, 8))), (777, 3001, (777, 7, (4, 4, 7))), (300, 0, (300, 10, (30,)))],
)
def test_hierarchical_binning_bit_exact(n, m, fields):
    idx, val = _stream(n, m, seed=m + 3, dtype=np.int32)
    rplan = RPlan(fields[0], fields[1], fields[2])
    tplan = plan_from_fields(*fields)
    want = rcobra.hierarchical_binning(jnp.asarray(idx), jnp.asarray(val), rplan)
    got = tcobra.hierarchical_binning(torch.from_numpy(idx), torch.from_numpy(val), tplan)
    _eq(got.idx, want.idx)
    _eq(got.val, want.val)
    _eq(got.starts, want.starts)


def test_hierarchical_binning_wide_pass_branch():
    """A pass with more than 4096 bins takes the reference's argsort
    branch; the port's single realisation must still agree."""
    n, m = 20000, 6000
    idx, val = _stream(n, m, seed=5)
    rplan, tplan = RPlan(n, 2, (10000,)), plan_from_fields(n, 2, (10000,))
    want = rcobra.hierarchical_binning(jnp.asarray(idx), jnp.asarray(val), rplan)
    got = tcobra.hierarchical_binning(torch.from_numpy(idx), torch.from_numpy(val), tplan)
    _eq(got.idx, want.idx)
    _eq(got.val, want.val)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n,m,r", [(777, 3001, 100), (100, 0, 10), (31, 500, 31)])
def test_bin_read_reduce_bit_exact(op, dtype, n, m, r):
    idx, val = _stream(n, m, seed=11, dtype=dtype)
    nb = -(-n // r)
    rb = rpb.binning_sort(jnp.asarray(idx), jnp.asarray(val), r, nb)
    tb = tpb.binning_sort(torch.from_numpy(idx), torch.from_numpy(val), r, nb)
    _eq(tpb.bin_read_reduce(tb, n, op=op), rpb.bin_read_reduce(rb, n, op=op))


def test_bin_read_reduce_rows_and_scatter_add():
    idx, _ = _stream(90, 700, seed=2)
    rows = np.random.default_rng(3).normal(size=(700, 5)).astype(np.float32)
    rb = rpb.binning_sort(jnp.asarray(idx), jnp.asarray(rows), 16, 6)
    tb = tpb.binning_sort(torch.from_numpy(idx), torch.from_numpy(rows), 16, 6)
    for op in ("add", "max"):
        _eq(tpb.bin_read_reduce(tb, 90, op=op), rpb.bin_read_reduce(rb, 90, op=op))
    _eq(tpb.bin_read_scatter_add(tb, 90), rpb.bin_read_scatter_add(rb, 90))


@pytest.mark.parametrize(
    "dtype,tdtype", [(jnp.float32, torch.float32), (jnp.int32, torch.int32), (jnp.float16, torch.float16)]
)
def test_reduce_identity_values(dtype, tdtype):
    for op in ("add", "min", "max"):
        want = np.asarray(rpb.reduce_identity(op, dtype))
        got = tpb.reduce_identity(op, tdtype)
        assert got == want.item(), (op, got, want)
        filled = torch.full((3,), got, dtype=tdtype)
        assert (to_numpy(filled) == want).all()
    assert tpb.reduce_identity("min", torch.float32) == torch.finfo(torch.float32).max
    with pytest.raises(ValueError, match="unknown reduce op"):
        tpb.reduce_identity("mul", tdtype)


def test_value_block_shape_policy():
    assert tpb.value_block_shape(torch.zeros(4)) == ()
    assert tpb.value_block_shape(torch.zeros(4, 3)) == (3,)
    with pytest.raises(ValueError, match="rank 3"):
        tpb.value_block_shape(torch.zeros(2, 2, 2))
    with pytest.raises(TypeError):
        tpb.value_block_shape([1, 2])


def test_cobra_scatter_add_matches_reference():
    idx, val = _stream(500, 4000, seed=17)
    rplan, tplan = RPlan(500, 8, (8, 8)), plan_from_fields(500, 8, (8, 8))
    np.testing.assert_allclose(
        to_numpy(tcobra.cobra_scatter_add(torch.from_numpy(idx), torch.from_numpy(val), 500, tplan)),
        np.asarray(rcobra.cobra_scatter_add(jnp.asarray(idx), jnp.asarray(val), 500, rplan)),
        rtol=1e-6, atol=1e-6,
    )

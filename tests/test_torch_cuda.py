"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with ``nvcc`` and skip elsewhere (a CUDA
kernel has no CPU mode). They import neither JAX nor ``repro``, so they
also run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Histogram and positions must be equal; the fused reduce is exact for
int32 and min/max, and a float32 add may differ from the sequential sum
by at most 1e-5 of the magnitudes summed at an index (the order in which
the atomics land changes from run to run).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pb import starts_from_counts
from repro_torch.kernels import ref as tref
from repro_torch.kernels.binning import counting_positions
from repro_torch.kernels.fused import cobra_bin_accumulate
from repro_torch.kernels.histogram import histogram


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

"""The index arithmetic of the one-pass kernels, emulated in numpy on the CPU.

``csrc/positions.cu`` (onesweep design) and the two-pass design of
``csrc/fused.cu`` run only on the card. This file re-enacts what their
blocks compute, step by step, at small tiles, and holds the result
against the Pallas kernels in interpret mode (as ``tests/test_kernels.py``
and ``tests/test_fused.py`` run them) and the plain versions:

- positions: tiles of warps x 32 x items keys in stream order, the warp
  multisplit by ballots over the key bits (``rank_warp``), the scan of
  each bin's warp counts in warp order, and the decoupled look-back over
  (tile, bin) status words seeded by ``starts``, walked in windows, with
  predecessors that have published only their aggregate;
- the fused two-pass design: the slab plan (``fused.fused_plan``), the
  slab counts and the slab starts that seed the look-back, per-tile
  staging grouped by slab (the order inside a slab is free), the 16-bit
  offsets inside a slab, the work list of chunks of a hot slab, and the
  merge of a split slab (first chunk stores, the others merge the entries
  they touched).

Streams: uniform, one key, a hub (half of the stream to one index), all
out of range, and whole tiles with no key in range. Positions must equal
the Pallas kernel bit for bit; the fused result is exact for int32 and
min/max, and a float32 add is held to atol 1e-4, the reference's own
tolerance in ``tests/test_fused.py`` (the Pallas kernel sums in flush
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.binning import counting_positions_pallas
from repro.kernels.fused import cobra_bin_accumulate_pallas
from repro_torch.core.pb import reduce_identity
from repro_torch.kernels import ref as tref
from repro_torch.kernels.binning import ONESWEEP_MAX_BINS, positions_design
from repro_torch.kernels.fused import (
    CHUNK_MIN, SLAB_MAX, TWO_PASS_MAX_INDICES, TWO_PASS_MAX_SLABS, fused_design, fused_plan)

BIN_BITS = 12  # csrc/pb_onesweep.cuh: kBinBits
NO_BIN = (1 << BIN_BITS) - 1
WINDOW = 8  # csrc/pb_onesweep.cuh: kWindow


def _stream(kind, m, n, seed, negative=True):
    """Indices in [0, n) of one of the test streams, some out of range:
    negative ones too where ``negative`` (the Pallas fused kernel drops
    only -1, and the port every negative index: ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m)
    low = -3 if negative else n + 3
    if kind == "one-key":
        idx[:] = n // 3
    elif kind == "hub":
        idx[rng.random(m) < 0.5] = 7 % n
    elif kind == "out-of-range":
        idx = np.where(rng.random(m) < 0.5, low - idx if negative else low + idx, n + idx)
    elif kind == "empty-tiles":
        idx[m // 4: m // 2] = n + 5  # whole tiles with no index in range
    else:
        idx[rng.random(m) < 0.02] = low  # a few out of range
    return idx.astype(np.int32)


# -- the shared core ---------------------------------------------------------


def _peers_by_ballots(keys32, num_bins):
    """rank_warp's multisplit: lanes whose keys agree on the low
    bit_length(num_bins) bits, one ballot per bit."""
    nbits = int(num_bins).bit_length()
    peers = np.full(32, 0xFFFFFFFF, np.int64)
    for i in range(nbits):
        bit = (keys32 >> i) & 1
        ballot = int(sum(1 << l for l in range(32) if bit[l]))
        peers &= np.where(bit == 1, ballot, ~ballot & 0xFFFFFFFF)
    return peers


def _rank_tile(bins, valid, num_bins, warps, items):
    """One tile, as rank_warp and scan_warps leave it: per key, its warp's
    offset in the tile plus its rank in the warp; per bin, the tile count."""
    T = warps * 32 * items
    local = np.zeros(T, np.int64)
    counts = np.zeros((warps, num_bins), np.int64)
    lt = np.array([(1 << l) - 1 for l in range(32)], np.int64)
    for w in range(warps):
        row = np.zeros(num_bins, np.int64)
        for j in range(items):
            sl = slice(w * 32 * items + j * 32, w * 32 * items + (j + 1) * 32)
            k = np.where(valid[sl], bins[sl], NO_BIN)
            peers = _peers_by_ballots(k, num_bins)
            same = np.array([[k[a] == k[b] for b in range(32)] for a in range(32)])
            want = np.array([sum(1 << b for b in range(32) if same[a, b]) for a in range(32)])
            assert np.array_equal(peers, want)  # the sentinel's low bits differ from every bin
            ok = k < num_bins
            before = np.where(ok, row[np.minimum(k, num_bins - 1)], 0)
            rank = np.array([bin(int(p & m)).count("1") for p, m in zip(peers, lt)])
            local[sl] = before + rank
            for b in np.unique(k[ok]):
                row[b] += int((k == b).sum())
        counts[w] = row
    excl = np.cumsum(counts, axis=0) - counts  # warp order
    return local, excl, counts.sum(axis=0)


class _Status:
    """The (tiles, bins) status words: tile t's aggregate (flag 1) and its
    inclusive prefix (flag 2). ``walk`` reads back in windows of WINDOW
    tiles; ``shown`` says which predecessors still show only their
    aggregate, as a tile that has not finished its own walk would."""

    def __init__(self, tiles, num_bins):
        self.agg = np.zeros((tiles, num_bins), np.int64)
        self.inc = np.zeros((tiles, num_bins), np.int64)

    def walk(self, tile, b, hidden):
        run, t = 0, tile - 1
        while True:
            for k in range(WINDOW):
                u = t - k
                assert u >= 0, "a walk passed tile 0"
                if u == 0 or u not in hidden:  # tile 0 publishes its inclusive prefix only
                    return run + self.inc[u, b]
                run += self.agg[u, b]
            t -= WINDOW


def _look_back(status, tile, tot, seed, rng):
    """look_back for every bin of ``tile``: the first destination of the
    tile's keys of bin b. A random half of the earlier tiles show only
    their aggregate."""
    status.agg[tile] = tot
    hidden = {u for u in range(1, tile) if rng.random() < 0.5}
    pre = seed.copy() if tile == 0 else np.array(
        [status.walk(tile, b, hidden) for b in range(len(tot))], np.int64)
    status.inc[tile] = pre + tot
    return pre


def positions_onesweep(keys, starts, num_bins, warps=2, items=3, seed=0):
    """csrc/positions.cu, onesweep design, at a tile of warps x 32 x items."""
    m = len(keys)
    T = warps * 32 * items
    tiles = -(-m // T)
    rng = np.random.default_rng(seed)
    status = _Status(tiles, num_bins)
    pos = np.empty(m, np.int64)
    for tile in range(tiles):  # ticket order
        i = tile * T + np.arange(T)
        k = np.where(i < m, keys[np.minimum(i, m - 1)], -1)
        valid = (i < m) & (k >= 0) & (k < num_bins)
        local, excl, tot = _rank_tile(np.where(valid, k, 0), valid, num_bins, warps, items)
        pre = _look_back(status, tile, tot, starts.astype(np.int64), rng)
        w = np.arange(T) // (32 * items)
        kk = np.where(valid, k, 0)
        p = np.where(valid, pre[kk] + excl[w, kk] + local, -1)
        pos[i[i < m]] = p[i < m]
    return pos.astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "one-key", "hub", "out-of-range", "empty-tiles"])
@pytest.mark.parametrize("num_bins", [2, 13, 300])
def test_positions_onesweep_arithmetic_matches_pallas(kind, num_bins):
    keys = _stream(kind, 2500, num_bins, num_bins)
    valid = (keys >= 0) & (keys < num_bins)
    counts = np.bincount(keys[valid], minlength=num_bins)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    want = counting_positions_pallas(jnp.asarray(keys), jnp.asarray(starts),
                                     num_bins=num_bins, block=256)
    got = positions_onesweep(keys, starts, num_bins)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the port's plain version (the reference's jnp oracle treats negative
    # keys otherwise, ROADMAP Queue 3; the Pallas kernel gives them -1)
    np.testing.assert_array_equal(got, tref.counting_positions_ref(
        torch.from_numpy(keys), torch.from_numpy(starts), num_bins).numpy())


@pytest.mark.parametrize("m", [191, 192, 193])  # a tile of 2 x 32 x 3 keys, and one past it
def test_positions_onesweep_tile_edges(m):
    keys = _stream("uniform", m, 5, m)
    valid = (keys >= 0) & (keys < 5)
    counts = np.bincount(keys[valid], minlength=5)
    starts = (np.cumsum(counts) - counts + 11).astype(np.int32)  # regions need not start at 0
    want = counting_positions_pallas(jnp.asarray(keys), jnp.asarray(starts), num_bins=5, block=64)
    np.testing.assert_array_equal(positions_onesweep(keys, starts, 5), np.asarray(want))


def test_positions_design_switch():
    assert positions_design(ONESWEEP_MAX_BINS) == "onesweep"
    assert positions_design(ONESWEEP_MAX_BINS + 1) == "three-phase"
    # bin and in-warp rank share one register: 12 bits of bin, the rank above
    assert ONESWEEP_MAX_BINS < NO_BIN and (32 * 32 - 1) << BIN_BITS < 2**31


# -- the fused two-pass design -------------------------------------------------


def fused_two_pass(idx, val, n, op, sms, warps=2, items=4, seed=0):
    """csrc/fused.cu, two-pass design: returns the dense output and the
    binned stream (slab starts, 16-bit offsets, values)."""
    m = len(idx)
    shift, slabs, chunk = fused_plan(m, n, sms)
    S = 1 << shift
    assert S <= SLAB_MAX and slabs <= TWO_PASS_MAX_SLABS
    ok = (idx >= 0) & (idx < n)
    slab = np.where(ok, idx >> shift, slabs)
    # (1) slab counts; tile 0 seeds the look-back with the slab starts and
    # writes the work list: max(1, ceil(count / chunk)) items a slab
    counts = np.bincount(slab[ok], minlength=slabs).astype(np.int64)
    slab_start = np.concatenate([[0], np.cumsum(counts)])
    nch = np.where(counts > chunk, -(-counts // chunk), 1)
    item_start = np.concatenate([[0], np.cumsum(nch)])
    # (2) binning: per tile, stage grouped by slab (any order inside a
    # slab), look back for each slab's cursor, write the runs out
    rng = np.random.default_rng(seed)
    T = warps * 32 * items
    tiles = -(-m // T)
    status = _Status(tiles, slabs)
    off = np.full(m, -1, np.int64)
    out_val = np.zeros(m, val.dtype)
    for tile in range(tiles):
        i = np.arange(tile * T, min((tile + 1) * T, m))
        mine = i[ok[i]]
        tot = np.bincount(slab[mine], minlength=slabs)
        first = np.cumsum(tot) - tot
        staged = mine[np.lexsort((rng.random(len(mine)), slab[mine]))]  # grouped, order free
        pre = _look_back(status, tile, tot, slab_start[:-1], rng)
        delta = pre - first
        d = delta[slab[staged]] + np.arange(len(staged))
        assert len(np.unique(d)) == len(d)
        off[d] = idx[staged] & (S - 1)
        out_val[d] = val[staged]
    total = int(slab_start[-1])
    assert (off[:total] >= 0).all() and (off[total:] == -1).all()
    off16 = off[:total].astype(np.uint16)  # offsets inside a slab fit 16 bits
    assert np.array_equal(off16, off[:total])
    # (3) accumulate: work items in ticket order; a split slab's first
    # chunk stores its slab, the others merge the entries they touched
    ident = reduce_identity(op, torch.float32 if val.dtype == np.float32 else torch.int32)
    comb = {"add": np.add, "min": np.minimum, "max": np.maximum}[op]
    out = np.full(n, -12345, val.dtype)  # the two-pass kernel writes every entry
    for w in range(int(item_start[-1])):
        b = int(np.searchsorted(item_start, w, side="right") - 1)
        c = w - int(item_start[b])
        lo = int(slab_start[b]) + c * chunk
        hi = min(lo + chunk, int(slab_start[b + 1]))
        length = min(S, n - b * S)
        acc = np.full(length, ident, val.dtype)
        comb.at(acc, off16[lo:hi].astype(np.int64), out_val[lo:hi])
        seg = slice(b * S, b * S + length)
        if c == 0:
            out[seg] = acc
        else:
            touched = acc != ident
            out[seg][touched] = comb(out[seg][touched], acc[touched])
    return out, (slab_start, off16, out_val[:total], chunk)


def _fused_inputs(kind, dtype, m, n, seed, negative=False):
    idx = _stream(kind, m, n, seed, negative)
    rng = np.random.default_rng(seed + 1)
    if dtype == np.int32:
        return idx, rng.integers(-50, 50, m).astype(np.int32)
    return idx, rng.normal(size=m).astype(np.float32)


def _assert_reduce(got, want, dtype, op):
    if dtype == np.int32 or op != "add":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("kind", ["uniform", "one-key", "hub", "out-of-range", "empty-tiles"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_fused_two_pass_arithmetic_matches_pallas(kind, dtype, op):
    m, n = 3001, 1500  # at 2 SMs: slabs of 512 (the SLAB_MIN floor is 256), a ragged last slab
    idx, val = _fused_inputs(kind, dtype, m, n, 17)
    got, (slab_start, _, _, chunk) = fused_two_pass(idx, val, n, op, sms=2)
    assert chunk == CHUNK_MIN
    want = cobra_bin_accumulate_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=n, bin_range=128, num_bins=12, op=op,
        block=256, cap=512, interpret=True)
    _assert_reduce(got, want, dtype, op)
    # with negative indices too, against the port's plain version (dropped)
    idx, val = _fused_inputs(kind, dtype, m, n, 17, negative=True)
    got, _ = fused_two_pass(idx, val, n, op, sms=2)
    _assert_reduce(got, tref.scatter_reduce_ref(torch.from_numpy(idx), torch.from_numpy(val), n,
                                                op=op).numpy(), dtype, op)


@pytest.mark.parametrize("kind", ["one-key", "hub"])
def test_fused_two_pass_splits_a_hot_slab(kind):
    """A slab holding more than twice the mean is cut into work items of
    ``chunk`` tuples whose merges must give the plain result."""
    m, n = 40_000, 8000  # at 8 SMs: 16 slabs of 512, chunks of 5000
    idx, val = _fused_inputs(kind, np.int32, m, n, 5)
    got, (slab_start, _, _, chunk) = fused_two_pass(idx, val, n, "add", sms=8, items=16)
    assert int(np.diff(slab_start).max()) > 2 * chunk  # at least three chunks
    want = rref.scatter_reduce_ref(jnp.asarray(idx), jnp.asarray(val), n, op="add")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fused_two_pass_binned_stream_and_16_bit_offsets():
    """At one SM the slab is SLAB_MAX = 32768 entries: offsets reach 32767
    and still fit 16 bits; each slab's run holds exactly its tuples."""
    m, n = 6000, (1 << 16) + 3
    idx, val = _fused_inputs("uniform", np.int32, m, n, 9)
    idx[:3] = [0, 32767, n - 1]
    shift, slabs, _ = fused_plan(m, n, 1)
    assert 1 << shift == SLAB_MAX and slabs == 3
    got, (slab_start, off16, vals, _) = fused_two_pass(idx, val, n, "max", sms=1)
    assert int(off16.max()) == 32767
    ok = (idx >= 0) & (idx < n)
    for b in range(slabs):
        run = slice(int(slab_start[b]), int(slab_start[b + 1]))
        mine = ok & (idx >> shift == b)
        got_pairs = sorted(zip((off16[run].astype(np.int64) + (b << shift)).tolist(),
                               vals[run].tolist()))
        assert got_pairs == sorted(zip(idx[mine].tolist(), val[mine].tolist()))
    want = rref.scatter_reduce_ref(jnp.asarray(idx), jnp.asarray(val), n, op="max")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fused_plan_and_design_rule():
    # S2 on the H100: 2^22 indices in 256 slabs of 16384, about two per SM
    assert fused_plan(1 << 25, 1 << 22, 132) == (14, 256, 1 << 18)
    # at most 2048 slabs of 32768: the two-pass design's domain
    assert fused_plan(1 << 25, TWO_PASS_MAX_INDICES, 132)[:2] == (15, TWO_PASS_MAX_SLABS)
    assert fused_design(1 << 25, 1 << 22) == "two-pass"
    assert fused_design(1 << 21, 1 << 18) == "single-sweep"  # fig5's S1 graphs
    assert fused_design(1 << 25, TWO_PASS_MAX_INDICES + 1) == "single-sweep"

"""The index arithmetic of the one-pass kernels, emulated in numpy on the CPU.

``csrc/positions.cu`` (onesweep design), the two-pass design of
``csrc/fused.cu``, the onesweep design of ``csrc/cobra_pass.cu`` and
``csrc/histogram.cu`` run only on the card. This file re-enacts what their
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
  they touched);
- the COBRA pass, onesweep design: the 13-bit bin field of the rank
  register, the 16-bit per-warp counter rows, each tuple's staged slot
  (tile-local bin start + warp offset + rank), the staged tile laid over
  the counter rows, the run of each bin and its destination from the
  look-back; at the kernel's own tile (16 warps x 32 x 16 = 8192 tuples)
  and at a small one that needs many tiles;
- the histogram: 16-byte vectors after a scalar head, lane-private copies
  at an odd stride, one atomic of 32 for a warp of equal keys, and the
  merge of the copies.

Streams: uniform, one key, a hub (half of the stream to one index), all
out of range, and whole tiles with no key in range (the histogram also
the embedding gradient's 13-bin zipf ids). Positions, the COBRA pass and
the histogram must equal the Pallas kernel bit for bit; the fused result is exact for int32 and
min/max, and a float32 add is held to atol 1e-4, the reference's own
tolerance in ``tests/test_fused.py`` (the Pallas kernel sums in flush
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.binning import cobra_binning_pass_pallas, counting_positions_pallas
from repro.kernels.fused import cobra_bin_accumulate_pallas
from repro.kernels.histogram import histogram_pallas
from repro_torch.core.pb import reduce_identity
from repro_torch.kernels import ref as tref
from repro_torch.kernels.binning import (
    COBRA_MAX_BINS, COBRA_ONESWEEP_MAX_BINS, ONESWEEP_MAX_BINS, cobra_pass_design,
    positions_design)
from repro_torch.kernels.fused import (
    CHUNK_MIN, SLAB_MAX, TWO_PASS_MAX_INDICES, TWO_PASS_MAX_SLABS, fused_design, fused_plan)

BIN_BITS = 13  # csrc/pb_onesweep.cuh: kBinBits
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
    # bin and in-warp rank share one register: 13 bits of bin, the rank above
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


# -- the COBRA pass, onesweep design ---------------------------------------------

OS_WARPS, OS_ITEMS = 16, 16  # csrc/pb_onesweep.cuh kWarps, csrc/cobra_pass.cu kOsItems
OS_TILE = OS_WARPS * 32 * OS_ITEMS  # 8192 tuples
SLOT_BITS = 16  # csrc/cobra_pass.cu kSlotBits
SMEM_MAX = 232_448  # bytes of shared memory a block may opt into on sm_90


def _popc(x):
    return np.bitwise_count(np.asarray(x, np.uint32)).astype(np.int64)


def _rank_warps(k, num_bins):
    """rank_warp over every warp of a tile at once: ``k`` (warps, items, 32)
    holds bins (NO_BIN out of range) in stream order. Returns each key's
    rank among its warp's earlier keys of its bin, and the warps' 16-bit
    counter rows."""
    warps, items, _ = k.shape
    nbits = int(num_bins).bit_length()
    lane_bit = np.int64(1) << np.arange(32, dtype=np.int64)
    lt = lane_bit - 1
    rows = np.zeros((warps, num_bins), np.uint16)
    rank = np.zeros(k.shape, np.int64)
    w = np.repeat(np.arange(warps), 32).reshape(warps, 32)
    for j in range(items):
        kj = k[:, j, :]
        peers = np.full((warps, 32), 0xFFFFFFFF, np.int64)
        for i in range(nbits):
            bit = (kj >> i) & 1
            ballot = (bit * lane_bit).sum(axis=1)[:, None]
            peers &= np.where(bit == 1, ballot, ~ballot & 0xFFFFFFFF)
        ok = kj < num_bins
        kk = np.minimum(kj, num_bins - 1)
        before = np.where(ok, rows[w, kk].astype(np.int64), 0)
        rank[:, j, :] = before + _popc(peers & lt)
        writer = ok & ((peers & lt) == 0)
        total = before + _popc(peers)
        assert total.max() < 2**16  # a warp's count fits its 16-bit counter
        rows[w[writer], kj[writer]] = total[writer]
    return rank, rows


def cobra_onesweep(keys, idx, val, starts, num_bins, warps=OS_WARPS, items=OS_ITEMS, seed=0):
    """csrc/cobra_pass.cu, onesweep design, at a tile of warps x 32 x items
    tuples. Returns the binned (idx, val) and, per tile, its runs
    (bin, destination, length)."""
    m = len(keys)
    T = warps * 32 * items
    tiles = -(-m // T)
    rng = np.random.default_rng(seed)
    status = _Status(tiles, num_bins)
    out_idx = np.full(m, -7, idx.dtype)
    out_val = np.zeros(m, val.dtype)
    runs = []
    for tile in range(tiles):
        i = tile * T + np.arange(T)  # item j of lane l in warp w: w * 32 * items + 32 j + l
        inn = i < m
        k = np.where(inn, keys[np.minimum(i, m - 1)], -1)
        b = np.where((k >= 0) & (k < num_bins), k, NO_BIN).reshape(warps, items, 32)
        rank, rows = _rank_warps(b, num_bins)
        packed = b | (rank << BIN_BITS)  # rank_warp's register
        assert packed.max() < 2**31 and np.array_equal(packed & NO_BIN, b)
        # scan_warps: each warp's exclusive offset per bin, in its 16-bit
        # row; block_exclusive_scan: the tile-local bin starts
        cnt = rows.astype(np.int64)
        tot = cnt.sum(axis=0)
        first = np.cumsum(tot) - tot
        staged = int(tot.sum())
        cnt = np.cumsum(cnt, axis=0) - cnt
        assert cnt.max() < 2**16
        cnt = cnt.astype(np.uint16)
        # each key's staged slot (bin start + warp offset + rank), packed with its bin
        bb = packed & NO_BIN
        ok = bb < num_bins
        wi = np.arange(warps)[:, None, None]
        kk = np.minimum(bb, num_bins - 1)
        slot = first[kk] + cnt[wi, kk].astype(np.int64) + (packed >> BIN_BITS)
        packed = np.where(ok, slot | (bb << SLOT_BITS), -1).ravel()
        # the staged tile (over the counter rows): every slot in [0, staged) once
        okf = packed >= 0
        s = packed[okf] & ((1 << SLOT_BITS) - 1)
        assert np.array_equal(np.sort(s), np.arange(staged))
        st_idx = np.empty(staged, idx.dtype)
        st_val = np.empty(staged, val.dtype)
        st_bin = np.empty(staged, np.int64)
        src = i[okf]
        st_idx[s], st_val[s], st_bin[s] = idx[src], val[src], packed[okf] >> SLOT_BITS
        # bin by bin in the staged tile, in stream order within a bin
        assert np.all(np.diff(st_bin) >= 0)
        pre = _look_back(status, tile, tot, starts.astype(np.int64), rng)
        delta = pre - first  # s_tot after the look-back
        d = delta[st_bin] + np.arange(staged)
        out_idx[d] = st_idx
        out_val[d] = st_val
        runs += [(bin_, int(pre[bin_]), int(tot[bin_])) for bin_ in np.flatnonzero(tot)]
    return out_idx, out_val, runs


def _cobra_keys(kind, m, num_bins, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num_bins, m)
    if kind == "one-key":
        keys[:] = num_bins // 2
    elif kind == "hub":
        keys[rng.random(m) < 0.5] = num_bins // 3
    return keys.astype(np.int32)


def _cobra_check(kind, m, num_bins, **tile):
    keys = _cobra_keys(kind, m, num_bins, m + num_bins)
    rng = np.random.default_rng(num_bins)
    idx = rng.integers(0, 1 << 30, m).astype(np.int32)
    val = rng.integers(-(1 << 30), 1 << 30, m).astype(np.int32)
    counts = np.bincount(keys, minlength=num_bins)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    got_i, got_v, runs = cobra_onesweep(keys, idx, val, starts, num_bins, **tile)
    want_i, want_v = cobra_binning_pass_pallas(jnp.asarray(keys), jnp.asarray(idx),
                                               jnp.asarray(val), jnp.asarray(starts),
                                               num_bins=num_bins)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    # float32 values are copied as bits: the port's plain version
    fval = rng.normal(size=m).astype(np.float32)
    got_i, got_f, _ = cobra_onesweep(keys, idx, fval, starts, num_bins, **tile)
    ti, tf = tref.binned_stream_ref(torch.from_numpy(keys), torch.from_numpy(idx),
                                    torch.from_numpy(fval), num_bins)
    np.testing.assert_array_equal(got_i, ti.numpy())
    np.testing.assert_array_equal(got_f.view(np.int32), tf.numpy().view(np.int32))
    # one run per bin per tile, laid end to end in each bin's region
    for b in range(num_bins):
        mine = [(d, n) for bin_, d, n in runs if bin_ == b]
        assert sum(n for _, n in mine) == counts[b]
        assert [d for d, _ in mine] == list(starts[b] + np.cumsum([0] + [n for _, n in mine])[:-1])
    return runs


@pytest.mark.parametrize("kind", ["uniform", "one-key", "hub"])
@pytest.mark.parametrize("num_bins", [1, 289, 735, 2203, 4096])
@pytest.mark.parametrize("m", [OS_TILE - 1, OS_TILE, OS_TILE + 1])
def test_cobra_onesweep_arithmetic_matches_pallas(kind, num_bins, m):
    """At the kernel's tile: S2's (289) and S3's (735, 2203) pass widths and
    the largest pass ops.cobra_binning makes (4096)."""
    runs = _cobra_check(kind, m, num_bins)
    assert len({d for _, d, _ in runs}) <= -(-m // OS_TILE) * num_bins


@pytest.mark.parametrize("kind", ["uniform", "one-key", "hub"])
@pytest.mark.parametrize("num_bins", [1, 13, 300])
def test_cobra_onesweep_over_many_tiles(kind, num_bins):
    """Tiles of 2 x 32 x 3 tuples: 14 tiles, so the look-back walks past
    predecessors that show only their aggregate, window by window."""
    _cobra_check(kind, 2600, num_bins, warps=2, items=3)


def test_cobra_pass_design_switch():
    assert cobra_pass_design(COBRA_ONESWEEP_MAX_BINS) == "onesweep"
    assert cobra_pass_design(COBRA_ONESWEEP_MAX_BINS + 1) == "three-phase"
    assert cobra_pass_design(COBRA_MAX_BINS) == "three-phase"
    # every pass ops.cobra_binning may make (max_bins_per_pass = 4096)
    assert COBRA_ONESWEEP_MAX_BINS >= 4096 and COBRA_ONESWEEP_MAX_BINS < NO_BIN
    # rank register: a warp's rank (< 32 x items) above the 13-bit bin
    assert (32 * OS_ITEMS - 1) << BIN_BITS | NO_BIN < 2**31
    # slot register: a staged slot (< the tile) below the bin
    assert OS_TILE <= 1 << SLOT_BITS and (COBRA_ONESWEEP_MAX_BINS - 1) << SLOT_BITS < 2**31
    # shared memory at 4096 bins: the C-Buffers (16-bit counter rows, or the
    # staged idx, val and 16-bit bin laid over them) and two int32 per bin
    B = COBRA_ONESWEEP_MAX_BINS
    cbuf = max(OS_WARPS * B * 2, OS_TILE * (4 + 4 + 2))
    assert cbuf + 2 * 4 * B <= SMEM_MAX
    assert OS_WARPS * B * 4 + OS_TILE * 10 + 8 * B > SMEM_MAX  # why the rows are 16-bit


# -- the histogram -------------------------------------------------------------------

HIST_THREADS, HIST_VEC = 256, 4  # csrc/histogram.cu kThreads, kVec
HIST_SMEM = 48 * 1024  # csrc/histogram.cu kSmemBytes
HIST_SMEM_BINS = HIST_SMEM // 4


def _copies_for(num_bins):
    """copies_for: the most lane-private copies (a power of two, at most 32)
    that fit HIST_SMEM at an odd stride."""
    n, stride = 32, num_bins | 1
    while n > 1 and n * stride * 4 > HIST_SMEM:
        n >>= 1
    return (n, stride) if n > 1 else (1, num_bins)


def histogram_emulated(keys, num_bins, blocks, offset):
    """csrc/histogram.cu with ``blocks`` blocks, for keys that begin
    ``offset`` int32 past a 16-byte boundary. Returns the counts, the
    number of atomics, and how many of those came from the scalar head and
    tail and from warps that hold lanes past the end."""
    m = len(keys)
    shared = num_bins <= HIST_SMEM_BINS
    copies, stride = _copies_for(num_bins) if shared else (1, 0)
    head = min(m, (4 - offset) % 4)
    nvec = (m - head) // 4
    tail = head + 4 * nvec
    counts = np.zeros(num_bins, np.int64)
    atomics = ragged = 0
    lanes = np.arange(32)
    for blk in range(blocks):
        h = np.zeros(max(copies * stride, 1), np.int64)
        tgt = h if shared else counts  # the global path adds to the counts

        def mine(lane, k):
            return (lane % copies) * stride + k if shared else k

        if blk == 0:  # the scalar head and tail: threads 0-3 and 4-7
            for t in range(8):
                i = t if t < 4 else tail + t - 4
                if i < (head if t < 4 else m) and 0 <= keys[i] < num_bins:
                    tgt[mine(t, keys[i])] += 1
                    atomics += 1
                    ragged += 1
        step = blocks * HIST_THREADS * HIST_VEC
        for base in range(blk * HIST_THREADS * HIST_VEC, nvec, step):
            for j in range(HIST_VEC):
                v = base + j * HIST_THREADS + np.arange(HIST_THREADS)
                x = np.full((HIST_THREADS, 4), -1, np.int64)
                live = v < nvec
                x[live] = keys[head + 4 * v[live, None] + np.arange(4)]
                for c in range(4):
                    warps = zip(x[:, c].reshape(-1, 32), live.reshape(-1, 32))
                    for wk, wlive in warps:
                        if (wk == wk[0]).all():  # one atomic of 32 on copy 0
                            if 0 <= wk[0] < num_bins:
                                tgt[wk[0]] += 32
                                atomics += 1
                            continue
                        ok = (wk >= 0) & (wk < num_bins)
                        addr = mine(lanes[ok], wk[ok])
                        # lane-private copies: no two lanes of a warp on one address
                        assert copies < 32 or len(np.unique(addr)) == len(addr)
                        np.add.at(tgt, addr, 1)
                        atomics += int(ok.sum())
                        ragged += int(ok.sum()) if not wlive.all() else 0
        if shared:  # merge the copies, one global atomic per non-zero bin
            counts += h[:copies * stride].reshape(copies, stride)[:, :num_bins].sum(axis=0)
    return counts, atomics, ragged


def _hist_keys(kind, m, num_bins, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num_bins, m)
    if kind == "one-key":
        keys[:] = num_bins - 1
    elif kind == "hub":
        keys[rng.random(m) < 0.5] = num_bins // 3
    elif kind == "zipf":  # benchmarks/embed_grad.py's ids at bin_range 4096: 13 bins
        keys = np.minimum((rng.pareto(1.2, m) * 50).astype(np.int64), 50_303) // 4096
    elif kind == "outside":  # negatives and keys at or above num_bins
        keys = rng.integers(-num_bins - 3, 2 * num_bins + 3, m)
    return keys.astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "one-key", "hub", "zipf", "outside"])
@pytest.mark.parametrize("num_bins", [1, 13, 512, 2203])
@pytest.mark.parametrize("offset", [0, 3])
def test_histogram_arithmetic_matches_pallas(kind, num_bins, offset):
    m = 9000 + offset  # 3 blocks, a grid-stride trip past the first, a ragged tail
    keys = _hist_keys(kind, m, num_bins, num_bins + offset)
    got, atomics, ragged = histogram_emulated(keys, num_bins, blocks=3, offset=offset)
    want = histogram_pallas(jnp.asarray(keys), num_bins)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, tref.histogram_ref(torch.from_numpy(keys), num_bins).numpy())
    if kind == "one-key":  # every whole warp of equal keys made one atomic
        assert atomics - ragged == (m - ragged) // 32


def test_histogram_copies_and_global_path():
    assert _copies_for(1) == (32, 1)
    assert _copies_for(13) == (32, 13)  # the embedding stream: a copy per lane
    assert _copies_for(512) == (16, 513)  # S2
    assert _copies_for(735) == (16, 735) and _copies_for(2203) == (4, 2203)  # S3's levels
    assert _copies_for(HIST_SMEM_BINS) == (1, HIST_SMEM_BINS)
    for B in (1, 13, 512, 735, 2203):
        n, stride = _copies_for(B)
        assert stride % 2 == 1 and n * stride * 4 <= HIST_SMEM
        # one bin's copies sit in distinct banks
        assert len({(q * stride + B - 1) % 32 for q in range(n)}) == n
    # above the shared copies: straight to the global counts
    keys = _hist_keys("hub", 5000, HIST_SMEM_BINS + 1, 1)
    got, _, _ = histogram_emulated(keys, HIST_SMEM_BINS + 1, blocks=2, offset=1)
    np.testing.assert_array_equal(
        got, tref.histogram_ref(torch.from_numpy(keys), HIST_SMEM_BINS + 1).numpy())

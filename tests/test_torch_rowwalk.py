"""The index arithmetic of Bin-Read and the narrow row walk, emulated in numpy.

``csrc/binread.cu`` (tile-sorted runs) and the narrow walk of
``csrc/pb_rows.cuh`` (``rows_seg_kernel``) run only on the card. This file
re-enacts what their blocks and warps compute, step by step, and holds the
result against the Pallas kernels in interpret mode (as
``tests/test_kernels.py`` and ``tests/test_fused.py`` run them) and the
plain versions:

- Bin-Read: a block's tile of positions of one bin row and its slice of
  32 x VEC columns; each thread's items, four consecutive positions a
  load; the end of a tile that holds only padding; the counting sort by
  local index (ranks from the counters' atomics, in any arrival order,
  and the block scan of the counters: per-thread sums, warp scans, warp
  totals); the sorted list from the front and the side list from the
  back; the walk of 32 entries a warp, kBrUnroll rows gathered before
  they are folded; one reduction per run per VEC columns. At the kernel's
  own tile (512 threads x 8 = 4096 positions) and at a small one that
  needs many tiles; VEC 4 and, where d % 4 != 0, 1.
- The narrow row walk: the lane packing (lanes per row and each lane's
  columns, as ``launch_rows`` picks them), the chunk of steps a warp
  takes (two waves of resident warps), the segmented inclusive scan by
  index over a step's row slots (the run's first slot from a ballot of
  run heads, then shifts 1, 2, 4, ...), the apply at a run's last slot,
  and the run carried from one step to the next and flushed at the end
  of a chunk; for add, min and max.

Tolerances: int32 results and every min/max result are exact; a float32
add within 1e-5 of the magnitudes summed at an entry plus 1e-6 (the
kernels add in another order than the Pallas kernels' one-hot matmul or
flush order). The Pallas Bin-Read drops an index outside its own bin's
range and the plain oracle adds it (ROADMAP Queue 3): the side path is
held to ``repro.kernels.ref.binread_scatter_add_ref``. The Pallas rows
kernel mis-files -1 in an unsorted stream (ROADMAP Queue 3): streams
with negative indices are held to the port's plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.binread import binread_scatter_add_pallas
from repro.kernels.fused import cobra_bin_accumulate_rows_pallas
from repro_torch.core.pb import reduce_identity
from repro_torch.kernels import ref as tref

# csrc/binread.cu
BR_THREADS, BR_TILE, BR_MAX_RANGE, BR_UNROLL = 512, 4096, 4096, 4
DROPPED, SIDE = -1, -2
# csrc/pb_rows.cuh
SEG_MAX_LPR, SEG_MAX_STEPS, H100_SMS = 4, 64, 132


def _rng(seed):
    return np.random.default_rng(seed)


def _add_close(got, want, scale):
    return bool((np.abs(got - want) <= 1e-5 * scale + 1e-6).all())


# -- Bin-Read -----------------------------------------------------------------


def _tile_items(tile, threads):
    """Each thread's positions in its tile: (q * threads + t) * 4 + e."""
    items = tile // threads
    return np.array([[(q * threads + t) * 4 + e for q in range(items // 4) for e in range(4)]
                     for t in range(threads)])


def _block_scan(counts, threads):
    """Exclusive starts of the counters as the kernel's scan forms them."""
    R = counts.shape[0]
    per = -(-R // threads)
    sums = np.array([counts[t * per:min((t + 1) * per, R)].sum() if t * per < R else 0
                     for t in range(threads)])
    incl = np.concatenate([np.cumsum(w) for w in sums.reshape(-1, 32)])  # warp scans
    totals = incl.reshape(-1, 32)[:, -1]
    before = np.concatenate([[0], np.cumsum(totals)[:-1]])
    starts = np.zeros(R, np.int64)
    for t in range(threads):
        run = incl[t] - sums[t] + before[t // 32]
        for c in range(t * per, min((t + 1) * per, R)):
            starts[c] = run
            run += counts[c]
    return starts, int(np.cumsum(totals)[-1])


def binread_model(idx, val, R, *, tile=BR_TILE, threads=BR_THREADS, vec=None, seed=0):
    """out[(B*R, d)] as binread_kernel's blocks form it, in float32, and
    what it counted: reductions, side rows, tiles that ended early."""
    B, L = idx.shape
    d = val.shape[2]
    vec = vec or (4 if d % 4 == 0 else 1)
    tiles, slices = -(-L // tile), -(-d // (32 * vec))
    total, sortable = B * R, R <= BR_MAX_RANGE
    out = np.zeros((B * R, d), np.float32)
    stats = {"reductions": 0, "side": 0, "empty_tiles": 0}
    positions = _tile_items(tile, threads)
    assert np.array_equal(np.sort(positions.ravel()), np.arange(tile))  # a tile, each once
    arrival = _rng(seed)
    for b in range(B):
        for t in range(tiles):
            t0 = t * tile
            length = min(tile, L - t0)
            for s in range(slices):
                k = np.where(positions < length, idx[b, t0 + np.minimum(positions, length - 1)], -1)
                local = k.astype(np.int64) - b * R
                key = np.where((k < 0) | (k >= total), DROPPED,
                               np.where(sortable & (local >= 0) & (local < R), local, SIDE))
                if not (key != DROPPED).any():
                    stats["empty_tiles"] += 1
                    continue
                lst = np.full(tile, -1, np.int64)
                flat_key, flat_pos = key.ravel(), positions.ravel()
                n = 0
                if sortable:
                    counts = np.zeros(R, np.int64)
                    rank = np.zeros(flat_key.shape[0], np.int64)
                    for i in arrival.permutation(flat_key.shape[0]):  # atomics land in any order
                        if flat_key[i] >= 0:
                            rank[i] = counts[flat_key[i]]
                            counts[flat_key[i]] += 1
                    starts, n = _block_scan(counts, threads)
                    for i in np.flatnonzero(flat_key >= 0):
                        lst[starts[flat_key[i]] + rank[i]] = (flat_key[i] << 16) | flat_pos[i]
                    assert np.all(np.diff(lst[:n] >> 16) >= 0)  # sorted by local index
                side = [p for p in flat_pos[flat_key == SIDE]]
                lst[tile - len(side):] = side[::-1]
                assert n + len(side) <= tile  # the two ends never meet
                cols = slice(s * 32 * vec, min((s + 1) * 32 * vec, d))
                for c in range(0, n, 32):  # a warp takes 32 entries at a time
                    ent = lst[c:min(c + 32, n)]
                    cur, acc = -1, None
                    for j0 in range(0, ent.shape[0], BR_UNROLL):
                        rows = [(e >> 16, val[b, t0 + (e & 0xFFFF), cols]) for e in ent[j0:j0 + BR_UNROLL]]
                        for kk, v in rows:
                            if kk == cur:
                                acc = acc + v
                            else:
                                if cur >= 0:
                                    out[b * R + cur, cols] += acc
                                    stats["reductions"] += -(-acc.shape[0] // vec)
                                cur, acc = kk, v.astype(np.float32)
                    if cur >= 0:
                        out[b * R + cur, cols] += acc
                        stats["reductions"] += -(-acc.shape[0] // vec)
                for p in side:
                    g = idx[b, t0 + p]
                    out[g, cols] += val[b, t0 + p, cols]
                    stats["side"] += 1
    return out, stats


def _binread_layout(case, B, L, R, d, seed):
    rng = _rng(seed)
    idx = np.stack([rng.integers(b * R, (b + 1) * R, L) for b in range(B)]).astype(np.int64)
    hit = rng.random(idx.shape)
    if case == "mid-row-padding":
        idx[hit < 0.4] = -1
    elif case == "all-padding":
        idx[1::2] = -1
    elif case == "one-index":  # one index over a whole bin row: runs across tiles
        idx[0] = 2
    elif case == "out-of-bin":
        idx[hit < 0.2] = rng.integers(0, B * R, int((hit < 0.2).sum()))
    elif case == "out-of-range":
        idx[hit < 0.3] = rng.choice([-1, -9, B * R, B * R + 3], int((hit < 0.3).sum()))
    idx[:, -3:] = -1
    return idx.astype(np.int32), rng.normal(size=(B, L, d)).astype(np.float32)


def _pallas_binread(idx, val, R):
    return np.asarray(binread_scatter_add_pallas(jnp.asarray(idx), jnp.asarray(val),
                                                 bin_range=R, interpret=True))


def _binread_scale(idx, val, R):
    out = np.zeros((idx.shape[0] * R, val.shape[2]))
    for k, v in zip(idx.ravel(), np.abs(val).reshape(-1, val.shape[2]).astype(np.float64)):
        if 0 <= k < out.shape[0]:
            out[k] += v
    return out


@pytest.mark.parametrize("case", ["uniform", "mid-row-padding", "all-padding", "one-index"])
@pytest.mark.parametrize("L,tile,threads", [(255, 256, 64), (256, 256, 64), (257, 256, 64),
                                            (3 * 256 + 5, 256, 64), (9000, BR_TILE, BR_THREADS)])
@pytest.mark.parametrize("d", [8, 3])
def test_binread_tiles_match_pallas(case, L, tile, threads, d):
    """Tile bounds (L one below, at and past a tile; several tiles), padding
    in mid-row, bins of padding only, one index over a whole bin row; VEC
    4 at d = 8 and scalar columns at d = 3 (d % 4 != 0)."""
    B, R = 3, 64
    idx, val = _binread_layout(case, B, L, R, d, seed=L + d)
    got, stats = binread_model(idx, val, R, tile=tile, threads=threads)
    want = _pallas_binread(idx, val, R)
    assert _add_close(got, want, _binread_scale(idx, val, R))
    assert stats["side"] == 0
    if case == "all-padding":
        assert stats["empty_tiles"] >= -(-L // tile) * (-(-d // (32 * (4 if d % 4 == 0 else 1))))
        assert not got[R:2 * R].any()


@pytest.mark.parametrize("case", ["out-of-bin", "out-of-range"])
@pytest.mark.parametrize("R", [64, BR_MAX_RANGE + 1])
def test_binread_side_path_matches_the_oracle(case, R):
    """An in-range index outside its bin, and every index once R is past
    the sort's key range, goes through the side path at its global row
    (the oracle's rule); indices < -1 and >= B * R are dropped."""
    B, L, d = 3, 700, 4
    idx, val = _binread_layout(case, B, L, R, d, seed=R)
    got, stats = binread_model(idx, val, R, tile=256, threads=64)
    want = np.asarray(rref.binread_scatter_add_ref(jnp.asarray(idx), jnp.asarray(val), R))
    assert _add_close(got, want, _binread_scale(idx, val, R))
    if R > BR_MAX_RANGE or case == "out-of-bin":
        assert stats["side"] > 0
    if R > BR_MAX_RANGE:
        assert stats["reductions"] == 0
    if case == "out-of-range" and R <= BR_MAX_RANGE:  # in-bin layout: Pallas agrees
        assert _add_close(got, _pallas_binread(idx, val, R), _binread_scale(idx, val, R))


def test_binread_sort_is_independent_of_atomic_order():
    """Ranks come from shared-memory atomics that land in any order: every
    order gives the same sorted keys and the same sums."""
    idx, val = _binread_layout("uniform", 2, 600, 32, 4, seed=5)
    a, sa = binread_model(idx, val, 32, tile=256, threads=64, seed=1)
    b, sb = binread_model(idx, val, 32, tile=256, threads=64, seed=2)
    assert _add_close(a, b, _binread_scale(idx, val, 32)) and sa == sb


def test_binread_runs_cut_the_reductions():
    """The embedding gradient's zipf ids at the kernel's tile: the runs of
    a 4096-position tile need a small share of the row-by-row walk's
    reductions (one per 4 columns per run instead of one per column per
    row)."""
    rng = _rng(0)
    ids = np.minimum((rng.pareto(1.2, 16384) * 50).astype(np.int64), 4095)
    idx = ids.astype(np.int32)[None, :]
    val = rng.normal(size=(1, ids.shape[0], 8)).astype(np.float32)
    got, stats = binread_model(idx, val, 4096)
    assert _add_close(got, _pallas_binread(idx, val, 4096), _binread_scale(idx, val, 4096))
    per_row = ids.shape[0] * 8  # one scalar reduction per column per row
    assert stats["reductions"] < 0.1 * per_row


# -- the narrow row walk ------------------------------------------------------


def lanes_per_row(F, aligned=True):
    """launch_rows: VEC 4 where F % 4 == 0 (and the rows are aligned), lanes
    per row the next power of two of the row's VEC-column groups."""
    vec = 4 if F % 4 == 0 and aligned else 1
    cols = F // vec
    lpr = 1
    while lpr < cols and lpr < 32:
        lpr <<= 1
    return lpr, vec


def seg_steps(m, lpr, sms=H100_SMS):
    """launch_seg: steps of a warp's chunk, two waves of 64 warps an SM."""
    G = 32 // lpr
    steps = m // (G * 2 * 64 * sms)
    return max(1, min(SEG_MAX_STEPS, steps))


def _combine(op, a, b):
    return a + b if op == "add" else np.minimum(a, b) if op == "min" else np.maximum(a, b)


def seg_walk_model(idx, val, num_out, op, *, steps=None, aligned=True):
    """The dense (num_out, F) result of rows_seg_kernel's warps, and the
    applies it issued."""
    m, F = val.shape
    lpr, vec = lanes_per_row(F, aligned)
    assert lpr <= SEG_MAX_LPR
    G = 32 // lpr
    # lane packing: lane l holds slot l // lpr and columns (l % lpr) * vec ..
    cover = np.zeros((G, F), np.int64)
    for lane in range(32):
        c0 = (lane % lpr) * vec
        if c0 < F:
            cover[lane // lpr, c0:c0 + vec] += 1
    assert (cover == 1).all()  # each column of each slot, once
    steps = steps or seg_steps(m, lpr)
    out = np.full((num_out, F), reduce_identity(op, torch.from_numpy(val).dtype), val.dtype)
    applies = 0

    def apply(k, v):
        nonlocal applies
        out[k] = _combine(op, out[k], v)
        applies += 1

    for r0 in range(0, m, steps * G):
        end = min(r0 + steps * G, m)
        carry, cacc = -1, None
        for base in range(r0, end, G):
            rows = base + np.arange(G)
            keys = np.full(G, -1, np.int64)
            v = np.zeros((G, F), val.dtype)
            inside = rows < end
            keys[inside] = idx[rows[inside]]
            keys[(keys < 0) | (keys >= num_out)] = -1
            ok = keys >= 0
            v[ok] = val[rows[ok]]
            heads = [s for s in range(G) if s == 0 or keys[s - 1] != keys[s]]
            first = np.array([max(h for h in heads if h <= s) for s in range(G)])
            o = 1
            while o < G:  # Hillis-Steele, within each run
                up = v.copy()
                for s in range(G):
                    if s - o >= first[s]:
                        up[s] = _combine(op, v[s - o], v[s])
                v, o = up, o * 2
            if carry >= 0:
                if carry == keys[0]:
                    v[first == 0] = _combine(op, cacc, v[first == 0])
                else:
                    apply(carry, cacc)
            for s in range(G - 1):
                if keys[s + 1] != keys[s] and keys[s] >= 0:
                    apply(keys[s], v[s])
            carry, cacc = keys[G - 1], v[G - 1].copy()
        if carry >= 0:
            apply(carry, cacc)
    return out, applies


def _row_stream(order, n, m, F, dtype, seed, negatives):
    rng = _rng(seed)
    if order == "one-destination":
        idx = np.full(m, n // 3, np.int64)
    elif order == "runs":
        idx = np.repeat(rng.integers(0, n, m), rng.integers(1, 90, m))[:m]
    else:
        idx = rng.integers(0, n, m)
        if order == "sorted":
            idx.sort()
    bad = rng.random(m) < 0.05
    idx[bad] = rng.choice([-1, -4, n, n + 9] if negatives else [n, n + 9], int(bad.sum()))
    val = rng.integers(-50, 50, (m, F)).astype(np.int32) if dtype == np.int32 else \
        rng.normal(size=(m, F)).astype(np.float32)
    return idx.astype(np.int32), val


def _check_rows(got, want, idx, val, n, op):
    if val.dtype == np.int32 or op != "add":
        np.testing.assert_array_equal(got, want)
    else:
        scale = tref.scatter_reduce_ref(torch.from_numpy(idx), torch.from_numpy(np.abs(val)),
                                        n, "add").numpy()
        assert _add_close(got, want, scale)


@pytest.mark.parametrize("F", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("order", ["sorted", "random", "runs", "one-destination"])
def test_seg_walk_matches_pallas(F, op, dtype, order):
    """The segmented scan for add, min and max over lpr-packed slots, on
    sorted, unsorted, long-run and one-destination streams, with indices
    >= n dropped (chunks of 2 steps: runs carried across steps and across
    chunks)."""
    n, m = 97, 1000
    idx, val = _row_stream(order, n, m, F, dtype, seed=F, negatives=False)
    got, _ = seg_walk_model(idx, val, n, op, steps=2)
    want = np.asarray(cobra_bin_accumulate_rows_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=n, bin_range=32, num_bins=4, op=op,
        block=256, cap=512, interpret=True))
    _check_rows(got, want, idx, val, n, op)


@pytest.mark.parametrize("steps", [1, 3, 64])
@pytest.mark.parametrize("op", ["add", "max"])
def test_seg_walk_negative_indices_and_chunks(steps, op):
    """Every negative index is dropped (held to the port's plain version:
    the Pallas kernel drops only -1); m not a multiple of 32 and chunks of
    1, 3 and 64 steps."""
    n, m, F = 50, 2011, 2
    idx, val = _row_stream("runs", n, m, F, np.float32, seed=steps, negatives=True)
    got, _ = seg_walk_model(idx, val, n, op, steps=steps)
    want = tref.scatter_reduce_ref(torch.from_numpy(idx), torch.from_numpy(val), n, op).numpy()
    _check_rows(got, want, idx, val, n, op)


def test_seg_walk_drops_minus_one_where_the_pallas_rows_kernel_does_not():
    """-1 in an unsorted stream: the walk drops it, as the plain version
    does; the Pallas rows kernel's result differs at the last index
    (ROADMAP Queue 3). With the same rows at an index >= n instead, the
    three agree."""
    n, m = 97, 1000
    rng = _rng(1)
    idx = rng.integers(0, n, m)
    bad = rng.random(m) < 0.05
    idx[bad] = rng.choice([-1, n, n + 9], int(bad.sum()))
    idx = idx.astype(np.int32)
    val = rng.normal(size=(m, 1)).astype(np.float32)

    def pallas(i):
        return np.asarray(cobra_bin_accumulate_rows_pallas(
            jnp.asarray(i), jnp.asarray(val), num_indices=n, bin_range=32, num_bins=4,
            block=256, cap=512, interpret=True))

    got, _ = seg_walk_model(idx, val, n, "add", steps=2)
    plain = tref.scatter_reduce_ref(torch.from_numpy(idx), torch.from_numpy(val), n).numpy()
    _check_rows(got, plain, idx, val, n, "add")
    assert np.abs(pallas(idx) - plain)[-1, 0] > 1e-2
    moved = np.where(idx == -1, n + 20, idx).astype(np.int32)
    _check_rows(got, pallas(moved), moved, val, n, "add")


def test_seg_walk_carry_costs_one_apply_per_chunk_and_run():
    """A destination-sorted stream: one apply per (chunk, run) pair, however
    many steps a run spans."""
    n, m = 40, 32 * 12
    idx = np.sort(_rng(3).integers(0, n, m)).astype(np.int32)
    val = np.ones((m, 1), np.float32)
    steps = 4
    got, applies = seg_walk_model(idx, val, n, "add", steps=steps)
    np.testing.assert_array_equal(got[:, 0], np.bincount(idx, minlength=n))
    chunk = steps * 32
    want = sum(len(np.unique(idx[c:c + chunk])) for c in range(0, m, chunk))
    assert applies == want


def test_lane_packing_and_chunk_sizing():
    """launch_rows's choice: the narrow walk up to F = 16 with 16-byte rows
    (F <= 4 unaligned or F % 4 != 0); F = 31, 32 take the wide walk. At
    fig9's largest S1 stream (m = 2^21, F = 1) a chunk is 3 steps and the
    grid holds at least two waves of resident warps."""
    narrow = {F: lanes_per_row(F) for F in (1, 2, 3, 4, 8, 12, 16, 5, 31, 32)}
    assert {F: lpr for F, (lpr, _) in narrow.items()} == {
        1: 1, 2: 2, 3: 4, 4: 1, 8: 2, 12: 4, 16: 4, 5: 8, 31: 32, 32: 8}
    assert lanes_per_row(4, aligned=False) == (4, 1)
    m = 1 << 21
    steps = seg_steps(m, 1)
    assert steps == 3
    warps = -(-m // (32 * steps))
    assert warps >= 2 * 64 * H100_SMS
    assert seg_steps(1000, 4) == 1 and seg_steps(1 << 30, 1) == SEG_MAX_STEPS


# -- the tile walk (wide rows) ---------------------------------------------------

# csrc/pb_rows.cuh
TILE_THREADS, TILE_ITEMS, TILE_BLOCKS_PER_SM = 256, 2, 8
TILE_ROWS, TILE_WARPS = TILE_THREADS * TILE_ITEMS, TILE_THREADS // 32
M32 = 0xFFFFFFFF


def tile_grid(m, F, lpr, vec, sms=H100_SMS):
    """launch_tile: (tiles, slices, column groups, slices a group). The
    slices go to blockIdx.y only where the tiles alone leave the card
    short of TILE_BLOCKS_PER_SM blocks an SM."""
    tiles, slices = -(-m // TILE_ROWS), -(-F // (lpr * vec))
    target = TILE_BLOCKS_PER_SM * sms
    groups, spb = 1, slices
    if tiles < target:
        groups = min(-(-target // tiles), slices)
        spb = -(-slices // groups)
        groups = -(-slices // spb)
    return tiles, slices, groups, spb


def key_bits(num_out):
    """The sort's key bits: enough for num_out itself (a dropped row's key)."""
    bits = 1
    while bits < 31 and num_out >> bits:
        bits += 1
    return bits


def stage_tile(idx_tile, num_out):
    """One block's staged list: keys (a dropped index's key is num_out) and
    tile positions in list order, whether the tile was already ordered,
    the kept count n, and the run heads as the ballots' 32-bit words."""
    k = np.full(TILE_ROWS, num_out, np.int64)
    k[:idx_tile.shape[0]] = np.where((idx_tile >= 0) & (idx_tile < num_out), idx_tile, num_out)
    # each thread's items in order, and its first after the previous thread's last
    items = k.reshape(TILE_THREADS, TILE_ITEMS)
    ordered = bool((np.diff(items, axis=1) >= 0).all() and (items[1:, 0] >= items[:-1, -1]).all())
    assert ordered == bool((np.diff(k) >= 0).all())
    assert k.max() < 1 << key_bits(num_out)  # the sort's bits hold every key
    pos = np.arange(TILE_ROWS) if ordered else np.argsort(k, kind="stable")
    keys = k[pos]
    nxt = np.r_[keys[1:], num_out]
    last = np.flatnonzero((keys != num_out) & (nxt == num_out))
    n = int(last[0]) + 1 if last.size else 0
    assert n == int((k != num_out).sum())
    head = (keys != num_out) & (keys != np.r_[-1, keys[:-1]])
    return keys, pos, ordered, n, ballot_words(head)


def ballot_words(head):
    """The head flags as 32-bit words, slot 32 w + b at bit b of word w."""
    return [int(w) for w in (head.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1)]


def seg_start(words, seg, L, n):
    """The kernel's seg_start, bit for bit: the first run head in the
    window [seg * L, min(n, (seg + 1) * L)), or the window's start."""
    a = seg * L
    if a >= n:
        return n
    if seg == 0:
        return 0
    c = min(a + L, n)
    for w in range(a >> 5, ((c - 1) >> 5) + 1):
        bits = words[w]
        if w == a >> 5:
            bits &= (M32 << (a & 31)) & M32
        hi = c - 32 * w
        if hi < 32:
            bits &= (1 << hi) - 1
        if bits:
            return 32 * w + (bits & -bits).bit_length() - 1
    return a


_REDUCEAT = {"add": np.add, "min": np.minimum, "max": np.maximum}


def _bit(words, q):
    return words[q >> 5] >> (q & 31) & 1


def tile_walk_model(idx, val, num_out, op, *, aligned=True, sms=H100_SMS):
    """The dense (num_out, F) result of rows_tile_kernel's blocks, and what
    they counted: vector (float4) and scalar reductions, tiles taken in
    stream order and tiles sorted, runs applied, run pieces passed on."""
    m, F = val.shape
    lpr, vec = lanes_per_row(F, aligned)
    assert lpr > SEG_MAX_LPR  # the tile walk's rows
    tiles, slices, groups, spb = tile_grid(m, F, lpr, vec, sms)
    walkers = TILE_WARPS * (32 // lpr)
    width = lpr * vec
    out = np.full((num_out, F), reduce_identity(op, torch.from_numpy(val).dtype), val.dtype)
    vector = op == "add" and val.dtype == np.float32 and vec == 4
    stats = {"vector": 0, "scalar": 0, "ordered": 0, "sorted": 0, "applies": 0, "pieces": 0}

    def apply(k, cols, s, lanes):
        out[k, cols] = _combine(op, out[k, cols], s)
        stats["applies"] += 1
        stats["vector" if vector else "scalar"] += lanes * (1 if vector else vec)

    for t in range(tiles):
        r0 = t * TILE_ROWS
        keys, pos, ordered, n, words = stage_tile(idx[r0:r0 + TILE_ROWS], num_out)
        if n == 0:  # the block ends after staging
            continue
        stats["ordered" if ordered else "sorted"] += 1
        for g in range(groups):
            s0 = g * spb
            ns = min(spb, slices - s0)
            P = 1 if ns >= walkers else walkers // ns
            assert P == 1 or ns * P <= walkers  # one unit a walker where runs are cut
            L = -(-n // P)
            piece, through, owned = {}, {}, []
            for u in range(ns * P):  # the units the block's walkers take in turn
                sl, seg = s0 + u % ns, u // ns
                lanes = [sl * width + ln * vec for ln in range(lpr) if sl * width + ln * vec < F]
                if not lanes:
                    continue
                b = seg_start(words, seg, L, n)
                e = seg_start(words, seg + 1, L, n) if seg + 1 < P else n
                if b == e:
                    continue
                open_lo = not _bit(words, b)
                open_hi = e < n and not _bit(words, e)
                assert P > 1 or not (open_lo or open_hi)
                cols = slice(lanes[0], lanes[-1] + vec)
                kseg, rows = keys[b:e], val[r0 + pos[b:e], cols]
                starts = np.flatnonzero(np.r_[True, kseg[1:] != kseg[:-1]])
                sums = _REDUCEAT[op].reduceat(rows, starts, axis=0)
                last = starts.shape[0] - 1
                through[u] = False
                for i, (k, s) in enumerate(zip(kseg[starts], sums)):
                    if i == 0 and open_lo:  # the tail of a run begun before: passed on
                        piece[u] = s
                        through[u] = last == 0 and open_hi
                        stats["pieces"] += 1
                    elif i == last and open_hi:  # begun here, goes on: this walker owns it
                        owned.append((u, k, s, cols, len(lanes)))
                    else:
                        apply(k, cols, s, len(lanes))
            for u, k, s, cols, lanes in owned:  # after the block barrier
                w = u + ns
                while True:
                    s = _combine(op, s, piece[w])
                    if not through[w]:
                        break
                    w += ns
                apply(k, cols, s, lanes)
    return out, stats


def _tile_stream(order, n, m, seed, negatives):
    """Indices in five orders: destination-sorted, uniform, zipf token ids,
    one destination and a hub (half of the rows on one destination); with
    ``negatives``, 5% dropped (-1, -4, n, n + 9)."""
    rng = _rng(seed)
    if order == "one-destination":
        idx = np.full(m, n // 3, np.int64)
    elif order == "zipf":
        idx = np.minimum((rng.pareto(1.2, m) * 3).astype(np.int64), n - 1)
    elif order == "hub":
        idx = np.where(rng.random(m) < 0.5, n // 2, rng.integers(0, n, m))
    else:
        idx = rng.integers(0, n, m)
        if order == "sorted":
            idx.sort()
    if negatives:
        bad = rng.random(m) < 0.05
        idx[bad] = rng.choice([-1, -4, n, n + 9], int(bad.sum()))
    return idx.astype(np.int32)


def _tile_values(m, F, dtype, seed):
    rng = _rng(seed)
    if dtype == np.int32:
        return rng.integers(-50, 50, (m, F)).astype(np.int32)
    return rng.normal(size=(m, F)).astype(np.float32)


TILE_F = [17, 20, 32, 33, 64, 128, 1536]
TILE_ORDERS = ["sorted", "random", "zipf", "one-destination", "hub"]


@pytest.mark.parametrize("F", TILE_F)
@pytest.mark.parametrize("order", TILE_ORDERS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_tile_walk_matches_plain(F, order, dtype, op):
    """Two tiles (the second one short), 16-byte lanes (F = 20, 32, 64, 128,
    1536) and scalar ones (17, 33), one slice or many, every order; 5% of
    the indices are -1, -4, n or n + 9 and are dropped."""
    n, m = 97, TILE_ROWS + 77
    idx = _tile_stream(order, n, m, seed=F, negatives=True)
    val = _tile_values(m, F, dtype, seed=F + 1)
    got, stats = tile_walk_model(idx, val, n, op)
    want = tref.scatter_reduce_ref(torch.from_numpy(idx), torch.from_numpy(val), n, op).numpy()
    _check_rows(got, want, idx, val, n, op)
    assert stats["ordered"] + stats["sorted"] == 2
    vec = lanes_per_row(F)[1]
    assert (stats["vector"] > 0) == (op == "add" and dtype == np.float32 and vec == 4)


# one case a row of TILE_F: every F, op, dtype and order held to the Pallas kernel at least once
PALLAS_CASES = [(17, "add", np.float32, "sorted"), (20, "min", np.int32, "random"),
                (32, "max", np.float32, "zipf"), (33, "add", np.int32, "one-destination"),
                (64, "min", np.float32, "hub"), (128, "max", np.int32, "sorted"),
                (1536, "add", np.float32, "random")]


@pytest.mark.parametrize("F,op,dtype,order", PALLAS_CASES)
def test_tile_walk_matches_pallas(F, op, dtype, order):
    """Non-negative streams inside [0, n) against the Pallas rows kernel in
    interpret mode."""
    n, m = 97, TILE_ROWS + 77
    idx = _tile_stream(order, n, m, seed=F + 7, negatives=False)
    val = _tile_values(m, F, dtype, seed=F + 8)
    got, _ = tile_walk_model(idx, val, n, op)
    want = np.asarray(cobra_bin_accumulate_rows_pallas(
        jnp.asarray(idx), jnp.asarray(val), num_indices=n, bin_range=32, num_bins=4, op=op,
        block=512, cap=512, interpret=True))
    _check_rows(got, want, idx, val, n, op)


def test_tile_walk_sorted_stream_costs_one_apply_a_run():
    """A destination-sorted stream stays in stream order, and each tile
    applies each of its runs once (at F = 64, 16 segments of 32 slots a
    tile; runs of about two rows are never cut)."""
    n, m, F = 4000, 4 * TILE_ROWS, 64
    idx = np.sort(_rng(2).integers(0, n, m)).astype(np.int32)
    val = np.ones((m, F), np.float32)
    got, stats = tile_walk_model(idx, val, n, "add")
    np.testing.assert_array_equal(got[:, 0], np.bincount(idx, minlength=n))
    assert stats["ordered"] == 4 and stats["sorted"] == 0
    distinct = sum(len(np.unique(idx[t:t + TILE_ROWS])) for t in range(0, m, TILE_ROWS))
    assert stats["applies"] == distinct and stats["pieces"] == 0
    assert stats["vector"] == distinct * 16  # 16 lanes of 4 columns, one float4 each


def test_tile_walk_sort_combines_repeats():
    """Zipf token ids in token order: each tile is sorted, and its repeated
    ids combine before any reduction (a row-by-row walk would apply once
    per row)."""
    n, m, F = 152_064, 4 * TILE_ROWS, 128
    ids = np.minimum((_rng(4).pareto(1.2, m) * 50).astype(np.int64), n - 1).astype(np.int32)
    val = _tile_values(m, F, np.float32, seed=5)
    got, stats = tile_walk_model(ids, val, n, "add")
    want = tref.scatter_reduce_ref(torch.from_numpy(ids), torch.from_numpy(val), n).numpy()
    _check_rows(got, want, ids, val, n, "add")
    assert stats["sorted"] == 4
    assert stats["applies"] < 0.5 * m * 1  # one slice: fewer than half the rows


@pytest.mark.parametrize("F", [20, 64, 128])
@pytest.mark.parametrize("op", ["add", "max"])
def test_tile_walk_long_runs_meet_in_the_tile(F, op):
    """Runs longer than a segment's window (one destination for a whole
    tile, hubs of 40 to 300 rows): each is cut into pieces over the
    walkers, and the pieces meet at the walker that holds the run's head,
    which applies the run once a tile (a sorted tile's runs are its
    distinct destinations)."""
    n = 50
    rng = _rng(F)
    for idx in (np.full(TILE_ROWS, 3), np.repeat(rng.integers(0, n, 20), rng.integers(40, 300, 20))):
        idx = idx.astype(np.int32)
        m = idx.shape[0]
        val = _tile_values(m, F, np.float32, seed=F)
        got, stats = tile_walk_model(idx, val, n, op)
        want = tref.scatter_reduce_ref(torch.from_numpy(idx), torch.from_numpy(val), n, op).numpy()
        _check_rows(got, want, idx, val, n, op)
        runs = sum(len(np.unique(idx[t:t + TILE_ROWS])) for t in range(0, m, TILE_ROWS))
        assert stats["applies"] == runs * -(-F // (lanes_per_row(F)[0] * lanes_per_row(F)[1]))
        assert stats["pieces"] > 0


def test_seg_start_bits():
    """seg_start's masks against a plain search, windows of every length
    and offset over random heads."""
    rng = _rng(6)
    for trial in range(50):
        head = rng.random(TILE_ROWS) < rng.choice([0.01, 0.1, 0.5])
        n = int(rng.integers(1, TILE_ROWS + 1))
        head[n:] = False
        head[0] = True
        words = ballot_words(head)
        for P in (2, 3, 8, 16, 32, 64):
            L = -(-n // P)
            prev = -1
            for seg in range(P):
                a = seg * L
                hits = np.flatnonzero(head[a:min(a + L, n)])
                want = n if a >= n else 0 if seg == 0 else a + int(hits[0]) if hits.size else a
                got = seg_start(words, seg, L, n)
                assert got == want and got >= prev
                prev = got


def test_tile_walk_grid_at_the_path_shapes():
    """launch_tile's plan at the main path's shapes: S2's F = 64 stream has
    tiles enough for every block to take the whole row; the embedding
    backward (16,384 x 1536), the vlm's (4,096 x 4096), the MoE combine
    (7,776 x 4096 bfloat16) and a vocab-parallel rank (8,192 x 1536) split
    their slices over blockIdx.y, one slice a block; key bits hold
    num_out."""
    assert tile_grid(1 << 25, 64, 16, 4) == (65536, 1, 1, 1)
    assert tile_grid(16_384, 1536, 32, 4) == (32, 12, 12, 1)
    assert tile_grid(4096, 4096, 32, 4) == (8, 32, 32, 1)
    assert tile_grid(7776, 4096, 32, 4) == (16, 32, 32, 1)
    assert tile_grid(8192, 1536, 32, 4) == (16, 12, 12, 1)
    assert tile_grid(5, 65536 * 128 + 4, 32, 4) == (1, 65537, 1041, 63)
    assert key_bits(1 << 22) == 23 and key_bits(152_064) == 18 and key_bits(1) == 1
    assert key_bits(2**31 - 1) == 31


def test_rows_design_names_the_walk():
    """fused.py's rows_design and launch_rows's rule: the narrow walk up to
    four lanes a row, the tile walk above."""
    from repro_torch.kernels.fused import rows_design

    for F in range(1, 70):
        for aligned in (True, False):
            lpr, _ = lanes_per_row(F, aligned)
            assert rows_design(F, aligned) == ("narrow" if lpr <= SEG_MAX_LPR else "tile")
    assert [rows_design(F) for F in (1, 8, 16, 17, 32, 64, 1536)] == [
        "narrow", "narrow", "narrow", "tile", "tile", "tile", "tile"]

// One-pass tile binning with decoupled look-back, shared by positions.cu,
// the two-pass design of fused.cu and the onesweep design of cobra_pass.cu.
//
// A GPU grid runs its blocks in no order, so the per-bin cursors that a
// TPU kernel carries across sequential grid steps have to be rebuilt.
// The three-phase scheme (pb_tiles.cuh) writes a (tiles, bins) count
// matrix, scans it down each column and reads the keys again. This core
// does it in one pass over the keys, after Merrill and Garland's
// single-pass prefix scan ("decoupled look-back", as CUB's Onesweep radix
// sort uses it). For a tile of keys held in registers, a block:
//   1. takes its tile index from an atomic ticket (take_ticket), so a
//      tile only ever waits on tiles whose blocks have already started;
//   2. ranks each key among the earlier keys of its bin in its warp
//      (rank_warp: a ballot per key bit groups equal keys, a per-warp
//      counter row in shared memory carries the warp's running count per
//      bin);
//   3. scans each bin's column of warp counts in warp order
//      (scan_warps) and publishes the tile's per-bin aggregate to a
//      (tiles, bins) status array of 64-bit words {flag, count}
//      (publish_aggregates; tile 0 publishes its inclusive prefix only,
//      so that no walk back passes it);
//   4. looks back (look_back): for each bin, sums the counts of the
//      earlier tiles, walking back until it meets an inclusive prefix;
//      tile 0 starts from the caller's seed (the bin's first destination).
//      It then publishes its own inclusive prefix.
// A key's destination is then its bin's prefix, plus the counts of the
// earlier warps of the tile, plus its rank in its warp: a stable order.
//
// Flag and count travel in one 64-bit status word, so the count has 32
// bits whatever the stream length (m < 2^31), and the word needs no
// ordering with other memory: relaxed gpu-scope loads and stores. The caller zeroes
// the status array and the ticket for each launch.
//
// Limits: a key's bin and its in-warp rank are packed into one register
// (kBinBits bits of bin, the rank above), and each warp keeps one row of
// num_bins counters in shared memory: int32 rows for num_bins <= kMaxBins
// (positions.cu); 16-bit rows, which hold a warp's count of at most 1024
// keys, for num_bins <= kMaxBins16 (cobra_pass.cu).
#pragma once

#include "pb_common.cuh"

namespace pb {
namespace onesweep {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 2048;            // kWarps rows of int32 counters: 128 KB
constexpr int kMaxBins16 = 4096;          // kWarps rows of 16-bit counters: 128 KB
constexpr int kBinBits = 13;
constexpr int kNoBin = (1 << kBinBits) - 1;  // out-of-range key
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// A status word carries its own payload (flag and count in one 64-bit
// word), so it needs no ordering with other memory: relaxed loads and
// stores at gpu scope, which read and write L2 coherently. (Acquire and
// release put a MEMBAR.GPU beside every load of the walk back; PERF.md
// has the times of both.)
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A flag that orders the writer's earlier stores before the reader's
// later accesses (fused.cu: a split slab's first chunk before the rest).

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The next ticket of `counter`, the same for every thread of the block.
__device__ __forceinline__ long long take_ticket(unsigned* counter, int* s_slot) {
  if (threadIdx.x == 0) *s_slot = (int)atomicAdd(counter, 1u);
  __syncthreads();
  return *s_slot;
}

// packed[j] holds item j's bin (kNoBin if out of range) on entry; item j
// of lane l is the warp's (32 j + l)-th key in stream order. `row` is the
// warp's zeroed row of num_bins counters (int, or unsigned short where
// ITEMS * 32 < 2^16). On return row[b] is the warp's
// count of bin b, and packed[j] also carries, above kBinBits, the key's
// rank among the warp's earlier keys of its bin.
//
// Equal keys are found by a warp multisplit: one ballot per bit of the
// key, NBITS = bit_length(num_bins) of them (so kNoBin's low bits differ
// from every bin), unrolled at compile time. __match_any_sync costs about
// one pass per distinct key in the warp, and a warp of keys over 512 bins
// holds some 30 distinct ones (PERF.md).
template <int ITEMS, int NBITS, typename C>
__device__ __forceinline__ void rank_warp(int (&packed)[ITEMS], C* row, int num_bins) {
  const unsigned lt = pb_lanemask_lt();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int b = packed[j];
    unsigned peers = PB_FULL_MASK;
#pragma unroll
    for (int i = 0; i < NBITS; ++i) {
      const bool set = (b >> i) & 1;
      const unsigned bal = __ballot_sync(PB_FULL_MASK, set);
      peers &= set ? bal : ~bal;
    }
    const bool ok = b < num_bins;
    const int before = ok ? (int)row[b] : 0;
    __syncwarp();
    // one writer per distinct bin: the lowest lane of its peers
    if (ok && (peers & lt) == 0) row[b] = (C)(before + __popc(peers));
    __syncwarp();
    packed[j] = b | ((before + __popc(peers & lt)) << kBinBits);
  }
}

// After every warp's rank_warp and a barrier, in a block of kThreads:
// each bin's column of warp counts becomes the warp's exclusive offset in
// the tile (warp order), and s_tot[b] the tile's count. Thread t owns
// bins t, t + blockDim.x, ... here and in publish_aggregates and
// look_back, so those need no barrier between them.
template <typename C>
__device__ __forceinline__ void scan_warps(C* cnt, int* s_tot, int num_bins) {
  for (int b = threadIdx.x; b < num_bins; b += kThreads) {
    int run = 0;
#pragma unroll 4
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * num_bins + b];
      cnt[w * num_bins + b] = (C)run;
      run += c;
    }
    s_tot[b] = run;
  }
}

// Tile 0 publishes no aggregate: its first word is its inclusive prefix,
// so a walk back never passes tile 0.
__device__ __forceinline__ void publish_aggregates(unsigned long long* status, long long tile,
                                                   const int* s_tot, int num_bins) {
  if (tile == 0) return;
  unsigned long long* row = status + tile * num_bins;
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x)
    store_status(&row[b], kAggregate | (unsigned)s_tot[b]);
}

// s_pre[b] = the destination of the tile's first key of bin b: seed[b]
// (read by tile 0 only) plus the counts of bin b in every earlier tile.
// s_pre may alias seed. Publishes the tile's inclusive prefix. The walk
// back reads kWindow earlier tiles' words at once, so that a walk over
// published aggregates costs one round trip to L2 per kWindow tiles.
constexpr int kWindow = 8;

__device__ __forceinline__ void look_back(unsigned long long* status, long long tile,
                                          const int* s_tot, const int* seed, int* s_pre,
                                          int num_bins) {
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    unsigned run = 0;
    if (tile == 0) {
      run = (unsigned)seed[b];
    } else {
      for (long long t = tile - 1;; t -= kWindow) {
        unsigned long long w[kWindow];
#pragma unroll
        for (int k = 0; k < kWindow; ++k)
          w[k] = t - k >= 0 ? load_status(&status[(t - k) * num_bins + b]) : kInclusive;
        bool done = false;
#pragma unroll
        for (int k = 0; k < kWindow; ++k) {
          if (done) break;
          while ((w[k] >> 32) == 0) w[k] = load_status(&status[(t - k) * num_bins + b]);
          run += (unsigned)w[k];
          done = w[k] >= kInclusive;
        }
        if (done) break;
      }
    }
    store_status(&status[tile * num_bins + b], kInclusive | (run + (unsigned)s_tot[b]));
    s_pre[b] = (int)run;
  }
}

// In-place exclusive scan of a[0, n) by the block; returns the total.
// s_warp holds one int per warp of the block, plus one. Contains
// barriers: every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int* a, int n, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int b0 = min((int)threadIdx.x * per, n);
  const int b1 = min(b0 + per, n);
  int local = 0;
  for (int b = b0; b < b1; ++b) local += a[b];
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(PB_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < warps ? s_warp[lane] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(PB_FULL_MASK, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < warps) s_warp[lane] = inc - v;
    if (lane == warps - 1) s_warp[warps] = inc;
  }
  __syncthreads();
  int run = s_warp[warp] + x - local;
  for (int b = b0; b < b1; ++b) {
    const int c = a[b];
    a[b] = run;
    run += c;
  }
  const int total = s_warp[warps];
  __syncthreads();
  return total;
}

}  // namespace onesweep
}  // namespace pb

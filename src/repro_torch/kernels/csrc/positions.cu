// Stable counting-sort destinations:
//   pos[i] = starts[k_i] + #{j < i : k_j = k_i},  -1 when k_i is not in [0, B).
//
// Replaces: src/repro/kernels/binning.py::counting_positions_pallas. The
// TPU kernel carries per-bin write cursors in VMEM from one grid step to
// the next (binning.py:43-59); that works because a TPU grid runs its
// steps in order. A GPU grid runs in no order, so the cursors are rebuilt
// in three phases over fixed tiles of the stream:
//   (a) tile_count: per-(tile, bin) counts into a (num_tiles, B) int32
//       matrix (pb_tiles.cuh, shared with the COBRA pass);
//   (b) column_scan (pb_tiles.cuh): an exclusive scan down each bin's column, in tile
//       order, seeded with starts[b] — the matrix then holds each tile's
//       first destination per bin;
//   (c) tile_rank: inside a tile, each warp owns a contiguous sub-chunk
//       and walks it 32 keys at a time in stream order. __match_any_sync
//       groups equal keys; a lane's rank is the population count of its
//       lower peers, its base the warp's per-bin cursor, and the lowest
//       peer advances the cursor. Warp cursors start from (b) plus the
//       counts of the earlier warps of the tile, so the result is stable.
//
// Bound on the H100: bytes — 4*m keys read and 4*m positions written
// (8*m), plus the count matrix (written by (a), read and rewritten by (b),
// read by (c)). The tile grows with B (at least 8*B keys) so the matrix
// stays a small fraction of the key bytes: at B = 908 and m = 1.3e8 the
// tile is 16384 keys and the matrix 29 MB, against 520 MB of keys.
// Keys are read three times, which a fused later version can save.
//
// Per-warp cursors sit in shared memory while W*B int32 fit in 48 KB; for
// a larger B one warp ranks each tile against the matrix row itself, in
// global memory (L2).
#include "pb_common.cuh"
#include "pb_tiles.cuh"

namespace {

constexpr int kSmemInts = 12288;   // 48 KB of int32 cursors per block
constexpr int kMaxWarps = 8;
constexpr int kCountThreads = 256;
constexpr long long kKeysPerWarp = 2048;

struct Plan {
  int warps;       // warps per tile in phase (c)
  long long tile;  // keys per tile
  bool smem;       // cursors in shared memory
};

Plan plan_for(int num_bins) {
  Plan p;
  int w = kSmemInts / num_bins;
  p.smem = w >= 1;
  if (!p.smem) w = 1;
  if (w > kMaxWarps) w = kMaxWarps;
  while (w & (w - 1)) w &= w - 1;  // round down to a power of two
  p.warps = w;
  long long t = 1;
  while (t < 8LL * num_bins) t <<= 1;
  p.tile = t > w * kKeysPerWarp ? t : w * kKeysPerWarp;
  return p;
}

template <bool kShared>
__global__ void tile_rank_kernel(const int* __restrict__ keys, long long m,
                                 int* __restrict__ mat, int* __restrict__ pos,
                                 int num_bins, long long tile, int warps) {
  extern __shared__ int sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * tile;
  const long long t1 = t0 + tile < m ? t0 + tile : m;
  const long long sub = tile / warps;
  const long long s0 = t0 + warp * sub;
  const long long s1 = s0 + sub < t1 ? s0 + sub : t1;
  int* row = mat + (long long)blockIdx.x * num_bins;
  int* cur = row;
  if (kShared) {
    int* mine = sh + warp * num_bins;
    for (int b = lane; b < num_bins; b += 32) mine[b] = 0;
    __syncwarp();
    for (long long base = s0; base < s1; base += 32) {
      const long long i = base + lane;
      const int k = i < s1 ? keys[i] : -1;
      const unsigned peers = __match_any_sync(PB_FULL_MASK, k);
      // one writer per distinct key: no two lanes touch the same counter
      if ((unsigned)k < (unsigned)num_bins && lane == __ffs(peers) - 1)
        mine[k] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
      int run = row[b];
      for (int q = 0; q < warps; ++q) {
        const int c = sh[q * num_bins + b];
        sh[q * num_bins + b] = run;
        run += c;
      }
    }
    __syncthreads();
    cur = mine;
  }
  for (long long base = s0; base < s1; base += 32) {
    const long long i = base + lane;
    const bool in = i < s1;
    const int k = in ? keys[i] : -1;
    const bool ok = in && (unsigned)k < (unsigned)num_bins;
    const unsigned peers = __match_any_sync(PB_FULL_MASK, k);
    const int rank = __popc(peers & pb_lanemask_lt());
    const int first = ok ? cur[k] : 0;
    __syncwarp();
    if (ok && rank == 0) cur[k] = first + __popc(peers);
    __syncwarp();
    if (in) pos[i] = ok ? first + rank : -1;
  }
}

}  // namespace

// int32 elements of scratch the wrapper allocates: the (num_tiles, B) matrix.
extern "C" long long pb_positions_scratch(long long m, int num_bins) {
  if (m <= 0 || num_bins <= 0) return 0;
  const Plan p = plan_for(num_bins);
  return ((m + p.tile - 1) / p.tile) * (long long)num_bins;
}

extern "C" int pb_counting_positions(const int* keys, long long m, const int* starts,
                                     int num_bins, int* pos, int* scratch,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || num_bins <= 0) return (int)cudaGetLastError();
  const Plan p = plan_for(num_bins);
  const long long tiles = (m + p.tile - 1) / p.tile;
  const size_t smem_count = p.smem ? num_bins * sizeof(int) : 0;
  const size_t smem_rank = p.smem ? (size_t)p.warps * num_bins * sizeof(int) : 0;
  if (p.smem) {
    tile_count_kernel<true><<<(unsigned)tiles, kCountThreads, smem_count, s>>>(
        keys, m, scratch, num_bins, p.tile);
  } else {
    cudaMemsetAsync(scratch, 0, tiles * num_bins * sizeof(int), s);
    tile_count_kernel<false><<<(unsigned)tiles, kCountThreads, 0, s>>>(keys, m, scratch,
                                                             num_bins, p.tile);
  }
  column_scan_kernel<<<(num_bins + 31) / 32, 1024, 0, s>>>(scratch, starts, tiles,
                                                           num_bins);
  if (p.smem)
    tile_rank_kernel<true><<<(unsigned)tiles, p.warps * 32, smem_rank, s>>>(
        keys, m, scratch, pos, num_bins, p.tile, p.warps);
  else
    tile_rank_kernel<false><<<(unsigned)tiles, 32, 0, s>>>(keys, m, scratch, pos, num_bins,
                                                 p.tile, 1);
  return (int)cudaGetLastError();
}

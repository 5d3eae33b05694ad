// Stable counting-sort destinations:
//   pos[i] = starts[k_i] + #{j < i : k_j = k_i},  -1 when k_i is not in [0, B).
//
// Replaces: src/repro/kernels/binning.py::counting_positions_pallas. The
// TPU kernel carries per-bin write cursors in VMEM from one grid step to
// the next (binning.py:43-59); that works because a TPU grid runs its
// steps in order. A GPU grid runs in no order, so the cursors are rebuilt.
//
// Bound on the H100: bytes — 4*m keys read and 4*m positions written
// (8*m), 0.080 ms at m = 2^25 and 3.35 TB/s.
//
// Two designs; the wrapper (kernels/binning.py) picks by B:
//
// onesweep, for B <= pb::onesweep::kMaxBins (2048): one kernel that reads
//   each key once (pb_onesweep.cuh). A block takes a tile of kPosTile
//   keys (16384; 32 a thread, in registers) by ticket, ranks them in its
//   warps (a multisplit of one ballot per key bit, instantiated for each
//   bit count up to 12), publishes its per-bin counts into a (tiles, B) array of
//   64-bit status words, looks back over the earlier tiles for each bin's
//   first destination (tile 0 starts from starts[b]) and writes pos in
//   stream order. Extra traffic: the status array, 8*B bytes a tile
//   (zeroed, written once, read by the next tiles; 6% of the key bytes at
//   B = 512), mostly in L2. The switch point is the shared memory of the
//   per-warp counters: 16 warps x B int32, 128 KB at B = 2048.
//
// three-phase, for larger B (and on request): three kernels that read
//   the keys three times:
//   (a) tile_count: per-(tile, bin) counts into a (num_tiles, B) int32
//       matrix (pb_tiles.cuh, shared with the COBRA pass);
//   (b) column_scan (pb_tiles.cuh): an exclusive scan down each bin's
//       column, in tile order, seeded with starts[b];
//   (c) tile_rank: inside a tile, each warp walks its sub-chunk 32 keys
//       at a time; __match_any_sync groups equal keys, a lane's rank is
//       the count of its lower peers, its base the warp's per-bin cursor.
//   Per-warp cursors sit in shared memory while W*B int32 fit in 48 KB;
//   for a larger B one warp ranks each tile against the matrix row itself
//   in global memory (L2). The tile grows with B (at least 8*B keys) so
//   the matrix stays a small fraction of the key bytes.
#include "pb_common.cuh"
#include "pb_onesweep.cuh"
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

namespace os = pb::onesweep;
constexpr int kPosItems = 32;
constexpr long long kPosTile = (long long)os::kThreads * kPosItems;  // 16384 keys

template <int NBITS>
__global__ void __launch_bounds__(os::kThreads)
positions_onesweep_kernel(const int* __restrict__ keys, long long m,
                          const int* __restrict__ starts, int num_bins,
                          int* __restrict__ pos, unsigned long long* __restrict__ status,
                          unsigned* __restrict__ ticket) {
  extern __shared__ int sh[];
  int* cnt = sh;                             // [kWarps][num_bins] warp counters
  int* s_tot = cnt + os::kWarps * num_bins;  // [num_bins] tile counts, then prefixes
  __shared__ int s_tile;
  const long long tile = os::take_ticket(ticket, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = tile * kPosTile + (long long)warp * (kPosItems * 32) + lane;

  int packed[kPosItems];
#pragma unroll
  for (int j = 0; j < kPosItems; ++j) {
    const long long i = base + j * 32;
    const int k = i < m ? __ldcs(keys + i) : -1;
    packed[j] = (unsigned)k < (unsigned)num_bins ? k : os::kNoBin;
  }
  int* row = cnt + warp * num_bins;
  for (int b = lane; b < num_bins; b += 32) row[b] = 0;
  __syncwarp();
  os::rank_warp<kPosItems, NBITS>(packed, row, num_bins);
  __syncthreads();
  os::scan_warps(cnt, s_tot, num_bins);
  os::publish_aggregates(status, tile, s_tot, num_bins);
  os::look_back(status, tile, s_tot, starts, s_tot, num_bins);
  // fold each bin's first destination into its warp offsets (same owner thread)
  for (int b = threadIdx.x; b < num_bins; b += os::kThreads) {
    const int p = s_tot[b];
    for (int w = 0; w < os::kWarps; ++w) cnt[w * num_bins + b] += p;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPosItems; ++j) {
    const long long i = base + j * 32;
    const int b = packed[j] & os::kNoBin;
    if (i < m)
      __stcs(pos + i, b < num_bins ? row[b] + (packed[j] >> os::kBinBits) : -1);
  }
}

}  // namespace

// Scratch the wrapper allocates, in int32 elements. onesweep (design 1):
// a 16-byte header holding the tile ticket, then the (tiles, B) 64-bit
// status words; three-phase (design 0): the (num_tiles, B) count matrix.
extern "C" long long pb_positions_scratch(long long m, int num_bins, int design) {
  if (m <= 0 || num_bins <= 0) return 0;
  if (design == 1) {
    const long long tiles = (m + kPosTile - 1) / kPosTile;
    return 4 + 2 * tiles * num_bins;
  }
  const Plan p = plan_for(num_bins);
  return ((m + p.tile - 1) / p.tile) * (long long)num_bins;
}

static int positions_onesweep(const int* keys, long long m, const int* starts, int num_bins,
                              int* pos, int* scratch, cudaStream_t s) {
  if (num_bins > os::kMaxBins) return (int)cudaErrorInvalidValue;
  const long long tiles = (m + kPosTile - 1) / kPosTile;
  const size_t smem = (size_t)(os::kWarps + 1) * num_bins * sizeof(int);
  void (*kernel)(const int*, long long, const int*, int, int*, unsigned long long*, unsigned*);
  switch (32 - __builtin_clz((unsigned)num_bins)) {  // bit_length(num_bins): the ballots a key
    case 1: kernel = positions_onesweep_kernel<1>; break;
    case 2: kernel = positions_onesweep_kernel<2>; break;
    case 3: kernel = positions_onesweep_kernel<3>; break;
    case 4: kernel = positions_onesweep_kernel<4>; break;
    case 5: kernel = positions_onesweep_kernel<5>; break;
    case 6: kernel = positions_onesweep_kernel<6>; break;
    case 7: kernel = positions_onesweep_kernel<7>; break;
    case 8: kernel = positions_onesweep_kernel<8>; break;
    case 9: kernel = positions_onesweep_kernel<9>; break;
    case 10: kernel = positions_onesweep_kernel<10>; break;
    case 11: kernel = positions_onesweep_kernel<11>; break;
    default: kernel = positions_onesweep_kernel<12>; break;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaMemsetAsync(scratch, 0, (size_t)pb_positions_scratch(m, num_bins, 1) * sizeof(int), s);
  kernel<<<(unsigned)tiles, os::kThreads, smem, s>>>(
      keys, m, starts, num_bins, pos, reinterpret_cast<unsigned long long*>(scratch + 4),
      reinterpret_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}

extern "C" int pb_counting_positions(const int* keys, long long m, const int* starts,
                                     int num_bins, int* pos, int* scratch, int design,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || num_bins <= 0) return (int)cudaGetLastError();
  if (design == 1) return positions_onesweep(keys, m, starts, num_bins, pos, scratch, s);
  if (design != 0) return (int)cudaErrorInvalidValue;
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

// One COBRA binning pass: the (idx, val) stream stably partitioned by key,
//   out[starts[k] + #{j < i : key_j = k}] = (idx_i, val_i)  for key_i = k.
//
// Replaces: src/repro/kernels/binning.py::cobra_binning_pass_pallas. The
// TPU kernel appends each block of tuples to per-bin C-Buffers in VMEM and
// evicts a C-Buffer about to overflow as one contiguous write at its bin's
// cursor, carrying cursors and fill levels across grid steps that run in
// order (binning.py:20-21). A GPU grid runs in no order, so the cursors
// are rebuilt.
//
// Bound on the H100: bytes — keys, idx and val read (12*m), idx and val
// written (8*m): 20*m, 0.764 ms at m = 128M and 3.35 TB/s.
//
// Two designs; the wrapper (kernels/binning.py) picks by B:
//
// onesweep, for B <= pb::onesweep::kMaxBins16 (4096, every pass of
//   ops.cobra_binning): one kernel on the look-back core of
//   pb_onesweep.cuh that reads keys, idx and val once each. A block takes
//   a tile of kOsTile tuples (8192; 16 a thread, in registers) by ticket,
//   ranks the keys stably in its warps (16-bit counter rows: 128 KB at
//   B = 4096), scans the warp counts, publishes the tile's per-bin counts
//   and looks back for each bin's first destination (tile 0 starts from
//   starts[b]). The C-Buffers are the tile staged in shared memory grouped
//   by bin, at slot (tile-local bin start + rank in the tile), laid over
//   the counter rows once the slots are in registers. Each bin's run is
//   then written at its destination by consecutive threads on consecutive
//   addresses: one run per bin per tile, the coalesced eviction COBRA's
//   C-Buffers buy. A run is m / (tiles * B) tuples on average: 11 at
//   B = 735, 3.7 at B = 2203. Extra traffic: the (tiles, B) 64-bit status
//   words (zeroed, then written back: 16 bytes per (tile, B), 4% of the
//   tuple bytes at B = 735, 11% at B = 2203).
//
// three-phase, for larger B (up to kMaxBins, and on request): three kernels
//   that read the keys twice and gather idx and val:
//   (a) tile_count_kernel and (b) column_scan_kernel (pb_tiles.cuh) give
//       each (tile, bin) of kTile tuples its first destination;
//   (c) cobra_flush_kernel: each block stages its tile in shared memory
//       grouped by bin — a stable cub::BlockRadixSort of (key, position
//       in tile) over the key's bits — and flushes each bin's run from
//       the bin's cursor, gathering idx and val by position.
//
// Values are any 4-byte payload (int32 and float32 alike: the kernel
// copies bits). The output is exactly m tuples long (the TPU kernel's
// overhangs by its C-Buffer capacity). Every key must lie in
// [0, num_bins): a key outside it is dropped and leaves its slot at the
// end of the output unwritten. num_bins <= kMaxBins.
#include <cub/block/block_radix_sort.cuh>

#include "pb_common.cuh"
#include "pb_onesweep.cuh"
#include "pb_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 tuples
constexpr int kMaxBins = 12288;           // three-phase: 48 KB of int32 per-bin counters
constexpr int kCountThreads = 256;

__global__ void __launch_bounds__(kThreads)
cobra_flush_kernel(const int* __restrict__ keys, const int* __restrict__ idx,
                   const unsigned* __restrict__ val, long long m,
                   const int* __restrict__ cursors, int num_bins, int key_bits,
                   int* __restrict__ out_idx, unsigned* __restrict__ out_val) {
  typedef cub::BlockRadixSort<unsigned, kThreads, kItems, int> Sort;
  struct Staged {
    unsigned key[kTile];
    int pos[kTile];
  };
  __shared__ union {
    typename Sort::TempStorage sort;
    Staged st;
  } sh;
  extern __shared__ int s_first[];  // first staged slot of each bin

  const long long t0 = (long long)blockIdx.x * kTile;
  const int n = m - t0 < kTile ? (int)(m - t0) : kTile;
  unsigned k[kItems];
  int p[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int q = threadIdx.x * kItems + j;  // blocked: stream order
    p[j] = q;
    k[j] = (unsigned)num_bins;  // sorts last, never written
    if (q < n) {
      const int kk = keys[t0 + q];
      if ((unsigned)kk < (unsigned)num_bins) k[j] = (unsigned)kk;
    }
  }
  Sort(sh.sort).Sort(k, p, 0, key_bits);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int s = threadIdx.x * kItems + j;
    sh.st.key[s] = k[j];
    sh.st.pos[s] = p[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int s = threadIdx.x * kItems + j;
    if (k[j] < (unsigned)num_bins && (s == 0 || sh.st.key[s - 1] != k[j]))
      s_first[k[j]] = s;
  }
  __syncthreads();
  const int* cur = cursors + (long long)blockIdx.x * num_bins;
  for (int s = threadIdx.x; s < kTile; s += kThreads) {
    const unsigned b = sh.st.key[s];
    if (b >= (unsigned)num_bins) break;  // sorted: the rest are dropped too
    const long long d = (long long)cur[b] + (s - s_first[b]);
    const long long src = t0 + sh.st.pos[s];
    out_idx[d] = idx[src];
    out_val[d] = val[src];
  }
}

long long num_tiles(long long m) { return (m + kTile - 1) / kTile; }

// -- onesweep -----------------------------------------------------------------

namespace os = pb::onesweep;
constexpr int kOsItems = 16;
constexpr int kOsTile = os::kThreads * kOsItems;  // 8192 tuples
constexpr int kSlotBits = 16;  // packed slot: the staged slot below, the bin above

// Shared memory of the onesweep kernel: the C-Buffers (16-bit counter rows,
// then the staged tile: idx, val and a 16-bit bin per slot), then two
// int32 per bin.
__host__ __device__ inline size_t os_cbuf_bytes(int num_bins) {
  const size_t rows = (size_t)os::kWarps * num_bins * sizeof(unsigned short);
  const size_t staged = (size_t)kOsTile * (2 * sizeof(int) + sizeof(unsigned short));
  return ((rows > staged ? rows : staged) + 15) & ~(size_t)15;
}

size_t os_smem(int num_bins) {
  return os_cbuf_bytes(num_bins) + 2 * (size_t)num_bins * sizeof(int);
}

long long os_tiles(long long m) { return (m + kOsTile - 1) / kOsTile; }

// Two blocks an SM (64 registers a thread): one block's load and rank
// overlap the other's look-back and eviction.
template <int NBITS>
__global__ void __launch_bounds__(os::kThreads, 2)
cobra_onesweep_kernel(const int* __restrict__ keys, const int* __restrict__ idx,
                      const unsigned* __restrict__ val, long long m,
                      const int* __restrict__ starts, int num_bins, int* __restrict__ out_idx,
                      unsigned* __restrict__ out_val, unsigned long long* __restrict__ status,
                      unsigned* __restrict__ ticket) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int B = num_bins;
  unsigned short* cnt = reinterpret_cast<unsigned short*>(sh_raw);  // [kWarps][B] warp counters
  int* st_idx = reinterpret_cast<int*>(sh_raw);                     // [kOsTile] over cnt, later
  unsigned* st_val = reinterpret_cast<unsigned*>(st_idx + kOsTile);  // [kOsTile]
  unsigned short* st_bin = reinterpret_cast<unsigned short*>(st_val + kOsTile);  // [kOsTile]
  int* s_tot = reinterpret_cast<int*>(sh_raw + os_cbuf_bytes(B));  // [B] tile counts, then
                                                                   // destination - staged slot
  int* s_first = s_tot + B;  // [B] the bin's first staged slot
  __shared__ int s_warp[os::kWarps + 1];
  __shared__ int s_tile;
  const long long tile = os::take_ticket(ticket, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = tile * kOsTile + (long long)warp * (kOsItems * 32) + lane;

  int packed[kOsItems];
  int id[kOsItems];
  unsigned v[kOsItems];
#pragma unroll
  for (int j = 0; j < kOsItems; ++j) {
    const long long i = base + j * 32;
    const bool in = i < m;
    const int k = in ? __ldcs(keys + i) : -1;
    packed[j] = (unsigned)k < (unsigned)B ? k : os::kNoBin;
    id[j] = in ? __ldcs(idx + i) : 0;
    v[j] = in ? __ldcs(val + i) : 0u;
  }
  unsigned short* row = cnt + warp * B;
  for (int b = lane; b < B; b += 32) row[b] = 0;
  __syncwarp();
  os::rank_warp<kOsItems, NBITS>(packed, row, B);
  __syncthreads();
  os::scan_warps(cnt, s_tot, B);
  os::publish_aggregates(status, tile, s_tot, B);
  for (int b = threadIdx.x; b < B; b += os::kThreads) s_first[b] = s_tot[b];
  __syncthreads();
  const int staged = os::block_exclusive_scan(s_first, B, s_warp);  // the tile's in-range tuples
  // a key's staged slot: its bin's first slot in the tile, plus its warp's
  // offset in the bin, plus its rank in the warp
#pragma unroll
  for (int j = 0; j < kOsItems; ++j) {
    const int b = packed[j] & os::kNoBin;
    packed[j] = b < B ? (s_first[b] + row[b] + (packed[j] >> os::kBinBits)) | (b << kSlotBits) : -1;
  }
  __syncthreads();  // every slot is in registers: the staged tile overlays the counters
#pragma unroll
  for (int j = 0; j < kOsItems; ++j) {
    if (packed[j] >= 0) {
      const int s = packed[j] & ((1 << kSlotBits) - 1);
      st_idx[s] = id[j];
      st_val[s] = v[j];
      st_bin[s] = (unsigned short)(packed[j] >> kSlotBits);
    }
  }
  os::look_back(status, tile, s_tot, starts, s_tot, B);
  for (int b = threadIdx.x; b < B; b += os::kThreads) s_tot[b] -= s_first[b];
  __syncthreads();
  // evict: slot s of bin b goes to s_tot[b] + s, so consecutive threads
  // write each bin's run to consecutive addresses
  for (int s = threadIdx.x; s < staged; s += os::kThreads) {
    const int d = s_tot[st_bin[s]] + s;
    __stcs(out_idx + d, st_idx[s]);
    __stcs(out_val + d, st_val[s]);
  }
}

// Scratch of the onesweep design, in int32 elements: a 16-byte header
// holding the tile ticket, then the (tiles, B) 64-bit status words.
long long os_scratch(long long m, int num_bins) { return 4 + 2 * os_tiles(m) * num_bins; }

int onesweep_pass(const int* keys, const int* idx, const unsigned* val, long long m, const int* starts,
                  int num_bins, int* out_idx, unsigned* out_val, int* scratch, cudaStream_t s) {
  if (num_bins > os::kMaxBins16) return (int)cudaErrorInvalidValue;
  const size_t smem = os_smem(num_bins);
  void (*kernel)(const int*, const int*, const unsigned*, long long, const int*, int, int*,
                 unsigned*, unsigned long long*, unsigned*);
  switch (32 - __builtin_clz((unsigned)num_bins)) {  // bit_length(num_bins): the ballots a key
    case 1: kernel = cobra_onesweep_kernel<1>; break;
    case 2: kernel = cobra_onesweep_kernel<2>; break;
    case 3: kernel = cobra_onesweep_kernel<3>; break;
    case 4: kernel = cobra_onesweep_kernel<4>; break;
    case 5: kernel = cobra_onesweep_kernel<5>; break;
    case 6: kernel = cobra_onesweep_kernel<6>; break;
    case 7: kernel = cobra_onesweep_kernel<7>; break;
    case 8: kernel = cobra_onesweep_kernel<8>; break;
    case 9: kernel = cobra_onesweep_kernel<9>; break;
    case 10: kernel = cobra_onesweep_kernel<10>; break;
    case 11: kernel = cobra_onesweep_kernel<11>; break;
    case 12: kernel = cobra_onesweep_kernel<12>; break;
    default: kernel = cobra_onesweep_kernel<13>; break;
  }
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaMemsetAsync(scratch, 0, (size_t)os_scratch(m, num_bins) * sizeof(int), s);
  kernel<<<(unsigned)os_tiles(m), os::kThreads, smem, s>>>(
      keys, idx, val, m, starts, num_bins, out_idx, out_val,
      reinterpret_cast<unsigned long long*>(scratch + 4), reinterpret_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}

}  // namespace

// int32 elements of scratch the wrapper allocates for `design` (1:
// onesweep, the ticket and the status words; 0: three-phase, the
// (num_tiles, B) count matrix).
extern "C" long long pb_cobra_pass_scratch(long long m, int num_bins, int design) {
  if (m <= 0 || num_bins <= 0) return 0;
  if (design == 1) return os_scratch(m, num_bins);
  return num_tiles(m) * (long long)num_bins;
}

extern "C" int pb_cobra_pass(const int* keys, const int* idx, const void* val,
                             long long m, const int* starts, int num_bins, int* out_idx,
                             void* out_val, int* scratch, int design, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return (int)cudaGetLastError();
  if (num_bins <= 0 || num_bins > kMaxBins) return (int)cudaErrorInvalidValue;
  if (design == 1)
    return onesweep_pass(keys, idx, static_cast<const unsigned*>(val), m, starts, num_bins, out_idx,
                    static_cast<unsigned*>(out_val), scratch, s);
  if (design != 0) return (int)cudaErrorInvalidValue;
  const long long tiles = num_tiles(m);
  tile_count_kernel<true><<<(unsigned)tiles, kCountThreads, num_bins * sizeof(int), s>>>(
      keys, m, scratch, num_bins, kTile);
  column_scan_kernel<<<(num_bins + 31) / 32, 1024, 0, s>>>(scratch, starts, tiles, num_bins);
  int key_bits = 1;
  while ((1 << key_bits) <= num_bins) ++key_bits;  // room for the drop key num_bins
  const size_t dyn = num_bins * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(cobra_flush_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  cobra_flush_kernel<<<(unsigned)tiles, kThreads, dyn, s>>>(
      keys, idx, static_cast<const unsigned*>(val), m, scratch, num_bins, key_bits,
      out_idx, static_cast<unsigned*>(out_val));
  return (int)cudaGetLastError();
}

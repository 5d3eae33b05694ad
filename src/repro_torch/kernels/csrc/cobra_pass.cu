// One COBRA binning pass: the (idx, val) stream stably partitioned by key,
//   out[starts[k] + #{j < i : key_j = k}] = (idx_i, val_i)  for key_i = k.
//
// Replaces: src/repro/kernels/binning.py::cobra_binning_pass_pallas. The
// TPU kernel appends each block of tuples to per-bin C-Buffers in VMEM and
// evicts a C-Buffer about to overflow as one contiguous write at its bin's
// cursor, carrying cursors and fill levels across grid steps that run in
// order (binning.py:20-21). A GPU grid runs in no order, so the cursors
// are rebuilt first, as in positions.cu, over tiles of kTile tuples:
//   (a) tile_count_kernel and (b) column_scan_kernel (pb_tiles.cuh) give
//       each (tile, bin) its first destination;
//   (c) cobra_flush_kernel: each block stages its tile in shared memory
//       grouped by bin — a stable cub::BlockRadixSort of (key, position
//       in tile) over the key's bits. The groups are the C-Buffers. It
//       then flushes them: consecutive staged slots of one bin go to
//       consecutive destinations from the bin's cursor, so each bin's run
//       is one coalesced write, the eviction COBRA's C-Buffers buy.
//
// Bound on the H100: bytes — keys, idx and val read (12*m), idx and val
// written (8*m); the (num_tiles, B) count matrix adds 12 bytes per
// (tile, bin) (written, read and rewritten by the scan, read by (c)).
//
// Values are any 4-byte payload (int32 and float32 alike: the kernel
// copies bits). The output is exactly m tuples long (the TPU kernel's
// overhangs by its C-Buffer capacity). Every key must lie in
// [0, num_bins): a key outside it is dropped and leaves its slot at the
// end of the output unwritten. num_bins <= kMaxBins.
#include <cub/block/block_radix_sort.cuh>

#include "pb_common.cuh"
#include "pb_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 tuples
constexpr int kMaxBins = 12288;           // 48 KB of int32 per-bin counters
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

}  // namespace

// int32 elements of scratch the wrapper allocates: the (num_tiles, B) matrix.
extern "C" long long pb_cobra_pass_scratch(long long m, int num_bins) {
  if (m <= 0 || num_bins <= 0) return 0;
  return num_tiles(m) * (long long)num_bins;
}

extern "C" int pb_cobra_pass(const int* keys, const int* idx, const void* val,
                             long long m, const int* starts, int num_bins, int* out_idx,
                             void* out_val, int* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return (int)cudaGetLastError();
  if (num_bins <= 0 || num_bins > kMaxBins) return (int)cudaErrorInvalidValue;
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

// The first two phases of a stable partition by key over fixed tiles of
// the stream, shared by positions.cu and cobra_pass.cu:
//   tile_count_kernel:  per-(tile, bin) counts into a (num_tiles, B)
//                       int32 matrix (one block per tile);
//   column_scan_kernel: an exclusive scan down each bin's column, in tile
//                       order, seeded with starts[b] — the matrix then
//                       holds each tile's first destination per bin.
// A GPU grid runs its blocks in no order; these two phases rebuild the
// per-bin cursors that a TPU kernel carries across sequential grid steps.
#pragma once

#include "pb_common.cuh"

namespace {

template <bool kShared>
__global__ void tile_count_kernel(const int* __restrict__ keys, long long m,
                                  int* __restrict__ mat, int num_bins,
                                  long long tile) {
  extern __shared__ int sh[];
  const long long t0 = (long long)blockIdx.x * tile;
  const long long t1 = t0 + tile < m ? t0 + tile : m;
  int* row = mat + (long long)blockIdx.x * num_bins;
  int* h = kShared ? sh : row;
  if (kShared) {
    for (int b = threadIdx.x; b < num_bins; b += blockDim.x) sh[b] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  for (long long base = t0 + (threadIdx.x & ~31); base < t1; base += blockDim.x) {
    const long long i = base + lane;
    const int k = i < t1 ? keys[i] : -1;
    const unsigned peers = __match_any_sync(PB_FULL_MASK, k);
    if ((unsigned)k < (unsigned)num_bins && lane == __ffs(peers) - 1)
      atomicAdd(&h[k], __popc(peers));
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_bins; b += blockDim.x) row[b] = sh[b];
  }
}

// One block of 32 warps per strip of 32 bins: lane = bin, warp w scans a
// contiguous run of tiles; the 32 run totals are scanned in between.
__global__ void column_scan_kernel(int* __restrict__ mat, const int* __restrict__ starts,
                                   long long num_tiles, int num_bins) {
  __shared__ int part[32][33];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const long long per = (num_tiles + 31) / 32;
  const long long r0 = w * per;
  const long long r1 = r0 + per < num_tiles ? r0 + per : num_tiles;
  int s = 0;
  if (b < num_bins)
    for (long long t = r0; t < r1; ++t) s += mat[t * num_bins + b];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0) {
    int run = b < num_bins ? starts[b] : 0;
    for (int q = 0; q < 32; ++q) {
      const int c = part[q][lane];
      part[q][lane] = run;
      run += c;
    }
  }
  __syncthreads();
  if (b < num_bins) {
    int run = part[w][lane];
    for (long long t = r0; t < r1; ++t) {
      const long long o = t * num_bins + b;
      const int c = mat[o];
      mat[o] = run;
      run += c;
    }
  }
}

}  // namespace

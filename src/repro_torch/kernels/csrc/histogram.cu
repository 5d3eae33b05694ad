// Histogram of int32 keys in [0, num_bins); other keys are ignored.
//
// Replaces: src/repro/kernels/histogram.py::histogram_pallas, which builds
// a (block, num_bins) one-hot tile in VMEM and reduces it on the MXU,
// carrying one output block across sequential grid steps.
//
// Bound on the H100: bytes. The work reads 4*m bytes of keys and writes
// 4*num_bins counts; at 3.35 TB/s nothing else should cost more.
//
// Design: a grid-stride loop over the keys. Each block counts into a
// shared-memory histogram; within a warp, equal keys are combined with
// __match_any_sync so a skewed stream (every key equal) costs one shared
// atomic per warp, not 32. At the end each block adds its non-zero bins
// into the global counts with one atomicAdd per bin. When num_bins does
// not fit the 48 KB a block gets without opting in (kSmemBins), the same
// warp-combined increments go straight to the global counts, which then
// live in L2. The caller zeroes `counts`.
#include "pb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBins = 12288;  // 48 KB of int32 counters
constexpr int kKeysPerBlock = 4096;

template <bool kShared>
__global__ void histogram_kernel(const int* __restrict__ keys, long long m,
                                 int* __restrict__ counts, int num_bins) {
  extern __shared__ int sh[];
  int* h = kShared ? sh : counts;
  if (kShared) {
    for (int b = threadIdx.x; b < num_bins; b += blockDim.x) sh[b] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // base is the same for the 32 lanes of a warp, so every lane reaches
  // __match_any_sync on every trip
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < m; base += stride) {
    const long long i = base + lane;
    const int k = i < m ? keys[i] : -1;
    const unsigned peers = __match_any_sync(PB_FULL_MASK, k);
    if ((unsigned)k < (unsigned)num_bins && lane == __ffs(peers) - 1)
      atomicAdd(&h[k], __popc(peers));
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
      const int c = sh[b];
      if (c) atomicAdd(&counts[b], c);
    }
  }
}

}  // namespace

extern "C" int pb_histogram(const int* keys, long long m, int* counts,
                            int num_bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || num_bins <= 0) return (int)cudaGetLastError();
  long long want = (m + kKeysPerBlock - 1) / kKeysPerBlock;
  long long cap = 4LL * pb_num_sms();
  const int blocks = (int)(want < cap ? want : cap);
  if (num_bins <= kSmemBins)
    histogram_kernel<true><<<blocks, kThreads, num_bins * sizeof(int), s>>>(
        keys, m, counts, num_bins);
  else
    histogram_kernel<false><<<blocks, kThreads, 0, s>>>(keys, m, counts, num_bins);
  return (int)cudaGetLastError();
}

extern "C" const char* pb_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

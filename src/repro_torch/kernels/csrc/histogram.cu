// Histogram of int32 keys in [0, num_bins); other keys, negatives
// included, are ignored.
//
// Replaces: src/repro/kernels/histogram.py::histogram_pallas, which builds
// a (block, num_bins) one-hot tile in VMEM and reduces it on the MXU,
// carrying one output block across sequential grid steps.
//
// Bound on the H100: bytes. The work reads 4*m bytes of keys and writes
// 4*num_bins counts: 0.040 ms at m = 2^25 and 3.35 TB/s.
//
// Design: enough blocks to fill the card (the occupancy the kernel's
// shared memory allows) walk the keys as 16-byte vectors, kVec of them a
// thread per trip (16 keys in registers, streaming loads); the few keys
// before the first 16-byte boundary and after the last whole vector are
// counted one by one. Each key is a plain shared-memory atomicAdd (native
// ATOMS.ADD on sm_90), with no per-key __match_any_sync. A skewed stream
// must not serialise on one shared address, so each block keeps `copies`
// private copies of the histogram and lane l counts into copy
// l % copies: as many copies (a power of two, at most 32) as fit
// kSmemBytes, laid out at an odd stride so that the copies of one bin
// fall in different banks. A warp whose 32 keys are all equal (a ballot
// against lane 0's key) makes one atomic of 32. At the end each block
// adds its copies bin by bin into the global counts, one atomicAdd per
// non-zero bin. Above kSmemBins the same increments go straight to the
// global counts, which then live in L2. The caller zeroes `counts`.
#include <cstdint>

#include "pb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // int4 vectors a thread per trip: 16 keys
constexpr int kSmemBytes = 48 * 1024;
constexpr int kSmemBins = kSmemBytes / 4;  // 12288: one int32 copy
constexpr int kMaxCopies = 32;

struct Copies {
  int n;       // private copies a block (a power of two)
  int stride;  // ints from one copy to the next
};

Copies copies_for(int num_bins) {
  Copies c{kMaxCopies, num_bins | 1};
  while (c.n > 1 && (long long)c.n * c.stride * 4 > kSmemBytes) c.n >>= 1;
  if (c.n == 1) c.stride = num_bins;
  return c;
}

// Counts key k of this lane; every lane of the warp calls it together.
__device__ __forceinline__ void count_key(int* h, int* mine, int k, int num_bins) {
  const int k0 = __shfl_sync(PB_FULL_MASK, k, 0);
  if (__all_sync(PB_FULL_MASK, k == k0)) {
    if ((threadIdx.x & 31) == 0 && (unsigned)k0 < (unsigned)num_bins) atomicAdd(&h[k0], 32);
  } else if ((unsigned)k < (unsigned)num_bins) {
    atomicAdd(&mine[k], 1);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int* __restrict__ keys, long long m, int* __restrict__ counts,
                 int num_bins, int copies, int stride) {
  extern __shared__ int sh[];
  int* h = kShared ? sh : counts;
  int* mine = kShared ? sh + (threadIdx.x & (copies - 1)) * stride : counts;
  if (kShared) {
    for (int b = threadIdx.x; b < copies * stride; b += kThreads) sh[b] = 0;
    __syncthreads();
  }
  // keys [0, head) lie before the first 16-byte boundary, [tail, m) after
  // the last whole vector
  const long long head = min(m, (long long)(((16 - ((uintptr_t)keys & 15)) & 15) >> 2));
  const int4* vec = reinterpret_cast<const int4*>(keys + head);
  const long long nvec = (m - head) >> 2;
  const long long tail = head + 4 * nvec;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long i = threadIdx.x < 4 ? threadIdx.x : tail + threadIdx.x - 4;
    if (i < (threadIdx.x < 4 ? head : m)) {
      const int k = keys[i];
      if ((unsigned)k < (unsigned)num_bins) atomicAdd(&mine[k], 1);
    }
  }
  // the trip condition is the same for the whole block, so every lane
  // reaches the warp votes of count_key
  const long long step = (long long)gridDim.x * kThreads * kVec;
  for (long long base = (long long)blockIdx.x * kThreads * kVec; base < nvec; base += step) {
    int4 x[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long v = base + j * kThreads + threadIdx.x;
      x[j] = v < nvec ? __ldcs(vec + v) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      count_key(h, mine, x[j].x, num_bins);
      count_key(h, mine, x[j].y, num_bins);
      count_key(h, mine, x[j].z, num_bins);
      count_key(h, mine, x[j].w, num_bins);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_bins; b += kThreads) {
      int c = 0;
      for (int q = 0; q < copies; ++q) c += sh[q * stride + b];
      if (c) atomicAdd(&counts[b], c);
    }
  }
}

}  // namespace

extern "C" int pb_histogram(const int* keys, long long m, int* counts,
                            int num_bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || num_bins <= 0) return (int)cudaGetLastError();
  const bool shared = num_bins <= kSmemBins;
  const Copies c = shared ? copies_for(num_bins) : Copies{1, 0};
  const size_t smem = shared ? (size_t)c.n * c.stride * sizeof(int) : 0;
  auto kernel = shared ? histogram_kernel<true> : histogram_kernel<false>;
  long long blocks = (m / 4 + kThreads * kVec - 1) / (kThreads * kVec);
  if (blocks < 1) blocks = 1;
  const int sms = pb_num_sms();
  if (blocks > sms) {  // at most as many blocks as fit the card at once
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    if (blocks > cap) blocks = cap;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(keys, m, counts, num_bins, c.n, c.stride);
  return (int)cudaGetLastError();
}

extern "C" const char* pb_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Fused bin-and-accumulate: one sweep of an (idx, val) stream reduced by
// add, min or max into a dense out[num_indices]; the binned stream is
// never written to device memory.
//
// Replaces: src/repro/kernels/fused.py::cobra_bin_accumulate_pallas. The
// TPU kernel keeps the whole (num_bins, bin_range) accumulator in VMEM
// (up to 32 MiB) and flushes per-bin C-Buffers into it by one-hot
// reductions, across grid steps that run in order. One H100 SM has 227 KB
// of shared memory, so the accumulator cannot live on chip per block.
//
// Bound on the H100: bytes — 8*m bytes of tuples read and 4*n bytes of
// output written. The accumulator is global memory initialised to the
// op's identity by the caller; at the sizes the executor's fused_fits
// admits on the H100 model (4*n <= 25 MiB) it stays in the 50 MB L2, so
// the atomics below resolve in L2 and the HBM traffic is the stream.
//
// Design — the C-Buffer idea on Hopper: each block loads a tile of 2048
// tuples and groups them by bin (idx / bin_range) in shared memory with a
// per-tile counting sort (warp-aggregated slot claims, a cub::BlockScan of
// the bin counts, a scatter into shared arrays). It then flushes the
// grouped tile: each warp reads 32 consecutive grouped tuples, combines
// equal indices with __match_any_sync, and its lowest peer applies one
// atomic per distinct index. Grouping puts the repeats of a hot index in
// one warp, so a skewed stream costs fewer atomics. Beyond kMaxGroupBins
// bins the tile is flushed in stream order.
//
// Float min/max use the order-preserving trick on the raw bits: a
// non-negative float orders as a signed int, a negative one in reverse as
// an unsigned int. NaN is out of scope. Indices outside [0, num_indices),
// negative ones included, are dropped. int32 results and all min/max
// results are exact; a float32 add depends on the order the atomics land.
#include <cub/block/block_scan.cuh>

#include "pb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxGroupBins = 4096;

enum Op { kAdd = 0, kMin = 1, kMax = 2 };

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == kAdd) return a + b;
  if (OP == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

template <int OP>
__device__ __forceinline__ void apply(int* p, int v) {
  if (OP == kAdd) atomicAdd(p, v);
  else if (OP == kMin) atomicMin(p, v);
  else atomicMax(p, v);
}

template <int OP>
__device__ __forceinline__ void apply(float* p, float v) {
  if (OP == kAdd) {
    atomicAdd(p, v);
    return;
  }
  const int bits = __float_as_int(v);
  const bool neg = bits < 0;  // sign bit, so -0.0f takes the negative side
  if (OP == kMin) {
    if (!neg) atomicMin(reinterpret_cast<int*>(p), bits);
    else atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
  } else {
    if (!neg) atomicMax(reinterpret_cast<int*>(p), bits);
    else atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
fused_accumulate_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                        long long m, T* __restrict__ out, int num_indices,
                        int bin_range, int num_bins, bool group) {
  typedef cub::BlockScan<int, kThreads> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_bin[kMaxGroupBins];
  __shared__ int s_idx[kTile];
  __shared__ T s_val[kTile];
  __shared__ int s_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long t0 = (long long)blockIdx.x * kTile;

  int my_idx[kItems];
  T my_val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = t0 + j * kThreads + tid;
    const bool in = i < m;
    const int k = in ? idx[i] : -1;
    my_idx[j] = (in && k >= 0 && k < num_indices) ? k : -1;
    my_val[j] = in ? val[i] : T(0);
  }

  if (group) {
    for (int b = tid; b < num_bins; b += kThreads) s_bin[b] = 0;
    __syncthreads();
    int my_slot[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int b = my_idx[j] >= 0 ? my_idx[j] / bin_range : -1;
      const unsigned peers = __match_any_sync(PB_FULL_MASK, b);
      const int leader = __ffs(peers) - 1;
      int first = 0;
      if (b >= 0 && lane == leader) first = atomicAdd(&s_bin[b], __popc(peers));
      first = __shfl_sync(PB_FULL_MASK, first, leader);
      my_slot[j] = first + __popc(peers & pb_lanemask_lt());
    }
    __syncthreads();
    // bin counts -> bin starts: each thread owns a contiguous run of bins
    const int per = (num_bins + kThreads - 1) / kThreads;
    const int b0 = tid * per < num_bins ? tid * per : num_bins;
    const int b1 = b0 + per < num_bins ? b0 + per : num_bins;
    int local = 0;
    for (int b = b0; b < b1; ++b) local += s_bin[b];
    int run, total;
    Scan(scan_tmp).ExclusiveSum(local, run, total);
    for (int b = b0; b < b1; ++b) {
      const int c = s_bin[b];
      s_bin[b] = run;
      run += c;
    }
    if (tid == 0) s_total = total;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (my_idx[j] >= 0) {
        const int s = s_bin[my_idx[j] / bin_range] + my_slot[j];
        s_idx[s] = my_idx[j];
        s_val[s] = my_val[j];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      s_idx[j * kThreads + tid] = my_idx[j];
      s_val[j * kThreads + tid] = my_val[j];
    }
    if (tid == 0) s_total = m - t0 < kTile ? (int)(m - t0) : kTile;
  }
  __syncthreads();

  const int total = s_total;
  for (int base = (tid & ~31); base < total; base += kThreads) {
    const int j = base + lane;
    const int k = j < total ? s_idx[j] : -1;
    const unsigned peers = __match_any_sync(PB_FULL_MASK, k);
    if (k >= 0 && lane == __ffs(peers) - 1) {
      T acc = s_val[j];
      for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1)
        acc = combine<OP>(acc, s_val[base + __ffs(rest) - 1]);
      apply<OP>(&out[k], acc);
    }
  }
}

template <typename T>
void launch(int op, dim3 grid, cudaStream_t s, const int* idx, const T* val,
            long long m, T* out, int num_indices, int bin_range, int num_bins,
            bool group) {
  if (op == kAdd)
    fused_accumulate_kernel<T, kAdd><<<grid, kThreads, 0, s>>>(
        idx, val, m, out, num_indices, bin_range, num_bins, group);
  else if (op == kMin)
    fused_accumulate_kernel<T, kMin><<<grid, kThreads, 0, s>>>(
        idx, val, m, out, num_indices, bin_range, num_bins, group);
  else
    fused_accumulate_kernel<T, kMax><<<grid, kThreads, 0, s>>>(
        idx, val, m, out, num_indices, bin_range, num_bins, group);
}

}  // namespace

// op: 0 add, 1 min, 2 max. dtype: 0 float32, 1 int32. `out` holds the
// op's identity on entry.
extern "C" int pb_fused_accumulate(const int* idx, const void* val, long long m,
                                   void* out, int num_indices, int bin_range,
                                   int num_bins, int op, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return (int)cudaGetLastError();
  if (op < 0 || op > 2 || dtype < 0 || dtype > 1 || bin_range <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + kTile - 1) / kTile));
  const bool group = num_bins > 1 && num_bins <= kMaxGroupBins;
  if (dtype == 0)
    launch<float>(op, grid, s, idx, static_cast<const float*>(val), m,
                  static_cast<float*>(out), num_indices, bin_range, num_bins, group);
  else
    launch<int>(op, grid, s, idx, static_cast<const int*>(val), m,
                static_cast<int*>(out), num_indices, bin_range, num_bins, group);
  return (int)cudaGetLastError();
}

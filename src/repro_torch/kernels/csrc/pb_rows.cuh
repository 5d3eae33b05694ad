// The row walks of fused_rows.cu: reduce a stream of (m, F) rows,
// row-major, into out[num_out, F] by their indices,
//   out[idx[i], :] op= val[i, :]   for idx[i] in [0, num_out);
// other indices, negative ones included, are dropped. binread.cu takes
// only load_row from here.
//
// A group of `lpr` lanes (a power of two, up to 32) spans one row, each
// lane VEC columns wide (VEC = 4: one 16-byte float32/int32 load or one
// 8-byte bfloat16 load; the caller picks it when F % 4 == 0 and the rows
// are aligned). Row offsets are 64-bit: m * F may exceed 2^31.
//
// Wide rows (lpr >= 8, rows_kernel): each group walks a contiguous chunk
// of kRowChunk rows in stream order and keeps a run of equal indices in
// registers (in TAcc); when the index changes it applies the run with one
// atomic per column. A stream sorted by index costs one atomic per column
// per (chunk, index) pair; any other order is still right, with more
// atomics. Rows wider than lpr * VEC columns are cut into column groups of
// that width, one group per blockIdx.y (at most 65,535 of them; wider
// rows stride over them), each re-reading the (cheap) index chunk: at
// F = 4096 (the MoE combine) a group walking all 32 column groups of its
// chunk in turn would leave 8,192 threads for m = 16,384 rows on a card
// that holds 270,336.
//
// Narrow rows (lpr <= kSegMaxLpr, rows_seg_kernel): one lane a row at
// F = 1, so a group walking 64 rows one after another leaves a chain of
// 64 dependent loads per thread and too few threads to hide it (m / 64
// at m = 2^21 is 32,768 threads on a card that holds 270,336). Instead a
// warp walks a chunk of rows 32 / lpr at a time, every lane loading its
// row's index and columns at once (the next step's loads are issued
// before this step's scan), and runs a segmented inclusive scan by index
// over the step's row slots with shuffles. Only the last slot of a run
// applies it; the run still open at the end of a step is carried in
// registers into the next. Chunks are sized so that the grid holds two
// waves of resident warps. Atomics: one per column per (chunk, run), as
// in the wide walk.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "pb_common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowChunk = 64;

template <int VEC, typename TIn, typename TAcc>
__device__ __forceinline__ void load_row(const TIn* p, TAcc (&v)[VEC]);

template <>
__device__ __forceinline__ void load_row<4, float, float>(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <>
__device__ __forceinline__ void load_row<1, float, float>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_row<4, int, int>(const int* p, int (&v)[4]) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <>
__device__ __forceinline__ void load_row<1, int, int>(const int* p, int (&v)[1]) {
  v[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_row<4, __nv_bfloat16, float>(const __nv_bfloat16* p,
                                                                  float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <>
__device__ __forceinline__ void load_row<1, __nv_bfloat16, float>(const __nv_bfloat16* p,
                                                                  float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

template <typename TIn, typename TAcc, int OP, int VEC>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const int* __restrict__ idx, const TIn* __restrict__ val, long long m, int F,
            TAcc* __restrict__ out, long long num_out, int lpr) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i0 = (t / lpr) * kRowChunk;
  if (i0 >= m) return;
  const long long i1 = i0 + kRowChunk < m ? i0 + kRowChunk : m;
  const int width = lpr * VEC;
  const long long stride = (long long)gridDim.y * width;
  for (long long c0 = (long long)blockIdx.y * width + (t % lpr) * VEC; c0 < F; c0 += stride) {
    long long run = -1;
    TAcc acc[VEC];
    for (long long i = i0; i < i1; ++i) {
      const long long k = __ldg(idx + i);
      if (k < 0 || k >= num_out) continue;
      TAcc v[VEC];
      load_row<VEC>(val + i * F + c0, v);
      if (k == run) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = pb::combine<OP>(acc[j], v[j]);
      } else {
        if (run >= 0) {
          TAcc* o = out + run * F + c0;
#pragma unroll
          for (int j = 0; j < VEC; ++j) pb::apply<OP>(o + j, acc[j]);
        }
        run = k;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = v[j];
      }
    }
    if (run >= 0) {
      TAcc* o = out + run * F + c0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) pb::apply<OP>(o + j, acc[j]);
    }
  }
}

constexpr int kSegMaxLpr = 4;
constexpr int kSegThreads = 256;
constexpr int kSegMaxSteps = 64;

// One step's row slot of the narrow walk: its index (-1 when dropped or
// past the chunk) and this lane's VEC columns.
template <int VEC, typename TIn, typename TAcc>
__device__ __forceinline__ int load_slot(const int* idx, const TIn* val, long long row,
                                         long long end, int F, int c0, long long num_out,
                                         TAcc (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = TAcc(0);
  if (row >= end) return -1;
  const int k = __ldg(idx + row);
  if (k < 0 || k >= num_out) return -1;
  if (c0 < F) load_row<VEC>(val + row * F + c0, v);
  return k;
}

template <typename TIn, typename TAcc, int OP, int VEC, int LPR>
__global__ void __launch_bounds__(kSegThreads)
rows_seg_kernel(const int* __restrict__ idx, const TIn* __restrict__ val, long long m, int F,
                TAcc* __restrict__ out, long long num_out, int steps) {
  constexpr int G = 32 / LPR;  // row slots a step
  const int lane = threadIdx.x & 31;
  const int slot = lane / LPR;
  const int c0 = (lane % LPR) * VEC;
  const long long r0 = (((long long)blockIdx.x * kSegThreads + threadIdx.x) >> 5) * steps * G;
  if (r0 >= m) return;
  const long long end = r0 + (long long)steps * G < m ? r0 + (long long)steps * G : m;
  const bool apply_ok = c0 < F;
  int carry = -1;  // the open run's index, the same in every lane
  TAcc cacc[VEC];  // its columns c0.. (every slot's lanes hold them)
#pragma unroll
  for (int j = 0; j < VEC; ++j) cacc[j] = TAcc(0);
  TAcc v[VEC];
  int key = load_slot<VEC>(idx, val, r0 + slot, end, F, c0, num_out, v);
  for (long long base = r0; base < end; base += G) {
    TAcc nv[VEC];
    const int nkey = load_slot<VEC>(idx, val, base + G + slot, end, F, c0, num_out, nv);
    // segments: runs of equal keys among the slots; `first` is the slot
    // that starts this lane's run
    const int prev = __shfl_up_sync(PB_FULL_MASK, key, LPR);
    const unsigned heads = __ballot_sync(PB_FULL_MASK, slot == 0 || prev != key);
    const int first = (31 - __clz(heads & (PB_FULL_MASK >> (31 - lane)))) / LPR;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const TAcc y = __shfl_up_sync(PB_FULL_MASK, v[j], o * LPR);
        if (slot - o >= first) v[j] = pb::combine<OP>(y, v[j]);
      }
    }
    const int key0 = __shfl_sync(PB_FULL_MASK, key, 0);
    if (carry >= 0) {
      if (carry == key0) {  // the carried run goes on in this step's first run
        if (first == 0) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] = pb::combine<OP>(cacc[j], v[j]);
        }
      } else if (slot == 0 && apply_ok) {
        TAcc* o = out + (long long)carry * F + c0;
#pragma unroll
        for (int j = 0; j < VEC; ++j) pb::apply<OP>(o + j, cacc[j]);
      }
    }
    const int next = __shfl_down_sync(PB_FULL_MASK, key, LPR);
    if (slot < G - 1 && next != key && key >= 0 && apply_ok) {  // a run ends here
      TAcc* o = out + (long long)key * F + c0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) pb::apply<OP>(o + j, v[j]);
    }
    carry = __shfl_sync(PB_FULL_MASK, key, 31);  // the last slot's run stays open
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      cacc[j] = __shfl_sync(PB_FULL_MASK, v[j], (G - 1) * LPR + lane % LPR);
    key = nkey;
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = nv[j];
  }
  if (carry >= 0 && slot == 0 && apply_ok) {
    TAcc* o = out + (long long)carry * F + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) pb::apply<OP>(o + j, cacc[j]);
  }
}

template <typename TIn, typename TAcc, int OP, int VEC, int LPR>
int launch_seg(cudaStream_t s, const int* idx, const TIn* val, long long m, int F, TAcc* out,
               long long num_out) {
  constexpr long long G = 32 / LPR;
  // two waves of resident warps (2048 threads an SM), at most kSegMaxSteps
  // steps a chunk
  const long long waves = 2LL * (2048 / 32) * pb_num_sms();
  long long steps = m / (G * waves);
  steps = steps < 1 ? 1 : steps > kSegMaxSteps ? kSegMaxSteps : steps;
  const long long warps = (m + G * steps - 1) / (G * steps);
  const long long blocks = (warps * 32 + kSegThreads - 1) / kSegThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rows_seg_kernel<TIn, TAcc, OP, VEC, LPR><<<(unsigned)blocks, kSegThreads, 0, s>>>(
      idx, val, m, F, out, num_out, (int)steps);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TAcc, int OP, int VEC>
int launch_seg_lpr(cudaStream_t s, int lpr, const int* idx, const TIn* val, long long m, int F,
                   TAcc* out, long long num_out) {
  if (lpr == 1) return launch_seg<TIn, TAcc, OP, VEC, 1>(s, idx, val, m, F, out, num_out);
  if (lpr == 2) return launch_seg<TIn, TAcc, OP, VEC, 2>(s, idx, val, m, F, out, num_out);
  return launch_seg<TIn, TAcc, OP, VEC, 4>(s, idx, val, m, F, out, num_out);
}

// Launch the row walk on the stream: VEC = 4 when `vec4`, lanes per row
// from F; the narrow walk up to kSegMaxLpr lanes a row, rows_kernel
// above. Returns cudaErrorInvalidValue if the grid would not fit.
template <typename TIn, typename TAcc, int OP>
int launch_rows(cudaStream_t s, const int* idx, const TIn* val, long long m, int F,
                TAcc* out, long long num_out) {
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(val) % (4 * sizeof(TIn)) == 0;
  const int cols = vec4 ? F / 4 : F;
  int lpr = 1;
  while (lpr < cols && lpr < 32) lpr <<= 1;
  if (lpr <= kSegMaxLpr)
    return vec4 ? launch_seg_lpr<TIn, TAcc, OP, 4>(s, lpr, idx, val, m, F, out, num_out)
                : launch_seg_lpr<TIn, TAcc, OP, 1>(s, lpr, idx, val, m, F, out, num_out);
  const long long threads = ((m + kRowChunk - 1) / kRowChunk) * lpr;
  const long long blocks = (threads + kRowThreads - 1) / kRowThreads;
  const int width = lpr * (vec4 ? 4 : 1);
  long long groups = (F + width - 1) / width;  // column groups over blockIdx.y
  groups = groups < 65535 ? groups : 65535;    // wider rows stride over them
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  if (vec4)
    rows_kernel<TIn, TAcc, OP, 4><<<grid, kRowThreads, 0, s>>>(idx, val, m, F, out, num_out, lpr);
  else
    rows_kernel<TIn, TAcc, OP, 1><<<grid, kRowThreads, 0, s>>>(idx, val, m, F, out, num_out, lpr);
  return (int)cudaGetLastError();
}

}  // namespace

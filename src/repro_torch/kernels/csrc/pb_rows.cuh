// The row walk shared by fused_rows.cu and binread.cu: reduce a stream of
// (m, F) rows, row-major, into out[num_out, F] by their indices,
//   out[idx[i], :] op= val[i, :]   for idx[i] in [0, num_out);
// other indices, negative ones included, are dropped.
//
// A group of `lpr` lanes (a power of two, up to 32) spans one row, each
// lane VEC columns wide (VEC = 4: one 16-byte float32/int32 load or one
// 8-byte bfloat16 load; the caller picks it when F % 4 == 0 and the rows
// are aligned). Narrow rows pack several groups into a warp: at F = 1
// every lane is its own group. Each group walks a contiguous chunk of
// kRowChunk rows in stream order and keeps a run of equal indices in
// registers (in TAcc); when the index changes it applies the run with one
// atomic per column. A stream sorted by index costs one atomic per column
// per (chunk, index) pair; any other order is still right, with more
// atomics. Rows wider than lpr * VEC columns are swept in column groups,
// re-reading the (cheap) index chunk. Row offsets are 64-bit: m * F may
// exceed 2^31.
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
  for (int c0 = (int)(t % lpr) * VEC; c0 < F; c0 += width) {
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

// Launch rows_kernel on the stream: VEC = 4 when `vec4`, lanes per row
// from F. Returns cudaErrorInvalidValue if the grid would not fit.
template <typename TIn, typename TAcc, int OP>
int launch_rows(cudaStream_t s, const int* idx, const TIn* val, long long m, int F,
                TAcc* out, long long num_out) {
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(val) % (4 * sizeof(TIn)) == 0;
  const int cols = vec4 ? F / 4 : F;
  int lpr = 1;
  while (lpr < cols && lpr < 32) lpr <<= 1;
  const long long threads = ((m + kRowChunk - 1) / kRowChunk) * lpr;
  const long long blocks = (threads + kRowThreads - 1) / kRowThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec4)
    rows_kernel<TIn, TAcc, OP, 4><<<(unsigned)blocks, kRowThreads, 0, s>>>(idx, val, m, F, out,
                                                                          num_out, lpr);
  else
    rows_kernel<TIn, TAcc, OP, 1><<<(unsigned)blocks, kRowThreads, 0, s>>>(idx, val, m, F, out,
                                                                          num_out, lpr);
  return (int)cudaGetLastError();
}

}  // namespace

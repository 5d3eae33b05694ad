// Shared helpers of the PB kernels (sm_90a). Each kernel source is a
// plain C interface loaded with ctypes by repro_torch/kernels/_lib.py:
// pointers and the stream arrive as void*, sizes as int / long long, and
// every entry returns cudaGetLastError() for the wrapper to check.
#pragma once

#include <cuda_runtime.h>

#define PB_FULL_MASK 0xffffffffu

// Lanes below this one in the warp, as a bit mask.
__device__ __forceinline__ unsigned pb_lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

static inline int pb_num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Reduce ops of the fused kernels (fused.cu, fused_rows.cu): combine two
// values in registers, or apply one to device memory with an atomic.
// Float min/max use the order-preserving trick on the raw bits: a
// non-negative float orders as a signed int, a negative one in reverse
// as an unsigned int. NaN is out of scope.
namespace pb {

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

}  // namespace pb

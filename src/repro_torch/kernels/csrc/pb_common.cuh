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

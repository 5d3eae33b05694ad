// Flash attention forward: softmax(q k^T * hd^-0.5 + mask) v with grouped
// KV heads (query head h reads KV head h / G), an optional causal mask on
// absolute positions counted from 0 for both q and k, and an online
// softmax whose running max, denominator and accumulator stay in f32.
// q/k/v are float32 or bfloat16; the output has q's dtype.
//
// Replaces: src/repro/kernels/flashattn.py::flash_attention_pallas, which
// keeps the (q_block, kv_block) score tile and the running state in VMEM
// so that device memory sees only q, k, v and o. Two differences, both for
// the model's use: any Sq and Skv (the ragged tile is masked; the Pallas
// kernel asserts divisibility, the model's blockwise attention pads), and
// every tensor is read through (batch, head, position) strides with only
// head_dim contiguous, so the model's (B, S, H, hd) activations are read
// in place, without a transpose copy.
//
// Bound on the H100: operations. 4*B*H*Sq*Skv*hd FLOP (half of it under
// the causal mask) over 989 TFLOP/s of bf16 tensor-core math, against
// q + k + v + o read or written once over 3.35 TB/s: at the prefill shape
// of qwen2-1.5b (B 1, H 12, KH 2, S 4096, hd 128) 5.15e10 FLOP, 0.052 ms,
// against 29 MB, 0.009 ms.
//
// Design (simple and right first; the tensor cores wait for a later PR):
// one block of 256 threads per (batch, head, tile of 64 queries). Four
// consecutive lanes share a query: lane t of the four holds the head_dim
// slices [16 i + 4 t, 16 i + 4 t + 4) of q (scaled in f32) and of the
// accumulator, so a 16-byte read of a key row in shared memory feeds four
// FMAs and is broadcast to the eight queries of a warp. Tiles of 64 keys
// and values are staged in shared memory in the input dtype; each tile is
// consumed in chunks of 16 keys: partial dot products, two xor shuffles
// to finish them, the mask, one online-softmax rescale, and the P V
// update with CUDA-core FMAs in f32. Under the causal mask, tiles and
// chunks wholly above the diagonal of the query tile are skipped. Masked
// scores are -1e30 and the running max starts at -1e30, as in the Pallas
// kernel; key 0 is visible to every query, so exp(-1e30 - m) is 0 for
// every masked key.
#include <cuda_bf16.h>

#include "pb_common.cuh"

namespace {

constexpr int kQTile = 64;        // queries per block
constexpr int kKTile = 64;        // keys per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax step
constexpr int kLanesPerQuery = 4;
constexpr int kThreads = kQTile * kLanesPerQuery;
constexpr float kMasked = -1e30f;

struct Strides {
  long long b, h, s;  // in elements; head_dim is contiguous
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Four consecutive values of a shared-memory row, as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage rows [k0, k0 + kKTile) of one (batch, kv head) slice of k or v in
// shared memory with 16-byte loads; rows at or past Skv are zero. The
// wrapper checks that the base pointer and every stride are 16-byte
// multiples.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long stride_s,
                                           long long k0, long long Skv) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  for (int e = threadIdx.x; e < kKTile * kVecPerRow; e += kThreads) {
    const int row = e / kVecPerRow;
    const int col = (e - row * kVecPerRow) * kVec;
    uint4* d = reinterpret_cast<uint4*>(dst + row * HD + col);
    const long long pos = k0 + row;
    *d = pos < Skv ? __ldg(reinterpret_cast<const uint4*>(src + pos * stride_s + col))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int G, long long Sq, long long Skv, bool causal,
                 float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int kPer = HD / kLanesPerQuery;  // head_dim values per lane
  constexpr int kSlices = HD / 16;           // 16-wide slices of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kKTile * HD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / G;
  const long long q0 = (long long)blockIdx.x * kQTile;
  const int t = threadIdx.x % kLanesPerQuery;
  const long long qi = q0 + threadIdx.x / kLanesPerQuery;

  // this lane's slices of the scaled query row (zero past Sq)
  float qr[kPer];
  {
    const T* qp = q + b * qs.b + h * qs.h + qi * qs.s;
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        qr[4 * i + c] = qi < Sq ? to_float(qp[16 * i + 4 * t + c]) * scale : 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int d = 0; d < kPer; ++d) acc[d] = 0.f;
  float m = kMasked, l = 0.f;

  // keys past the last query of this tile are masked for all of it
  const long long q_end = q0 + kQTile < Sq ? q0 + kQTile : Sq;
  const long long kv_end = causal ? (q_end < Skv ? q_end : Skv) : Skv;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;

  for (long long k0 = 0; k0 < kv_end; k0 += kKTile) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, HD>(Ks, kp, ks.s, k0, Skv);
    stage_tile<T, HD>(Vs, vp, vs.s, k0, Skv);
    __syncthreads();
    for (int c0 = 0; c0 < kKTile && k0 + c0 < kv_end; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const T* kr = Ks + (c0 + j) * HD + 4 * t;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kSlices; ++i) {
          const float4 kv = load4(kr + 16 * i);
          a = fmaf(qr[4 * i], kv.x, a);
          a = fmaf(qr[4 * i + 1], kv.y, a);
          a = fmaf(qr[4 * i + 2], kv.z, a);
          a = fmaf(qr[4 * i + 3], kv.w, a);
        }
        s[j] = a;
      }
      float mx = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] += __shfl_xor_sync(PB_FULL_MASK, s[j], 1);
        s[j] += __shfl_xor_sync(PB_FULL_MASK, s[j], 2);
        const long long key = k0 + c0 + j;
        const bool keep = key < Skv && (!causal || key <= qi);
        s[j] = keep ? s[j] : kMasked;
        mx = fmaxf(mx, s[j]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kPer; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - mx);
        l += p;
        const T* vr = Vs + (c0 + j) * HD + 4 * t;
#pragma unroll
        for (int i = 0; i < kSlices; ++i) {
          const float4 vv = load4(vr + 16 * i);
          acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
      m = mx;
    }
  }

  if (qi < Sq) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) from_float(op + 16 * i + 4 * t + c, acc[4 * i + c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
           long long Sq, long long Skv, bool causal, float scale, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  const int smem = 2 * kKTile * HD * (int)sizeof(T);
  auto kernel = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((Sq + kQTile - 1) / kQTile), (unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), G, Sq, Skv, causal, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
                int G, long long Sq, long long Skv, bool causal, float scale, Strides qs,
                Strides ks, Strides vs, Strides os, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, G, Sq, Skv, causal, scale, qs, ks, vs, os, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, G, Sq, Skv, causal, scale, qs, ks, vs, os, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, G, Sq, Skv, causal, scale, qs, ks, vs, os, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, G, Sq, Skv, causal, scale, qs, ks, vs, os, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KH, Skv, hd), o like q, each given by its
// (batch, head, position) strides in elements with hd contiguous.
// dtype: 0 float32, 1 bfloat16 (all four tensors). hd in {16, 32, 64, 128}.
// k and v: 16-byte aligned base pointers and strides.
extern "C" int pb_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int B, int H, int KH, long long Sq, long long Skv,
                                  int hd, int dtype, int causal, float scale,
                                  long long qsb, long long qsh, long long qss,
                                  long long ksb, long long ksh, long long kss,
                                  long long vsb, long long vsh, long long vss,
                                  long long osb, long long osh, long long oss,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (KH <= 0 || H % KH != 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  const int G = H / KH;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, G, Sq, Skv, causal != 0, scale, qs, ks,
                              vs, os, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, G, Sq, Skv, causal != 0, scale,
                                      qs, ks, vs, os, s);
  return (int)cudaErrorInvalidValue;
}

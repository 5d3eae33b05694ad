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
// Which dtype takes which kernel:
//
// - bfloat16 (the model's prefill): flash_fwd_bf16_kernel, on the tensor
//   cores (mma.sync m16n8k16, bf16 inputs, f32 accumulators), below.
// - float32: flash_fwd_f32_kernel, CUDA-core FMAs in f32. TF32 tensor
//   cores would keep 10 bits of each product's inputs, and the float32
//   model is held to its CPU copy within 1e-4 of max |logit|, which TF32
//   products would not hold.
//
// The bf16 kernel (FlashAttention-2's register layout):
//
// - One block of four warps per (batch, head, tile of 64 queries); each
//   warp owns 16 query rows. The grid's x walks the query tiles
//   longest-first across all heads, so that under the causal mask the
//   short tiles near position 0 run last and fill the tail of the grid.
// - The Q tile is copied to shared memory once with cp.async (16 bytes a
//   thread), loaded into mma A-fragments with ldmatrix and kept in
//   registers for the whole loop. The scale hd^-0.5 (times log2 e, for
//   exp2f) is applied to the f32 scores, not to q in bf16.
// - K and V tiles of 64 keys go through a ring of two shared-memory stages
//   filled by cp.async.cg: tile i+1 loads while tile i is multiplied. Rows
//   are stored with their 16-byte chunks XOR-swizzled by the row, so that
//   ldmatrix (K, Q) and ldmatrix.trans (V) read eight rows from eight
//   different bank groups. Rows past Skv (and Q rows past Sq) are filled
//   with zeros by the copy itself (source size 0).
// - S = Q K^T with mma.sync: bf16 x bf16 products are exact in f32, so
//   only the summation order differs from the plain version. Each lane
//   holds two rows' scores; a row's max and sum are finished by two xor
//   shuffles inside the quad of lanes that share the row, and each
//   score's exp2f is computed once, by the lane that holds it. Only the
//   diagonal tile and the ragged tail tile are masked; tiles wholly above
//   the causal diagonal are never loaded. The accumulator is rescaled by
//   alpha once per tile.
// - P V without leaving registers: the C-fragment of S is the A-fragment
//   of P V. The reference multiplies p @ v with p in f32. Rounding p to
//   bf16 (as FlashAttention-2 does) moves an output by up to 2^-9 of
//   sum(p |v|) / l, which exceeds one bf16 step of the output where the
//   values nearly cancel. So p is split into hi = bf16(p) and
//   lo = bf16(p - hi), whose sum is within 2^-17 of p, and each V fragment
//   takes two mma.sync, hi and lo, into the same f32 accumulator: 1.5x
//   FlashAttention-2's tensor-core work (7.7e10 FLOP at the prefill
//   shape). The denominator l is summed from the f32 p, as in the
//   reference.
// - Epilogue: divide by max(l, 1e-30), round once to bf16, store the rows
//   below Sq through the output's strides, as bf16 pairs.
//
// Shared memory at hd 128: Q 16 KB + 2 stages x (K 16 KB + V 16 KB) =
// 80 KB, so two blocks (eight warps) share an SM. Registers allow the same:
// ptxas gives the hd-128 instantiation 255 registers and no spills (the
// swizzled ldmatrix addresses are one per-lane offset XORed with
// constants, see swizzle()). hd 80 (zamba2's heads; 80 = 5 x 16, so the
// k-steps of Q K^T and the dim pairs of P V stay whole) keeps its rows at a
// pitch of 128 elements (row_pitch): ten data chunks of 16 bytes in a row
// of sixteen, the same 80 KB a block. An 80-wide row would need 51,200 B,
// but the XOR of chunks 8 and 9 with the row would then run into the next
// row, and the row term would carry bits into the chunk field.
//
// Masked scores are -1e30 and the running max starts at -1e30, as in the
// Pallas kernel; key 0 is visible to every query, so the exp of a masked
// score against a row's max is 0.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>

#include "pb_common.cuh"

namespace {

constexpr float kMasked = -1e30f;

struct Strides {
  long long b, h, s;  // in elements; head_dim is contiguous
};

// -- float32: CUDA-core FMAs ---------------------------------------------------
//
// One block of 256 threads per (batch, head, tile of 64 queries). Four
// consecutive lanes share a query: lane t of the four holds the head_dim
// slices [16 i + 4 t, 16 i + 4 t + 4) of q (scaled in f32) and of the
// accumulator, so a 16-byte read of a key row in shared memory feeds four
// FMAs and is broadcast to the eight queries of a warp. Tiles of 64 keys
// and values are staged in shared memory; each tile is consumed in chunks
// of 16 keys: partial dot products, two xor shuffles to finish them, the
// mask, one online-softmax rescale, and the P V update. Under the causal
// mask, tiles and chunks wholly above the diagonal are skipped.
namespace f32 {

constexpr int kQTile = 64;        // queries per block
constexpr int kKTile = 64;        // keys per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax step
constexpr int kLanesPerQuery = 4;
constexpr int kThreads = kQTile * kLanesPerQuery;

// Stage rows [k0, k0 + kKTile) of one (batch, kv head) slice of k or v in
// shared memory with 16-byte loads; rows at or past Skv are zero. The
// wrapper checks that the base pointer and every stride are 16-byte
// multiples.
template <int HD>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long stride_s,
                                           long long k0, long long Skv) {
  constexpr int kVecPerRow = HD / 4;
  for (int e = threadIdx.x; e < kKTile * kVecPerRow; e += kThreads) {
    const int row = e / kVecPerRow;
    const int col = (e - row * kVecPerRow) * 4;
    uint4* d = reinterpret_cast<uint4*>(dst + row * HD + col);
    const long long pos = k0 + row;
    *d = pos < Skv ? __ldg(reinterpret_cast<const uint4*>(src + pos * stride_s + col))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int G, long long Sq,
                     long long Skv, bool causal, float scale, Strides qs, Strides ks,
                     Strides vs, Strides os) {
  constexpr int kPer = HD / kLanesPerQuery;  // head_dim values per lane
  constexpr int kSlices = HD / 16;           // 16-wide slices of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kKTile * HD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / G;
  const long long q0 = (long long)blockIdx.x * kQTile;
  const int t = threadIdx.x % kLanesPerQuery;
  const long long qi = q0 + threadIdx.x / kLanesPerQuery;

  // this lane's slices of the scaled query row (zero past Sq)
  float qr[kPer];
  {
    const float* qp = q + b * qs.b + h * qs.h + qi * qs.s;
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) qr[4 * i + c] = qi < Sq ? qp[16 * i + 4 * t + c] * scale : 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int d = 0; d < kPer; ++d) acc[d] = 0.f;
  float m = kMasked, l = 0.f;

  // keys past the last query of this tile are masked for all of it
  const long long q_end = q0 + kQTile < Sq ? q0 + kQTile : Sq;
  const long long kv_end = causal ? (q_end < Skv ? q_end : Skv) : Skv;
  const float* kp = k + b * ks.b + kvh * ks.h;
  const float* vp = v + b * vs.b + kvh * vs.h;

  for (long long k0 = 0; k0 < kv_end; k0 += kKTile) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<HD>(Ks, kp, ks.s, k0, Skv);
    stage_tile<HD>(Vs, vp, vs.s, k0, Skv);
    __syncthreads();
    for (int c0 = 0; c0 < kKTile && k0 + c0 < kv_end; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = Ks + (c0 + j) * HD + 4 * t;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kSlices; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + 16 * i);
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
        const float* vr = Vs + (c0 + j) * HD + 4 * t;
#pragma unroll
        for (int i = 0; i < kSlices; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 16 * i);
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
    float* op = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) op[16 * i + 4 * t + c] = acc[4 * i + c] / den;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
           long long Sq, long long Skv, bool causal, float scale, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  const int smem = 2 * kKTile * HD * (int)sizeof(float);
  auto kernel = flash_fwd_f32_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((Sq + kQTile - 1) / kQTile), (unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), G, Sq, Skv, causal, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bfloat16: tensor cores (see the notes at the top) -------------------------
namespace bf16 {

using T = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;  // queries per block, 16 per warp
constexpr int kKTile = 64;           // keys per stage of the ring
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Elements between the starts of two rows of a tile in shared memory: HD
// rounded up to a power of two, so 128 at HD 80 (ten 16-byte chunks of data
// in a row of sixteen). Every row term below is then a multiple of a power
// of two at least as large as the row's chunk field.
template <int HD>
__host__ __device__ constexpr int row_pitch() {
  int p = 8;
  while (p < HD) p *= 2;
  return p;
}

template <int HD>
constexpr int smem_bytes() {
  return (kQTile + 2 * kStages * kKTile) * row_pitch<HD>() * (int)sizeof(T);
}

// Element offset of 16-byte chunk ``chunk`` of row ``row`` in a tile of
// row_pitch<HD>()-wide rows. The chunk index is XORed with the row's
// position among the rows that share a 128-byte bank line, so that the
// eight rows an ldmatrix phase reads at one logical chunk land on eight
// different bank groups. At a pitch of 64 or more the XOR term is row & 7
// and the pitch holds 8 or 16 chunks: chunk ^ (row & 7) stays inside the
// row's own pitch (at HD 80 chunks 8 and 9 go to 8..15, past the data but
// inside the row), and, a row being a whole number of bank lines, its bank
// group is (chunk & 7) ^ (row & 7): eight rows, eight groups. The XOR term
// depends on the row's low three bits only, and the row term has no bits
// in the chunk field, so for rows 16 i + r and chunks 2 j ^ c (c < 2) the
// offset is 16 i pitch + (swizzle(r, c) ^ (2 j << 3)): one per-lane offset,
// XORed with a constant, serves every fragment (2 j < HD / 8 <= pitch / 8).
template <int HD>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  constexpr int kPitch = row_pitch<HD>();
  constexpr int kChunks = kPitch / 8;                           // per row
  constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;  // rows per 128 bytes
  constexpr int kSpread = kChunks >= 8 ? 8 : kChunks;
  return row * kPitch + ((chunk ^ ((row / kRowsPerLine) & (kSpread - 1))) << 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !valid (source size 0).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b over one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16(x - hi, y - hi):
// hi + lo is within 2^-17 of each value. x - hi is exact in
// f32.
__device__ __forceinline__ void split(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Start copying rows [r0, r0 + 64) of one (batch, head) slice into a
// swizzled tile; rows at or past ``rows`` are zero. Needs a 16-byte aligned
// base and stride.
template <int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride_s, long long r0,
                                          long long rows) {
  constexpr int kChunks = HD / 8;
  static_assert(kKTile == kQTile && kKTile * kChunks % kThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < kKTile * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e / kChunks, chunk = e % kChunks;
    const long long pos = r0 + row;
    const bool valid = pos < rows;
    cp_async16(smem_u32(dst + swizzle<HD>(row, chunk)),
               valid ? src + pos * stride_s + chunk * 8 : src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int H, int G, int num_q_tiles, long long Sq,
                      long long Skv, bool causal, float scale_log2, bool q_vec16, Strides qs,
                      Strides ks, Strides vs, Strides os) {
  constexpr int kK = HD / 16;      // k-steps of Q K^T, and pairs of 8-wide dim tiles of P V
  constexpr int kD = HD / 8;       // 8-wide dim tiles of the accumulator
  constexpr int kN = kKTile / 8;   // 8-key tiles of S
  constexpr int kPitch = row_pitch<HD>();  // elements a shared-memory row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kQTile * kPitch;
  T* Vs = Ks + kStages * kKTile * kPitch;

  const int h = blockIdx.x % H;
  const int tile = num_q_tiles - 1 - (int)(blockIdx.x / H);  // longest first
  const int b = blockIdx.y;
  const int kvh = h / G;
  const long long q0 = (long long)tile * kQTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row and column pair
  const long long row0 = q0 + 16 * warp + g;  // this lane's rows: row0 and row0 + 8

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;

  // keys past the last query of this tile are masked for all of it
  const long long q_end = q0 + kQTile < Sq ? q0 + kQTile : Sq;
  const long long kv_end = causal ? (q_end < Skv ? q_end : Skv) : Skv;
  const int n_tiles = (int)((kv_end + kKTile - 1) / kKTile);

  if (q_vec16) {
    load_tile<HD>(Qs, qp, qs.s, q0, Sq);
  } else {  // q off 16-byte alignment: element loads, once per block
    for (int e = threadIdx.x; e < kQTile * HD; e += kThreads) {
      const int row = e / HD, col = e % HD;
      const long long pos = q0 + row;
      Qs[swizzle<HD>(row, col >> 3) + (col & 7)] =
          pos < Sq ? qp[pos * qs.s + col] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  load_tile<HD>(Ks, kp, ks.s, 0, Skv);
  load_tile<HD>(Vs, vp, vs.s, 0, Skv);
  cp_async_commit();
  cp_async_wait<1>();  // Q is in
  __syncthreads();

  // each lane's row and chunk in the three ldmatrix patterns (see swizzle)
  const int q_lane = swizzle<HD>(lane & 15, lane >> 4);
  const int k_lane = swizzle<HD>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const int v_lane = swizzle<HD>((lane & 7) + (((lane >> 3) & 1) << 3), lane >> 4);
  unsigned qf[kK][4];  // this warp's 16 query rows as A-fragments
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(Qs + 16 * warp * kPitch + (q_lane ^ (2 * kk << 3))));

  float acc[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {kMasked, kMasked};  // running max of rows row0, row0 + 8 (log2 units)
  float l[2] = {0.f, 0.f};          // this lane's share of their denominators

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // the stage consumed in iteration j - 1
      load_tile<HD>(Ks + (stage ^ 1) * kKTile * kPitch, kp, ks.s, (long long)(j + 1) * kKTile, Skv);
      load_tile<HD>(Vs + (stage ^ 1) * kKTile * kPitch, vp, vs.s, (long long)(j + 1) * kKTile, Skv);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile j is in
    __syncthreads();
    const unsigned Kt = smem_u32(Ks + stage * kKTile * kPitch);
    const unsigned Vt = smem_u32(Vs + stage * kKTile * kPitch);

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        unsigned kb[4];
        ldmatrix_x4(kb, Kt + 2 * (16 * np * kPitch + (k_lane ^ (2 * kk << 3))));
        mma(s[2 * np], qf[kk], kb[0], kb[1]);
        mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    const long long k0 = (long long)j * kKTile;
    const bool edge = k0 + kKTile > Skv || (causal && k0 + kKTile - 1 > q0 + 16 * warp);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale_log2;
        if (edge) {
          const long long key = k0 + 8 * n + 2 * t + (e & 1);
          const long long row = row0 + 8 * (e >> 1);
          if (!(key < Skv && (!causal || key <= row))) s[n][e] = kMasked;
        }
      }

    // online softmax: new row max over the quad, rescale, p = exp2(s - max)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(PB_FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(PB_FULL_MASK, mx[r], 2));
      const float alpha = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
        l[e >> 1] += s[n][e];
      }

    // acc += P V, with P as hi + lo bf16 A-fragments (16 keys per k-step)
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      unsigned ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kK; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, Vt + 2 * (16 * kk * kPitch + (v_lane ^ (2 * dp << 3))));
        mma(acc[2 * dp], ph, vb[0], vb[1]);
        mma(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma(acc[2 * dp], pl, vb[0], vb[1]);
        mma(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before iteration j + 1 refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(PB_FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(PB_FULL_MASK, l[r], 2);
    const long long row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* op = o + b * os.b + h * os.h + row * os.s + 2 * t;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * r] / den, acc[d][2 * r + 1] / den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
           long long Sq, long long Skv, bool causal, float scale, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  auto kernel = flash_fwd_bf16_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long num_q_tiles = (Sq + kQTile - 1) / kQTile;
  if (num_q_tiles * H > INT_MAX || B > 65535) return (int)cudaErrorInvalidValue;
  // q and o (B, H, Sq, hd): does every step along an axis longer than 1
  // keep a multiple of ``elems`` elements?
  const auto aligned = [&](const void* p, Strides st, long long elems) {
    return reinterpret_cast<uintptr_t>(p) % (elems * sizeof(T)) == 0 &&
           (B == 1 || st.b % elems == 0) && (H == 1 || st.h % elems == 0) &&
           (Sq == 1 || st.s % elems == 0);
  };
  // o is stored as bf16 pairs. The wrapper allocates it with
  // torch.empty_like(q): a fresh pointer, with q's strides only where q is
  // dense, and then every stride of an axis longer than 1 is a multiple of hd.
  if (!aligned(o, os, 2)) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((unsigned)(num_q_tiles * H), (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, G, (int)num_q_tiles, Sq, Skv, causal, scale * kLog2e,
      aligned(q, qs, 8), qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace bf16

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H,
              int G, long long Sq, long long Skv, bool causal, float scale, Strides qs,
              Strides ks, Strides vs, Strides os, cudaStream_t s) {
  if (dtype == 0) return f32::launch<HD>(q, k, v, o, B, H, G, Sq, Skv, causal, scale, qs, ks, vs, os, s);
  if (dtype == 1) return bf16::launch<HD>(q, k, v, o, B, H, G, Sq, Skv, causal, scale, qs, ks, vs, os, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KH, Skv, hd), o like q, each given by its
// (batch, head, position) strides in elements with hd contiguous.
// dtype: 0 float32, 1 bfloat16 (all four tensors). hd in {16, 32, 64, 80, 128}.
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
  const bool c = causal != 0;
  switch (hd) {
    case 16: return launch_hd<16>(dtype, q, k, v, o, B, H, G, Sq, Skv, c, scale, qs, ks, vs, os, s);
    case 32: return launch_hd<32>(dtype, q, k, v, o, B, H, G, Sq, Skv, c, scale, qs, ks, vs, os, s);
    case 64: return launch_hd<64>(dtype, q, k, v, o, B, H, G, Sq, Skv, c, scale, qs, ks, vs, os, s);
    case 80: return launch_hd<80>(dtype, q, k, v, o, B, H, G, Sq, Skv, c, scale, qs, ks, vs, os, s);
    case 128: return launch_hd<128>(dtype, q, k, v, o, B, H, G, Sq, Skv, c, scale, qs, ks, vs, os, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

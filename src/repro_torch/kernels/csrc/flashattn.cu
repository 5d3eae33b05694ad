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
// - bfloat16 (the model's prefill): flash_fwd_bf16_kernel, Hopper's own
//   tensor-core path (wgmma fed by TMA), below.
// - float32: flash_fwd_f32_kernel, CUDA-core FMAs in f32. TF32 tensor
//   cores would keep 10 bits of each product's inputs, and the float32
//   model is held to its CPU copy within 1e-4 of max |logit|, which TF32
//   products would not hold.
//
// The bf16 kernel (FlashAttention-3's block: a producer warp and consumer
// warpgroups over a ring of shared-memory stages):
//
// - A block is NWG consumer warpgroups of 64 query rows each and one
//   producer warp, for one (batch, head, tile of 64 * NWG queries). NWG is
//   2 (128 queries) unless that grid has fewer blocks than the card has
//   SMs; then 1 (64 queries), and two such blocks share an SM. The grid's
//   x walks the query tiles longest-first across all heads, so that under
//   the causal mask the short tiles near position 0 fill the grid's tail.
// - Loads: one lane of the producer issues every copy as a TMA load of a
//   box of a rank-4 tensor map over (hd, position, head, batch) with the
//   tensor's own strides (cuTensorMapEncodeTiled, reached through the
//   runtime's driver entry point, so nothing links libcuda). Q is loaded
//   once; K and V tiles of 64 keys go through a ring of up to four
//   stages, each with a "full" mbarrier for K, one for V (TMA counts its
//   bytes in) and an "empty" one (every consumer warp arrives when it has
//   read the stage). Rows past Sq and Skv are zeros from TMA's out-of-bounds fill;
//   tiles wholly above the causal diagonal are never loaded (the producer
//   and the consumers count the same n_tiles).
// - Registers: an SM's 65,536 are four files of 16,384, one for each
//   quarter of its warps, so a block of 9 or 12 warps, or two of 5, gives
//   a thread at most 168, and two of 8 at most 128. The producer is one
//   warp, not a warpgroup whose registers setmaxnreg hands to the
//   consumers: built that way (24 for the producer, 240 or 232 for a
//   consumer), ptxas still compiled the consumers to 168 or 128 (nvcc -v),
//   and the 64-query block, two of 8 warps an SM, spilled. The 64-key tile
//   keeps a consumer's live set (S, the accumulator, the previous tile's
//   P in hi and lo) at or below 128 registers: 101 to 155 in use, and no
//   instantiation spills.
// - A row's head_dim is cut into parts of 64 columns and a rest (hd 80:
//   64 + 16; hd 128: 64 + 64), each its own TMA box and shared-memory
//   region whose rows are exactly the box's swizzle span (128, 64 or 32
//   bytes), so that TMA's swizzle is the layout wgmma's descriptors name.
// - S = Q K^T: wgmma m64n64k16 with A (this warpgroup's 64 rows of Q) and
//   B (the K tile) both read from shared memory, K-major, one k-step of 16
//   columns at a time (a descriptor's start advances 32 bytes inside a
//   swizzle atom); f32 scores. bf16 x bf16 products are exact in f32.
// - Online softmax on the accumulator fragments: each lane holds two rows'
//   scores; a row's max and sum are finished by two xor shuffles inside
//   the quad of lanes that share it, and each p = exp2(s * scale - max *
//   scale), scale = hd^-0.5 * log2 e, is one FFMA and one exp2, computed
//   by the lane that holds its score. Only the diagonal tile and the
//   ragged tail tile are masked (-1e30): TMA's zero rows past Skv would
//   otherwise score 0. The accumulator is rescaled once a tile.
// - P V by wgmma with A from registers: the score fragments are the A
//   fragments, so P never leaves registers, and B is the V tile read
//   MN-major (transposed) from shared memory. The reference multiplies
//   p @ v with p in f32. Rounding p to bf16 (as FlashAttention-2 and -3
//   do) moves an output by up to 2^-9 of sum(p |v|) / l, which exceeds one
//   bf16 step of the output where the values nearly cancel. So p is split
//   into hi = bf16(p) and lo = bf16(p - hi), whose sum is within 2^-17 of
//   p, and each 16-key step takes two wgmma, hi and lo, into the same f32
//   accumulator: 1.5x FlashAttention-2's tensor-core work. The denominator
//   l is summed from the f32 p, as in the reference.
// - Overlap inside a warpgroup: tile j's Q K^T is issued, then tile j-1's
//   P V; the softmax of tile j runs while P V is on the tensor cores, and
//   tile j-1's stage goes back to the producer once P V has retired
//   (wgmma.wait_group), after which the accumulator is rescaled and tile
//   j's P split. Two warpgroups (or two blocks) an SM overlap each other's
//   softmax and products besides.
// - Epilogue: scale by 1 / max(l, 1e-30), round once to bf16, store the
//   rows below Sq through the output's strides, as bf16 pairs.
//
// Masked scores are -1e30 and the running max starts at -1e30, as in the
// Pallas kernel; key 0 is visible to every query, so the exp of a masked
// score against a row's max is 0.
#include <climits>
#include <cstdint>

#include <cuda.h>
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

// -- bfloat16: wgmma fed by TMA (see the notes at the top) ----------------------
namespace bf16 {

using T = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// A row's head_dim in parts: 64 columns (128 bytes, the widest TMA swizzle),
// then the rest. Each part is its own TMA box and shared-memory region, and
// its row is exactly its swizzle span: hd 16, 32, 64 one part of 32, 64, 128
// bytes; hd 80 64 + 16 columns (128- and 32-byte swizzles); hd 128 64 + 64.
template <int HD>
struct Cols {
  static constexpr int kParts = (HD + 63) / 64;
  static constexpr int kMaps = HD > 64 && HD % 64 ? 2 : 1;  // box shapes, so tensor maps a tensor
  __host__ __device__ static constexpr int width(int p) {
    return HD - 64 * p < 64 ? HD - 64 * p : 64;
  }
  // bytes of a row of part p
  __host__ __device__ static constexpr int span(int p) { return 2 * width(p); }
  __host__ __device__ static constexpr int map(int p) { return kMaps == 2 ? p : 0; }
  // byte offset of part p in a tile of R rows (the parts before it are 64 wide)
  __host__ __device__ static constexpr int offset(int R, int p) { return R * 128 * p; }
};

// One instantiation's block: NWG consumer warpgroups of 64 query rows and
// the producer warp after them; K/V stages of 64 keys, as many (up to four)
// as shared memory holds, with two 64-query blocks an SM. Shared memory: Q,
// then each stage's K and V tile, then the barriers (every region a
// multiple of 1024 bytes, the 128-byte swizzle's period, from a
// 1024-aligned base).
template <int HD, int NWG>
struct Geo {
  static constexpr int kRows = 64 * NWG;
  static constexpr int kKeys = 64;
  static constexpr int kThreads = 128 * NWG + 32;
  static constexpr int kBlocksPerSM = NWG == 1 ? 2 : 1;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kKVBytes = kKeys * HD * 2;  // one K or V tile
  static constexpr int smem(int stages) {  // + 8 a barrier: Q; full K, full V, empty a stage
    return kQBytes + 2 * stages * kKVBytes + 8 * (1 + 3 * stages) + 1024;
  }
  static constexpr bool fits(int stages) {  // 1 KB of an SM's 228 KB is reserved a block
    return smem(stages) <= 232448 && kBlocksPerSM * (smem(stages) + 1024) <= 233472;
  }
  static constexpr int kStages = fits(4) ? 4 : fits(3) ? 3 : 2;
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = smem(kStages);
};

// The tensor maps of q, k and v, one a box shape (Cols::kMaps).
template <int M>
struct Maps {
  CUtensorMap q[M], k[M], v[M];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive on ``bar`` and add ``bytes`` to the bytes its phase waits for.
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of ``bar`` with this parity has completed. Every wait
// is on the block's own producer or consumers, so one that lasts 10 s is a
// fault of the kernel's bookkeeping: trap, and the launch fails instead of
// hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!bar_try(bar, parity))
    if (globaltimer() - t0 > 10000000000ull) __trap();
}

// TMA: the box at (c0, c1, c2, c3) of ``map`` into shared memory at ``dst``;
// its bytes complete on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler takes a wgmma's registers as read and written when the
// instruction issues; these keep them live, in place, until after the wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units), and the layout of rows of ``span``
// bytes swizzled as TMA stored them (128 B: 1, 64 B: 2, 32 B: 3). K-major
// (Q and K in Q K^T): SBO steps between 8-row groups; LBO is unused. MN-major
// (V in P V): SBO steps between groups of 8 keys, LBO between 64-column parts.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int span) {
  const uint64_t mode = span == 128 ? 1 : span == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | mode << 62;
}

// d (m64n64k16, f32) {=, +=} a b, A and B K-major in shared memory.
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(ScaleD));
}

// d (m64n16k16, f32) += a b, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n32k16, f32) += a b, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n64k16, f32) += a b, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128k16, f32) += a b, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S (+)= Q K^T over part P's k-steps of 16 columns, from ``q`` (this
// warpgroup's 64 rows of the part) and ``k`` (the stage's K tile of the
// part); the first k-step of part 0 overwrites S.
template <int HD, int P, int N>
__device__ __forceinline__ void qk_part(float (&s)[N / 2], uint32_t q, uint32_t k) {
  constexpr int kSpan = Cols<HD>::span(P);
#pragma unroll
  for (int kk = 0; kk < Cols<HD>::width(P) / 16; ++kk) {
    const uint64_t da = desc(q + 32 * kk, 16, 8 * kSpan, kSpan);
    const uint64_t db = desc(k + 32 * kk, 16, 8 * kSpan, kSpan);
    if (P == 0 && kk == 0)
      wgmma_ss<0>(s, da, db);
    else
      wgmma_ss<1>(s, da, db);
  }
}

// acc += (hi + lo) V over the stage's N keys, 16 a k-step, for the columns
// of part P (its registers start at acc[32 P]); at hd 128 both parts at
// once (m64n128, LBO stepping to the second part).
template <int HD, int P, int N>
__device__ __forceinline__ void pv_part(float (&acc)[HD / 2], const uint32_t (&ph)[N / 16][4],
                                        const uint32_t (&pl)[N / 16][4], uint32_t v) {
  constexpr int kSpan = Cols<HD>::span(P);
  constexpr int kW = HD == 128 ? 128 : Cols<HD>::width(P);
  constexpr uint32_t kLbo = HD == 128 ? Cols<HD>::offset(N, 1) : 16;
  float(&d)[kW / 2] = *reinterpret_cast<float(*)[kW / 2]>(&acc[32 * P]);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t dv = desc(v + 16 * kk * kSpan, kLbo, 8 * kSpan, kSpan);
    wgmma_rs(d, ph[kk], dv);
    wgmma_rs(d, pl[kk], dv);
  }
}

// acc += (hi + lo) V over all of the head's columns.
template <int HD, int N>
__device__ __forceinline__ void pv(float (&acc)[HD / 2], const uint32_t (&ph)[N / 16][4],
                                   const uint32_t (&pl)[N / 16][4], uint32_t v) {
  pv_part<HD, 0, N>(acc, ph, pl, v);
  if constexpr (Cols<HD>::kParts == 2 && HD != 128)
    pv_part<HD, 1, N>(acc, ph, pl, v + Cols<HD>::offset(N, 1));
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16(x - hi, y - hi):
// hi + lo is within 2^-17 of each value. x - hi is exact in f32.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S = Q K^T for this warpgroup's 64 rows (parts at q0 and q1) and the
// stage's K tile at ``k``.
template <int HD, int N>
__device__ __forceinline__ void qk(float (&s)[N / 2], uint32_t q0, uint32_t q1, uint32_t k) {
  qk_part<HD, 0, N>(s, q0, k);
  if constexpr (Cols<HD>::kParts == 2) qk_part<HD, 1, N>(s, q1, k + Cols<HD>::offset(N, 1));
}

// The scores s of the N keys from k0 on, for this lane's rows row0 and
// row0 + 8 (``t``: its column pair): mask them where the tile is an edge
// (past Skv, or past the diagonal of the warpgroup's first row q_first),
// take the new row max m over the quad, and replace each score by
// p = exp2(s * scale - max * scale); ``alpha`` rescales the rows' earlier
// sums, ``sum`` is this lane's share of the tile's.
template <int N>
__device__ __forceinline__ void softmax(float (&s)[N / 2], float (&m)[2], float (&alpha)[2],
                                        float (&sum)[2], int k0, int q_first, int row0, int t,
                                        int Skv, bool causal, float scale_log2) {
  if (k0 + N > Skv || (causal && k0 + N - 1 > q_first)) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (!(key < Skv && (!causal || key <= row))) s[i] = kMasked;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(PB_FULL_MASK, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(PB_FULL_MASK, mx[r], 2));
    alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    mx[r] *= scale_log2;
    sum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = exp2f(fmaf(s[i], scale_log2, -mx[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
}

// P (in s) as A-fragments of P V, split into hi and lo: the score
// fragment's 8-key chunks 2 kk and 2 kk + 1 are k-step kk's registers,
// (row g | g + 8) x (keys 2t | 8 + 2t).
template <int N>
__device__ __forceinline__ void to_fragments(const float (&s)[N / 2], uint32_t (&ph)[N / 16][4],
                                             uint32_t (&pl)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 2 * kk + (i >> 1), e = 2 * (i & 1);
      split(s[4 * c + e], s[4 * c + e + 1], ph[kk][i], pl[kk][i]);
    }
}

template <int HD, int NWG>
__global__ void __launch_bounds__(Geo<HD, NWG>::kThreads, Geo<HD, NWG>::kBlocksPerSM)
flash_fwd_bf16_kernel(const __grid_constant__ Maps<Cols<HD>::kMaps> maps, T* __restrict__ o,
                      int H, int G, int num_q_tiles, int Sq, int Skv, bool causal,
                      float scale_log2, Strides os) {
  using C = Cols<HD>;
  using Gm = Geo<HD, NWG>;
  constexpr int kRows = Gm::kRows, kKeys = Gm::kKeys, kStages = Gm::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + Gm::kBarOff;  // Q, then full K, full V and empty of each stage
  const auto k_tile = [&](int s) { return base + Gm::kQBytes + 2 * s * Gm::kKVBytes; };
  const auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  const auto full_v = [&](int s) { return bars + 8 * (1 + kStages + s); };
  const auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int h = blockIdx.x % H;
  const int tile = num_q_tiles - 1 - (int)(blockIdx.x / H);  // longest first
  const int b = blockIdx.y;
  const int q0 = tile * kRows;
  // keys past the last query of this tile are masked for all of it
  const int q_end = min(q0 + kRows, Sq);
  const int kv_end = causal ? min(q_end, Skv) : Skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    bar_init(bars, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      bar_init(full_k(s), 1);
      bar_init(full_v(s), 1);
      bar_init(empty(s), 4 * NWG);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * NWG) {  // the producer warp: one lane issues every load
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < C::kMaps; ++m) {
        prefetch_map(&maps.q[m]);
        prefetch_map(&maps.k[m]);
        prefetch_map(&maps.v[m]);
      }
      bar_expect(bars, Gm::kQBytes);
#pragma unroll
      for (int p = 0; p < C::kParts; ++p)
        tma_load(base + C::offset(kRows, p), &maps.q[C::map(p)], 64 * p, q0, h, b, bars);
      const int kvh = h / G;
      int s = 0;
      uint32_t phase = 1;  // the first round finds every stage free
      for (int k0 = 0; k0 < n_tiles * kKeys; k0 += kKeys) {
        bar_wait(empty(s), phase);
        bar_expect(full_k(s), Gm::kKVBytes);
#pragma unroll
        for (int p = 0; p < C::kParts; ++p)
          tma_load(k_tile(s) + C::offset(kKeys, p), &maps.k[C::map(p)], 64 * p, k0, kvh, b,
                   full_k(s));
        bar_expect(full_v(s), Gm::kKVBytes);
#pragma unroll
        for (int p = 0; p < C::kParts; ++p)
          tma_load(k_tile(s) + Gm::kKVBytes + C::offset(kKeys, p), &maps.v[C::map(p)], 64 * p, k0,
                   kvh, b, full_v(s));
        if (++s == kStages) s = 0, phase ^= 1;
      }
    }
  } else {  // a consumer warpgroup: 64 query rows
    const int cw = warp / 4;
    const int g = lane / 4, t = lane % 4;         // accumulator fragment row and column pair
    const int row0 = q0 + 64 * cw + 16 * (warp % 4) + g;  // this lane's rows: row0, row0 + 8
    // this warpgroup's rows of Q, part by part
    const uint32_t q_p0 = base + C::offset(kRows, 0) + 64 * cw * C::span(0);
    const uint32_t q_p1 = base + C::offset(kRows, 1) + 64 * cw * C::span(C::kParts - 1);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMasked, kMasked};  // running max of rows row0, row0 + 8 (raw scores)
    float l[2] = {0.f, 0.f};          // this lane's share of their denominators
    uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];  // the previous tile's P, hi and lo
    float sc[kKeys / 2];
    float alpha[2], sum[2];
    const int q_first = q0 + 64 * cw;  // this warpgroup's first row
    bar_wait(bars, 0);

    // tile 0: S, then its softmax (the accumulator is still zero)
    bar_wait(full_k(0), 0);
    keep(sc);
    wgmma_fence();
    qk<HD, kKeys>(sc, q_p0, q_p1, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    keep(sc);
    softmax<kKeys>(sc, m, alpha, sum, 0, q_first, row0, t, Skv, causal, scale_log2);
    l[0] = sum[0], l[1] = sum[1];
    to_fragments<kKeys>(sc, ph, pl);

    // Tile j: issue S = Q K_j^T, then the previous tile's acc += P V_{j-1};
    // the softmax of S runs while P V is on the tensor cores, and acc is
    // rescaled once P V has retired, which frees the previous stage.
    int sp = 0, s = 1;  // the previous tile's stage and this tile's, and their phases
    uint32_t pphase = 0, phase = 0;
    for (int k0 = kKeys; k0 < n_tiles * kKeys; k0 += kKeys) {
      bar_wait(full_k(s), phase);
      keep(sc);
      keep(acc);
      keep(ph);
      keep(pl);
      wgmma_fence();
      qk<HD, kKeys>(sc, q_p0, q_p1, k_tile(s));
      wgmma_commit();
      bar_wait(full_v(sp), pphase);
      pv<HD, kKeys>(acc, ph, pl, k_tile(sp) + Gm::kKVBytes);
      wgmma_commit();
      wgmma_wait<1>();
      keep(sc);
      softmax<kKeys>(sc, m, alpha, sum, k0, q_first, row0, t, Skv, causal, scale_log2);
      wgmma_wait<0>();
      keep(acc);
      keep(ph);
      keep(pl);
      if (lane == 0) bar_arrive(empty(sp));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          acc[4 * c + 2 * r] *= alpha[r];
          acc[4 * c + 2 * r + 1] *= alpha[r];
        }
      }
      to_fragments<kKeys>(sc, ph, pl);
      sp = s, pphase = phase;
      if (++s == kStages) s = 0, phase ^= 1;
    }

    // the last tile's P V
    bar_wait(full_v(sp), pphase);
    keep(acc);
    keep(ph);
    keep(pl);
    wgmma_fence();
    pv<HD, kKeys>(acc, ph, pl, k_tile(sp) + Gm::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    keep(acc);
    keep(ph);
    keep(pl);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(PB_FULL_MASK, l[r], 1);
      l[r] += __shfl_xor_sync(PB_FULL_MASK, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      T* op = o + b * os.b + h * os.h + row * os.s + 2 * t;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * c) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda on the link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-4 map over (hd, position, head, batch) of a bf16 tensor, with the
// tensor's own strides (an axis of extent 1 takes a nominal 16 bytes), for
// boxes of ``cols`` x ``rows`` swizzled at their row's span (cols * 2 bytes);
// zeros past the ends.
bool make_map(CUtensorMap* map, const void* ptr, int hd, long long n, long long heads,
              long long batch, Strides st, int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const auto stride = [](long long s, long long extent) -> cuuint64_t {
    return extent > 1 ? (cuuint64_t)s * sizeof(T) : 16;
  };
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {stride(st.s, n), stride(st.h, heads), stride(st.b, batch)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int HD, int NWG>
int launch_block(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
                 int Sq, int Skv, bool causal, float scale, Strides qs, Strides ks, Strides vs,
                 Strides os, cudaStream_t stream) {
  using C = Cols<HD>;
  using Gm = Geo<HD, NWG>;
  Maps<C::kMaps> maps;
  for (int m = 0; m < C::kMaps; ++m)  // map m serves part m (hd 80), or every part
    if (!make_map(&maps.q[m], q, HD, Sq, H, B, qs, C::width(m), Gm::kRows) ||
        !make_map(&maps.k[m], k, HD, Skv, KH, B, ks, C::width(m), Gm::kKeys) ||
        !make_map(&maps.v[m], v, HD, Skv, KH, B, vs, C::width(m), Gm::kKeys))
      return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16_kernel<HD, NWG>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long num_q_tiles = (Sq + Gm::kRows - 1) / Gm::kRows;
  if (num_q_tiles * H > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(num_q_tiles * H), (unsigned)B);
  kernel<<<grid, Gm::kThreads, Gm::kSmem, stream>>>(maps, static_cast<T*>(o), H, H / KH,
                                                     (int)num_q_tiles, Sq, Skv, causal,
                                                     scale * kLog2e, os);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
           long long Sq, long long Skv, bool causal, float scale, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  if (Sq > INT_MAX || Skv > INT_MAX || B > 65535) return (int)cudaErrorInvalidValue;
  // o is stored as bf16 pairs. The wrapper allocates it with
  // torch.empty_like(q): a fresh pointer, with q's strides only where q is
  // dense, and then every stride of an axis longer than 1 is a multiple of hd.
  if (reinterpret_cast<uintptr_t>(o) % 4 || (B > 1 && os.b % 2) || (H > 1 && os.h % 2) ||
      (Sq > 1 && os.s % 2))
    return (int)cudaErrorMisalignedAddress;
  // 128 queries a block, unless that leaves SMs without a block
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int KH = H / G;
  if ((Sq + 127) / 128 * H * B >= sms)
    return launch_block<HD, 2>(q, k, v, o, B, H, KH, (int)Sq, (int)Skv, causal, scale, qs, ks,
                               vs, os, stream);
  return launch_block<HD, 1>(q, k, v, o, B, H, KH, (int)Sq, (int)Skv, causal, scale, qs, ks, vs,
                             os, stream);
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
// k and v (and q in bfloat16, read by TMA): 16-byte aligned base pointers
// and strides (an axis of extent 1 excepted).
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

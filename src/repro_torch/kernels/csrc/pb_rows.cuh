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
// Wide rows (lpr >= 8: F >= 17, or F >= 5 when not 16-byte rows;
// rows_tile_kernel, "tile" in fused.py's rows_design): a block of 256
// threads takes a tile of kTileRows consecutive rows of the stream.
// - Staged indices: each thread loads kTileItems of the tile's indices
//   once; a dropped index gets the key num_out, which sorts after every
//   kept one. Every column slice the block covers reuses the staged list,
//   so the indices are read once per (tile, column group), not once per
//   lane group, and no row's load waits on its index load.
// - Runs across the tile: if the staged keys are already non-decreasing
//   (a destination-sorted stream, the MoE combine's token runs) the list
//   stays in stream order; otherwise a stable cub::BlockRadixSort over
//   the key's bits groups the (key, position) pairs, so repeated
//   destinations anywhere in the tile combine before any atomic. The
//   choice is made from the tile alone. Run heads become a bit mask
//   (one ballot per 32 slots); the kept entries are the first n slots.
// - Walkers: a group of lpr lanes spans one slice of lpr * VEC columns
//   (VEC = 4: 16-byte float32/int32 or 8-byte bfloat16 loads). A slice's
//   n entries are cut into P segments (P = walkers / slices in the
//   block, at least 1), each starting at the first run head of its window
//   of n / P slots, so a run shorter than the window is never cut; a
//   longer one (a hub) is cut at most once a window and so still spreads
//   over the walkers. A walker gathers kTileUnroll rows (independent
//   loads, issued together) before folding them into its run in
//   registers. The pieces of a cut run meet in shared memory: a segment
//   that starts inside a run leaves its first piece there, and the
//   walker whose segment holds the run's head adds them (after a block
//   barrier) and applies the run once.
// - Apply: one atomic per (tile, run) and group of VEC columns: a float32
//   add of 4 columns is one atomicAdd on a float4 (REDG.E.ADD.F32x4 on
//   sm_90a); int32 add, min and max keep pb_common.cuh's scalar
//   atomics. A run that crosses a tile boundary is applied once by each
//   tile, which is still right.
// - Column groups: where the tiles alone would leave the card short of
//   kTileBlocksPerSm blocks an SM (the embedding backward: 16,384 rows;
//   the MoE combine: 7,776), the slices are split over blockIdx.y, each
//   block restaging the tile's indices (cheap: 4 bytes a row against
//   lpr * VEC * 4 a slice). A block takes spb consecutive slices, so
//   the groups never pass kTileBlocksPerSm * SMs, however wide the row.
// Any stream order gives the right result; a sorted stream costs one
// atomic per column group per (tile, destination).
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
// waves of resident warps. Atomics: one per column per (chunk, run).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cub/block/block_radix_sort.cuh>
#include <cuda_bf16.h>

#include "pb_common.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileItems = 2;  // indices a thread stages
constexpr int kTileRows = kTileThreads * kTileItems;
constexpr int kTileUnroll = 4;  // rows a lane loads before folding them
constexpr int kTileBlocksPerSm = 8;  // below this many tiles an SM, split the columns

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

// Apply a run's VEC columns at o: one float4 reduction for a float32 add
// of 4 columns, else one scalar atomic a column.
template <int OP, int VEC, typename TAcc>
__device__ __forceinline__ void apply_cols(TAcc* o, const TAcc (&a)[VEC]) {
  if constexpr (OP == pb::kAdd && VEC == 4 && std::is_same<TAcc, float>::value) {
    atomicAdd(reinterpret_cast<float4*>(o), make_float4(a[0], a[1], a[2], a[3]));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) pb::apply<OP>(o + j, a[j]);
  }
}

// The first slot of segment `seg` (windows of L slots over the n kept
// ones): the first run head inside its window, or the window's start when
// a run covers the whole window; n past the end.
__device__ __forceinline__ int seg_start(const unsigned* heads, int seg, int L, int n) {
  const int a = seg * L;
  if (a >= n) return n;
  if (seg == 0) return 0;
  const int c = a + L < n ? a + L : n;
  for (int w = a >> 5; w <= (c - 1) >> 5; ++w) {
    unsigned bits = heads[w];
    if (w == a >> 5) bits &= ~0u << (a & 31);
    const int hi = c - 32 * w;  // slots of this word below c
    if (hi < 32) bits &= (1u << hi) - 1;
    if (bits) return 32 * w + __ffs(bits) - 1;
  }
  return a;
}

// One walker's segment [b, e) of the staged list at one slice: vrow is the
// tile's first row at this lane's columns, ocol the output's. Every run
// is applied but two: where the segment starts inside a run (`open_lo`),
// its first piece goes to `piece` (this lane's slots in shared memory) for
// the run's owner; where the next segment does (`open_hi`), the last run
// stays in `a`. Returns 1 if the segment owns that last run (it began
// here), 2 if the whole segment is one piece passed on, else 0.
template <int OP, int VEC, typename TIn, typename TAcc>
__device__ __forceinline__ int walk_runs(const unsigned* key, const int* pos, int b, int e,
                                         bool open_lo, bool open_hi, const TIn* vrow,
                                         long long F, TAcc* ocol, TAcc (&a)[VEC],
                                         TAcc* piece) {
  int cur = -1;
  bool first = true;
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] = TAcc(0);
  for (int j0 = b; j0 < e; j0 += kTileUnroll) {
    TAcc v[kTileUnroll][VEC];
    int kk[kTileUnroll];
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      const int j = j0 + u;
      kk[u] = j < e ? (int)key[j] : -1;
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[u][c] = TAcc(0);
      if (kk[u] >= 0) load_row<VEC>(vrow + (long long)pos[j] * F, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      if (kk[u] < 0) break;  // past the segment
      if (kk[u] == cur) {
#pragma unroll
        for (int c = 0; c < VEC; ++c) a[c] = pb::combine<OP>(a[c], v[u][c]);
      } else {
        if (cur >= 0) {
          if (first && open_lo) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) piece[c] = a[c];
          } else {
            apply_cols<OP, VEC>(ocol + (long long)cur * F, a);
          }
          first = false;
        }
        cur = kk[u];
#pragma unroll
        for (int c = 0; c < VEC; ++c) a[c] = v[u][c];
      }
    }
  }
  if (cur < 0) return 0;
  if (first && open_lo) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) piece[c] = a[c];
    return open_hi ? 2 : 0;
  }
  if (open_hi) return 1;
  apply_cols<OP, VEC>(ocol + (long long)cur * F, a);
  return 0;
}

// lpr = 1 << lpr_log lanes a row; the row's `slices` slices of lpr * VEC
// columns go in groups of `spb` to blockIdx.y.
template <typename TIn, typename TAcc, int OP, int VEC>
__global__ void __launch_bounds__(kTileThreads)
rows_tile_kernel(const int* __restrict__ idx, const TIn* __restrict__ val, long long m, int F,
                 TAcc* __restrict__ out, int num_out, int key_bits, int lpr_log,
                 long long slices, int spb) {
  typedef cub::BlockRadixSort<unsigned, kTileThreads, kTileItems, int> Sort;
  struct Staged {
    unsigned key[kTileRows];
    int pos[kTileRows];
  };
  __shared__ union {
    typename Sort::TempStorage sort;
    Staged st;
  } sh;
  __shared__ unsigned s_edge[kTileThreads];   // each thread's last staged key
  __shared__ unsigned s_head[kTileRows / 32];  // run heads of the staged list, a bit a slot
  __shared__ int s_n;                          // kept slots: the list's first n
  __shared__ TAcc s_piece[kTileThreads][VEC];  // each lane's piece of a run begun before
  __shared__ bool s_through[kTileThreads];     // a walker's segment is one piece passed on

  const long long row0 = (long long)blockIdx.x * kTileRows;
  const unsigned drop = (unsigned)num_out;  // a dropped index's key: sorts after the kept
  unsigned k[kTileItems];
  int p[kTileItems];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int q = threadIdx.x * kTileItems + j;  // blocked: stream order
    p[j] = q;
    k[j] = drop;
    if (row0 + q < m) {
      const int x = __ldg(idx + row0 + q);
      if (x >= 0 && x < num_out) {
        k[j] = (unsigned)x;
        any = true;
      }
    }
  }
  bool ordered = true;  // this thread's keys non-decreasing, and after the previous thread's
#pragma unroll
  for (int j = 1; j < kTileItems; ++j) ordered &= k[j - 1] <= k[j];
  s_edge[threadIdx.x] = k[kTileItems - 1];
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if (threadIdx.x > 0) ordered &= s_edge[threadIdx.x - 1] <= k[0];
  if (!__syncthreads_or(any)) return;  // every index of the tile dropped
  if (!__syncthreads_and(ordered)) {
    Sort(sh.sort).Sort(k, p, 0, key_bits);  // stable: equal keys keep stream order
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    sh.st.key[threadIdx.x * kTileItems + j] = k[j];
    sh.st.pos[threadIdx.x * kTileItems + j] = p[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {  // n: the slot after the last kept one
    const int q = threadIdx.x * kTileItems + j;
    if (k[j] != drop && (q + 1 == kTileRows || sh.st.key[q + 1] == drop)) s_n = q + 1;
  }
  // striped, so that a warp's ballot covers 32 consecutive slots
  for (int q = threadIdx.x; q < kTileRows; q += kTileThreads) {
    const unsigned key = sh.st.key[q];
    const bool head = key != drop && (q == 0 || sh.st.key[q - 1] != key);
    const unsigned word = __ballot_sync(PB_FULL_MASK, head);
    if ((threadIdx.x & 31) == 0) s_head[q >> 5] = word;
  }
  __syncthreads();
  const int n = s_n;

  const int lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_log;
  const int walkers = kTileWarps * (32 >> lpr_log);
  const int walker = (threadIdx.x >> 5) * (32 >> lpr_log) + (lane >> lpr_log);
  const long long width = (long long)lpr * VEC;  // a slice's columns
  const int cl = (lane & (lpr - 1)) * VEC;       // this lane's first column in its slice
  const long long s0 = (long long)blockIdx.y * spb;  // this block's first slice
  const int ns = (int)(slices - s0 < spb ? slices - s0 : spb);
  const int P = ns >= walkers ? 1 : walkers / ns;  // segments a slice: one unit a walker if > 1
  const int L = (n + P - 1) / P;
  int own = 0, run = -1;  // this walker's open last run (P > 1), and its index
  long long c = 0;
  TAcc a[VEC];
  for (int u = walker; u < ns * P; u += walkers) {
    c = (s0 + u % ns) * width + cl;
    if (c >= F) continue;  // F % VEC == 0: a lane's columns are all in or all out
    const int seg = u / ns;
    const int b = seg_start(s_head, seg, L, n);
    const int e = seg + 1 < P ? seg_start(s_head, seg + 1, L, n) : n;
    const bool open_lo = b < e && !(s_head[b >> 5] >> (b & 31) & 1);
    const bool open_hi = e < n && !(s_head[e >> 5] >> (e & 31) & 1);
    own = walk_runs<OP, VEC>(sh.st.key, sh.st.pos, b, e, open_lo, open_hi, val + row0 * F + c,
                             F, out + c, a, s_piece[threadIdx.x]);
    if (own == 1) run = (int)sh.st.key[e - 1];
    if ((lane & (lpr - 1)) == 0) s_through[walker] = own == 2;
  }
  if (P == 1) return;  // uniform: no run was cut inside the tile
  __syncthreads();
  if (own == 1) {  // the run's owner: add the pieces of the next segments, apply once
    for (int w = walker + ns;; w += ns) {
      const TAcc* q = s_piece[w * lpr + (lane & (lpr - 1))];
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] = pb::combine<OP>(a[j], q[j]);
      if (!s_through[w]) break;
    }
    apply_cols<OP, VEC>(out + c + (long long)run * F, a);
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

template <typename TIn, typename TAcc, int OP, int VEC>
int launch_tile(cudaStream_t s, const int* idx, const TIn* val, long long m, int F, TAcc* out,
                long long num_out, int lpr) {
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  if (tiles > 0x7fffffffLL || num_out > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int lpr_log = 0;
  while ((1 << lpr_log) < lpr) ++lpr_log;
  const long long slices = (F + (long long)lpr * VEC - 1) / ((long long)lpr * VEC);
  const long long target = (long long)kTileBlocksPerSm * pb_num_sms();
  long long groups = 1, spb = slices;  // enough tiles: each block takes every slice
  if (tiles < target) {
    groups = (target + tiles - 1) / tiles;
    groups = groups < slices ? groups : slices;
    spb = (slices + groups - 1) / groups;
    groups = (slices + spb - 1) / spb;
  }
  // groups <= target: a wide row's slices go to a block spb at a time
  if (spb > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
  // bits of num_out itself: the dropped key num_out sorts last
  int key_bits = 1;
  while (key_bits < 31 && (num_out >> key_bits) != 0) ++key_bits;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  rows_tile_kernel<TIn, TAcc, OP, VEC><<<grid, kTileThreads, 0, s>>>(
      idx, val, m, F, out, (int)num_out, key_bits, lpr_log, slices, (int)spb);
  return (int)cudaGetLastError();
}

// Launch the row walk on the stream: VEC = 4 when `vec4`, lanes per row
// from F; the narrow walk up to kSegMaxLpr lanes a row, the tile walk
// above (fused.py's rows_design names the same rule). Returns
// cudaErrorInvalidValue if the grid would not fit.
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
  return vec4 ? launch_tile<TIn, TAcc, OP, 4>(s, idx, val, m, F, out, num_out, lpr)
              : launch_tile<TIn, TAcc, OP, 1>(s, idx, val, m, F, out, num_out, lpr);
}

}  // namespace

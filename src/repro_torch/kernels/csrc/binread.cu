// Bin-Read scatter-add of a padded bin layout:
//   out[idx[b, l], :] += val[b, l, :]  for idx[b, l] in [0, B * R);
// padding (-1) and every other index outside [0, B * R) is dropped,
// wherever it stands in the row, and rows no tuple reaches are zero. An
// index outside its own bin's range [b * R, (b + 1) * R) is still added
// at its global row (the plain oracle's rule).
//
// Replaces: src/repro/kernels/binread.py::binread_scatter_add_pallas. The
// TPU kernel gives each bin one grid step, keeps the bin's (R, d) output
// slab in VMEM and adds the bin's rows with one (R, L) @ (L, d) one-hot
// matmul in float32. On the H100 a slab (4 MB at R = 4096, d = 256) is far
// past the 227 KB of shared memory a block has, and one bin may hold nearly
// all rows (260,805 of 262,144 in the zipf embedding-gradient stream), so
// one block per bin would serialise on it, and a slab in shared memory
// would drop the out-of-bin indices the oracle adds.
//
// Bound on the H100: bytes — the 4*B*L indices and the values of the real
// (non-padding) rows read once, B*R*d outputs written (and zeroed by the
// caller).
//
// Design: tile-sorted runs with vector reductions into a float32
// accumulator in global memory (the bin's slab sits in the 50 MB L2).
// - A block takes a tile of kBrTile consecutive positions of one bin row
//   and one slice of 32 * VEC columns (two slices at d = 256, so the
//   zipf stream's one full bin still spreads over 128 blocks). It loads the
//   tile's indices (16-byte loads where the row allows) and ends there if
//   none is in range: 92% of B * L is padding at the zipf shape.
// - In-bin indices are counting-sorted by local index idx - b * R (R <=
//   kBrMaxRange): a shared-memory atomic on the local key's counter gives
//   each its rank, a block scan of the counters the keys' starts. The
//   sorted (key, position) pairs fill a list from the front.
// - A warp takes 32 sorted entries at a time; each lane holds VEC columns
//   of the slice (one 16-byte float32 or 8-byte bfloat16 load a row),
//   gathers kBrUnroll rows before folding them, sums a run of equal keys
//   in float32 registers and applies it with one vector reduction per 4
//   columns (atomicAdd on a float4: REDG.E.ADD.F32x4 on sm_90a). Where zipf
//   ids repeat, a 4096-position tile holds about 15% distinct ids, so
//   the 67M scalar reductions of a row-by-row walk become about 2.5M.
// - Other in-range indices (outside their bin, or every index when R >
//   kBrMaxRange) fill the same list from the back and take a side path
//   in this kernel: one row a warp, one reduction per VEC columns at the
//   global row.
// - When d % 4 != 0 or a row is not aligned, VEC = 1: scalar loads and
//   one scalar atomicAdd per column.
// bf16 rows are accumulated in float32 (the caller's scratch) and rounded
// once into the bf16 output by bf16_store_kernel, as the TPU kernel's
// preferred_element_type=float32 dot is.
#include <cstdint>

#include <cuda_bf16.h>

#include "pb_common.cuh"
#include "pb_rows.cuh"

namespace {

constexpr int kBrThreads = 512;
constexpr int kBrWarps = kBrThreads / 32;
constexpr int kBrTile = 4096;  // positions of one bin row a block takes
constexpr int kBrItems = kBrTile / kBrThreads;  // a multiple of 4
constexpr int kBrMaxRange = 4096;  // local keys the counting sort takes
constexpr int kBrUnroll = 4;  // rows a lane loads before folding (PERF.md: 4 >= 8, 16)
constexpr int kBrDropped = -1, kBrSide = -2;  // key of an item not sorted

static_assert(kBrItems % 4 == 0, "items a thread are loaded four at a time");

constexpr size_t kBrSmem = (kBrMaxRange + kBrTile + kBrWarps + 1) * sizeof(int);

template <int VEC>
__device__ __forceinline__ void reduce_cols(float* p, const float (&a)[VEC]);

template <>
__device__ __forceinline__ void reduce_cols<4>(float* p, const float (&a)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
}

template <>
__device__ __forceinline__ void reduce_cols<1>(float* p, const float (&a)[1]) {
  atomicAdd(p, a[0]);
}

template <typename TIn, int VEC>
__global__ void __launch_bounds__(kBrThreads)
binread_kernel(const int* __restrict__ idx, const TIn* __restrict__ val, int B, int L, int d,
               int R, float* __restrict__ acc, int tiles, int slices, bool vec_idx) {
  extern __shared__ int smem[];
  int* s_start = smem;                 // kBrMaxRange counters, then the keys' starts
  int* s_list = smem + kBrMaxRange;    // sorted entries from the front, side ones from the back
  int* s_warp = s_list + kBrTile;      // the block scan's warp totals
  int* s_side = s_warp + kBrWarps;     // side entries
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = blockIdx.x % slices;
  const int tile = (blockIdx.x / slices) % tiles;
  const int b = blockIdx.x / slices / tiles;
  const int t0 = tile * kBrTile;
  const int len = L - t0 < kBrTile ? L - t0 : kBrTile;
  const long long row0 = (long long)b * L + t0;  // the tile's first row of the (B*L, d) values
  const long long lo = (long long)b * R;
  const long long total = (long long)B * R;
  const bool sortable = R <= kBrMaxRange;

  // this thread's items: positions (q * kBrThreads + threadIdx.x) * 4 + e
  int key[kBrItems];
  bool any = false;
#pragma unroll
  for (int q = 0; q < kBrItems / 4; ++q) {
    const int p = (q * kBrThreads + threadIdx.x) * 4;
    int k[4];
    if (vec_idx && p + 3 < len) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(idx + row0 + p));
      k[0] = w.x;
      k[1] = w.y;
      k[2] = w.z;
      k[3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) k[e] = p + e < len ? __ldg(idx + row0 + p + e) : -1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long local = (long long)k[e] - lo;
      int c = kBrDropped;
      if (k[e] >= 0 && k[e] < total) c = sortable && local >= 0 && local < R ? (int)local : kBrSide;
      key[q * 4 + e] = c;
      any |= c != kBrDropped;
    }
  }
  if (!__syncthreads_or(any)) return;  // all padding
  if (sortable)
    for (int r = threadIdx.x; r < R; r += kBrThreads) s_start[r] = 0;
  if (threadIdx.x == 0) *s_side = 0;
  __syncthreads();
  int rank[kBrItems];
#pragma unroll
  for (int i = 0; i < kBrItems; ++i) {
    const int p = ((i / 4) * kBrThreads + threadIdx.x) * 4 + i % 4;
    if (key[i] >= 0) rank[i] = atomicAdd(&s_start[key[i]], 1);
    else if (key[i] == kBrSide) s_list[kBrTile - 1 - atomicAdd(s_side, 1)] = p;
  }
  __syncthreads();
  int n = 0;  // sorted entries
  if (sortable) {
    // exclusive scan of the R counters: thread t owns `per` consecutive ones
    const int per = (R + kBrThreads - 1) / kBrThreads;
    const int c0 = threadIdx.x * per;
    int sum = 0;
    for (int j = 0; j < per && c0 + j < R; ++j) sum += s_start[c0 + j];
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(PB_FULL_MASK, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kBrWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(PB_FULL_MASK, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kBrWarps) s_warp[lane] = w;
    }
    __syncthreads();
    int run = x - sum + (warp > 0 ? s_warp[warp - 1] : 0);
    for (int j = 0; j < per && c0 + j < R; ++j) {
      const int c = s_start[c0 + j];
      s_start[c0 + j] = run;
      run += c;
    }
    n = s_warp[kBrWarps - 1];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kBrItems; ++i) {
      if (key[i] >= 0) {
        const int p = ((i / 4) * kBrThreads + threadIdx.x) * 4 + i % 4;
        s_list[s_start[key[i]] + rank[i]] = (key[i] << 16) | p;
      }
    }
    __syncthreads();
  }
  const int n_side = *s_side;

  const int col = slice * 32 * VEC + lane * VEC;
  const bool active = col < d;  // d % VEC == 0, so the lane's VEC columns are all in range
  const TIn* vrow = val + row0 * d + col;  // the tile's position p: vrow + p * d
  float* orow = acc + lo * d + col;        // local key k: orow + k * d
  for (int c = warp * 32; c < n; c += kBrWarps * 32) {
    const int cnt = n - c < 32 ? n - c : 32;
    const int mine = lane < cnt ? s_list[c + lane] : 0;
    int cur = -1;
    float a[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = 0.f;
    for (int j0 = 0; j0 < cnt; j0 += kBrUnroll) {
      float v[kBrUnroll][VEC];
      int kk[kBrUnroll];
#pragma unroll
      for (int u = 0; u < kBrUnroll; ++u) {
        const int e = __shfl_sync(PB_FULL_MASK, mine, (j0 + u) & 31);
        kk[u] = j0 + u < cnt ? e >> 16 : -1;
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[u][j] = 0.f;
        if (kk[u] >= 0 && active) load_row<VEC>(vrow + (long long)(e & 0xffff) * d, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kBrUnroll; ++u) {
        if (kk[u] < 0) continue;  // the same in every lane
        if (kk[u] == cur) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) a[j] += v[u][j];
        } else {
          if (cur >= 0 && active) reduce_cols<VEC>(orow + (long long)cur * d, a);
          cur = kk[u];
#pragma unroll
          for (int j = 0; j < VEC; ++j) a[j] = v[u][j];
        }
      }
    }
    if (cur >= 0 && active) reduce_cols<VEC>(orow + (long long)cur * d, a);
  }
  // the side path: an in-range index outside the sort, at its global row
  for (int s = warp; s < n_side; s += kBrWarps) {
    const int p = s_list[kBrTile - 1 - s];
    const long long g = __ldg(idx + row0 + p);
    if (active) {
      float v[VEC];
      load_row<VEC>(vrow + (long long)p * d, v);
      reduce_cols<VEC>(acc + g * d + col, v);
    }
  }
}

template <typename TIn, int VEC>
int launch_binread(cudaStream_t s, const int* idx, const TIn* val, int B, int L, int d, int R,
                   float* acc) {
  const int tiles = (L + kBrTile - 1) / kBrTile;
  const int slices = (d + 32 * VEC - 1) / (32 * VEC);
  const long long blocks = (long long)B * tiles * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (kBrSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        binread_kernel<TIn, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBrSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec_idx = L % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  binread_kernel<TIn, VEC><<<(unsigned)blocks, kBrThreads, kBrSmem, s>>>(
      idx, val, B, L, d, R, acc, tiles, slices, vec_idx);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_dtype(cudaStream_t s, const int* idx, const TIn* val, int B, int L, int d, int R,
                 float* acc) {
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(val) % (4 * sizeof(TIn)) == 0;
  return vec4 ? launch_binread<TIn, 4>(s, idx, val, B, L, d, R, acc)
              : launch_binread<TIn, 1>(s, idx, val, B, L, d, R, acc);
}

__global__ void bf16_store_kernel(const float* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16(acc[i]);
}

}  // namespace

// idx (B, L) int32, val (B, L, d) row-major; dtype 0 float32, 1 bfloat16;
// R the bin range. `acc` is a zeroed float32 (B*R, d) buffer: the output
// itself for float32, scratch for bfloat16, whose result goes to `out`
// (B*R, d).
extern "C" int pb_binread_scatter_add(const int* idx, const void* val, int B, int L, int d,
                                      int R, float* acc, void* out, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || B < 0 || L < 0 || d < 0 || R < 1)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && L > 0 && d > 0) {
    const int st =
        dtype == 0
            ? launch_dtype<float>(s, idx, static_cast<const float*>(val), B, L, d, R, acc)
            : launch_dtype<__nv_bfloat16>(s, idx, static_cast<const __nv_bfloat16*>(val), B, L,
                                          d, R, acc);
    if (st != 0) return st;
  }
  const long long n = (long long)B * R * d;
  if (dtype == 1 && n > 0) {
    long long blocks = (n + 255) / 256;
    const long long cap = 16LL * pb_num_sms();
    bf16_store_kernel<<<(unsigned)(blocks < cap ? blocks : cap), 256, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(out), n);
  }
  return (int)cudaGetLastError();
}

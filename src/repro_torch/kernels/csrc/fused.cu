// Fused bin-and-accumulate: an (idx, val) stream reduced by add, min or
// max into a dense out[num_indices].
//
// Replaces: src/repro/kernels/fused.py::cobra_bin_accumulate_pallas. The
// TPU kernel keeps the whole (num_bins, bin_range) accumulator in VMEM
// (up to 32 MiB) and flushes per-bin C-Buffers into it by one-hot
// reductions, across grid steps that run in order. One H100 SM has 227 KB
// of shared memory, so the accumulator cannot live on chip in one block.
//
// Bound on the H100: bytes — 8*m bytes of tuples read and 4*n bytes of
// output written (0.085 ms at m = 2^25, n = 2^22 and 3.35 TB/s).
//
// Two designs; the wrapper (kernels/fused.py) picks one by m and n:
//
// two-pass (propagation blocking on the card), for m >= the wrapper's
//   TWO_PASS_MIN_M and n <= 2048 slabs of 32768: the index range is cut
//   into slabs of S = 2^shift entries (the wrapper's choice: about two
//   slabs per SM, at most 32768 so a slab's accumulator fits in 128 KB).
//   (1) slab_count_kernel: tuples per slab (shared-memory histogram);
//   (2) slab_bin_kernel: the binning phase, on the one-pass look-back
//       core of pb_onesweep.cuh: a block takes a tile of kBinTile tuples
//       by ticket, counts them by slab and stages the tile grouped by
//       slab in shared memory (shared-memory atomics claim the slots; the
//       order inside a slab is free, so no stable rank is needed, and a
//       warp whose tuples share a slab claims once), looks back for each
//       slab's cursor (tile 0 seeds the cursors with the slab starts from
//       (1), and also writes the slab starts and the work list of (3)),
//       and writes each slab's run out with coalesced stores: a 16-bit
//       offset inside the slab and the 4-byte value, 6 bytes a tuple;
//   (3) slab_reduce_kernel: the accumulate phase; persistent blocks take
//       work items by ticket. An item is a slab, or a chunk of a slab
//       that holds more than its share (`chunk` tuples, twice the mean):
//       it is reduced into the slab's accumulator in shared memory with
//       shared-memory atomics, then written to `out` with coalesced
//       stores. Hub combining: in each warp the tuples of one index (lane
//       0's; in a split slab, the most frequent, by __match_any_sync) are
//       combined by shuffles and applied once, so a hub does not
//       serialise on one shared address (a float add there is a
//       compare-and-swap loop: sm_90 has no shared-memory float atomic).
//       The first chunk of a split slab writes its whole slab and then
//       releases a flag; the other chunks wait for it and merge each
//       entry they touched with one global atomic.
//   No global atomic per tuple. Bytes: 4m (1) + 8m read and 6m written
//   (2) + 6m read (3) + 4n written = 24m + 4n, plus the status words of
//   (2) (8 bytes per (tile, slab), 3% of the tuple bytes at 256 slabs).
//
// single-sweep, for the other shapes: each block loads a
//   tile of 2048 tuples, groups it by bin (idx / bin_range) in shared
//   memory with a per-tile counting sort, and flushes it with one atomic
//   per distinct index into `out` (the caller fills it with the op's
//   identity), which stays in L2 at the sizes the executor's fused_fits
//   admits. At small m its single launch wins over (1)-(3).
//
// Float min/max use the order-preserving trick on the raw bits
// (pb_common.cuh); NaN is out of scope. Indices outside [0, num_indices),
// negative ones included, are dropped. int32 results and all min/max
// results are exact; a float32 add depends on the order the atomics land.
#include <limits>

#include <cub/block/block_scan.cuh>

#include "pb_common.cuh"
#include "pb_onesweep.cuh"

namespace {

using namespace pb;
namespace os = pb::onesweep;

// -- single-sweep -------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxGroupBins = 4096;

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

// -- two-pass -----------------------------------------------------------------

constexpr int kCountThreads = 256;
constexpr int kCountItems = 16;
constexpr int kBinThreads = 512;
constexpr int kBinItems = 16;
constexpr int kBinTile = kBinThreads * kBinItems;  // 8192 tuples
constexpr int kReduceThreads = 512;
constexpr int kReduceUnroll = 8;

__global__ void __launch_bounds__(kCountThreads)
slab_count_kernel(const int* __restrict__ idx, long long m, int n, int shift,
                  int* __restrict__ counts, int num_slabs) {
  extern __shared__ int h[];
  for (int b = threadIdx.x; b < num_slabs; b += kCountThreads) h[b] = 0;
  __syncthreads();
  const long long step = (long long)gridDim.x * kCountThreads * kCountItems;
  for (long long t0 = (long long)blockIdx.x * kCountThreads * kCountItems; t0 < m; t0 += step) {
    int k[kCountItems];
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) {
      const long long i = t0 + j * kCountThreads + threadIdx.x;
      k[j] = i < m ? __ldcs(idx + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < kCountItems; ++j)
      if ((unsigned)k[j] < (unsigned)n) atomicAdd(&h[k[j] >> shift], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_slabs; b += kCountThreads)
    if (h[b]) atomicAdd(&counts[b], h[b]);
}

// Shared memory of slab_bin_kernel, in bytes.
size_t bin_smem(int num_slabs) {
  return (4 * (size_t)num_slabs + 2 * (size_t)kBinTile) * sizeof(int);
}

// Adds `add` to s[b] for each lane's slab b (b >= num_slabs: none) and
// returns the old value; a warp whose 32 lanes share one slab makes one
// atomic (lane l gets old + l * add), so a hub does not serialise.
template <bool kReturn>
__device__ __forceinline__ int slab_atomic(int* s, int b, int num_slabs) {
  const int lane = threadIdx.x & 31;
  const int b0 = __shfl_sync(PB_FULL_MASK, b, 0);
  if (__all_sync(PB_FULL_MASK, b == b0) && b0 < num_slabs) {
    int old = 0;
    if (lane == 0) old = atomicAdd(&s[b0], 32);
    return kReturn ? __shfl_sync(PB_FULL_MASK, old, 0) + lane : 0;
  }
  if (b >= num_slabs) return 0;
  if (kReturn) return atomicAdd(&s[b], 1);
  atomicAdd(&s[b], 1);
  return 0;
}

__global__ void __launch_bounds__(kBinThreads, 2)
slab_bin_kernel(const int* __restrict__ idx, const unsigned* __restrict__ val, long long m,
                int n, int shift, int num_slabs, long long chunk,
                const int* __restrict__ counts, int* __restrict__ slab_start,
                int* __restrict__ item_start, unsigned long long* __restrict__ status,
                unsigned* __restrict__ ticket, unsigned short* __restrict__ out_off,
                unsigned* __restrict__ out_val) {
  extern __shared__ int sh[];
  const int B = num_slabs;
  int* s_tot = sh;                      // [B] the tile's count per slab
  int* s_first = s_tot + B;             // [B] the slab's first staged slot
  int* s_cur = s_first + B;             // [B] the slab's next staged slot
  int* s_pre = s_cur + B;               // [B] destination - staged slot, per slab
  int* st_idx = s_pre + B;              // [kBinTile] the tile grouped by slab
  unsigned* st_val = reinterpret_cast<unsigned*>(st_idx + kBinTile);
  __shared__ int s_warp[kBinThreads / 32 + 1];
  __shared__ int s_tile;
  const long long tile = os::take_ticket(ticket, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = tile * kBinTile + (long long)warp * (kBinItems * 32) + lane;

  int id[kBinItems];
  unsigned v[kBinItems];
#pragma unroll
  for (int j = 0; j < kBinItems; ++j) {
    const long long i = base + j * 32;
    const bool in = i < m;
    id[j] = in ? __ldcs(idx + i) : -1;
    v[j] = in ? __ldcs(val + i) : 0u;
  }
  for (int b = threadIdx.x; b < B; b += kBinThreads) s_tot[b] = 0;
  if (tile == 0) {  // the slab starts seed the look-back; tile 0 also writes the work list
    for (int b = threadIdx.x; b < B; b += kBinThreads) {
      const int c = counts[b];
      s_pre[b] = c;
      s_cur[b] = c > chunk ? (int)((c + chunk - 1) / chunk) : 1;
    }
    __syncthreads();
    const int total = os::block_exclusive_scan(s_pre, B, s_warp);
    const int items = os::block_exclusive_scan(s_cur, B, s_warp);
    for (int b = threadIdx.x; b < B; b += kBinThreads) {
      slab_start[b] = s_pre[b];
      item_start[b] = s_cur[b];
    }
    if (threadIdx.x == 0) {
      slab_start[B] = total;
      item_start[B] = items;
    }
  }
  __syncthreads();
  // the tile's count per slab (the order of a slab's tuples inside the
  // tile is free: the reduce is commutative)
#pragma unroll
  for (int j = 0; j < kBinItems; ++j)
    slab_atomic<false>(s_tot, (unsigned)id[j] < (unsigned)n ? id[j] >> shift : B, B);
  __syncthreads();
  os::publish_aggregates(status, tile, s_tot, B);
  for (int b = threadIdx.x; b < B; b += kBinThreads) s_first[b] = s_tot[b];
  __syncthreads();
  const int staged = os::block_exclusive_scan(s_first, B, s_warp);
  for (int b = threadIdx.x; b < B; b += kBinThreads) s_cur[b] = s_first[b];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kBinItems; ++j) {
    const int b = (unsigned)id[j] < (unsigned)n ? id[j] >> shift : B;
    const int slot = slab_atomic<true>(s_cur, b, B);
    if (b < B) {
      st_idx[slot] = id[j];
      st_val[slot] = v[j];
    }
  }
  os::look_back(status, tile, s_tot, s_pre, s_pre, B);
  for (int b = threadIdx.x; b < B; b += kBinThreads) s_pre[b] -= s_first[b];
  __syncthreads();
  const int mask = (1 << shift) - 1;
  for (int s = threadIdx.x; s < staged; s += kBinThreads) {
    const int i = st_idx[s];
    const long long d = (long long)s_pre[i >> shift] + s;
    out_off[d] = (unsigned short)(i & mask);
    out_val[d] = st_val[s];
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kReduceThreads)
slab_reduce_kernel(const unsigned short* __restrict__ off, const T* __restrict__ val,
                   const int* __restrict__ slab_start, const int* __restrict__ item_start,
                   int num_slabs, long long chunk, int n, int shift, T ident,
                   T* __restrict__ out, int* __restrict__ ready, unsigned* __restrict__ ticket) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  T* acc = reinterpret_cast<T*>(sh_raw);
  __shared__ int s_item;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int items = item_start[num_slabs];
  for (;;) {
    const int w = (int)os::take_ticket(ticket, &s_item);
    if (w >= items) break;
    int lo = 0, hi = num_slabs - 1;  // the slab: the last b with item_start[b] <= w
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (item_start[mid] <= w) lo = mid;
      else hi = mid - 1;
    }
    const int b = lo;
    const int c = w - item_start[b];
    const int nch = item_start[b + 1] - item_start[b];
    const long long t_lo = slab_start[b] + (long long)c * chunk;
    const long long t_end = slab_start[b + 1];
    const long long t_hi = t_lo + chunk < t_end ? t_lo + chunk : t_end;
    const bool hot = nch > 1;  // a slab that holds more than its share
    const long long o0 = (long long)b << shift;
    const int len = (int)((n - o0) < (1LL << shift) ? (n - o0) : (1LL << shift));
    for (int j = threadIdx.x; j < len; j += kReduceThreads) acc[j] = ident;
    __syncthreads();
    for (long long t0 = t_lo + (long long)warp * 32 * kReduceUnroll; t0 < t_hi;
         t0 += (long long)kReduceThreads * kReduceUnroll) {
      int k[kReduceUnroll];
      T x[kReduceUnroll];
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
        const long long i = t0 + u * 32 + lane;
        const bool in = i < t_hi;
        k[u] = in ? (int)off[i] : -1;
        x[u] = in ? val[i] : ident;
      }
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
        // lanes past the end hold k = -1 and the identity; lane 0 is in
        // whenever any lane is
        if (__shfl_sync(PB_FULL_MASK, k[u], 0) < 0) continue;
        // the warp's most frequent index (in a split slab, found with
        // __match_any_sync; elsewhere lane 0's) is combined by shuffles and
        // applied once; every other lane applies its own tuple
        int kb = __shfl_sync(PB_FULL_MASK, k[u], 0);
        if (hot) {
          const unsigned peers = __match_any_sync(PB_FULL_MASK, k[u]);
          const int best = __reduce_max_sync(PB_FULL_MASK, (__popc(peers) << 5) | lane);
          kb = __shfl_sync(PB_FULL_MASK, k[u], best & 31);
        }
        const bool mine = k[u] == kb;
        if (__popc(__ballot_sync(PB_FULL_MASK, mine)) > 1) {  // the same for every lane
          T y = mine ? x[u] : ident;
#pragma unroll
          for (int o = 16; o; o >>= 1) y = combine<OP>(y, __shfl_xor_sync(PB_FULL_MASK, y, o));
          if (lane == 0 && kb >= 0) apply<OP>(&acc[kb], y);
          if (!mine && k[u] >= 0) apply<OP>(&acc[k[u]], x[u]);
        } else if (k[u] >= 0) {
          apply<OP>(&acc[k[u]], x[u]);
        }
      }
    }
    __syncthreads();
    if (nch == 1 || c == 0) {
      for (int j = threadIdx.x; j < len; j += kReduceThreads) out[o0 + j] = acc[j];
      if (nch > 1) {  // the other chunks of this slab merge after these stores
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) os::store_release(&ready[b], 1);
      }
    } else {
      if (threadIdx.x == 0)
        while (os::load_acquire(&ready[b]) == 0) {
        }
      __syncthreads();
      for (int j = threadIdx.x; j < len; j += kReduceThreads)
        if (acc[j] != ident) apply<OP>(&out[o0 + j], acc[j]);
    }
    __syncthreads();
  }
}

// Scratch layout of the two-pass design, in bytes: a zeroed head (two
// tickets, the ready flags, the slab counts, the status words), then the
// slab starts and the work list, then the binned stream (offsets, values).
struct Layout {
  size_t ready, counts, status, zeroed, slab_start, item_start, off, val, total;
};

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

Layout layout_for(long long m, int num_slabs) {
  Layout L;
  const long long tiles = (m + kBinTile - 1) / kBinTile;
  L.ready = 256;
  L.counts = align256(L.ready + 4 * (size_t)num_slabs);
  L.status = align256(L.counts + 4 * (size_t)num_slabs);
  L.zeroed = align256(L.status + 8 * (size_t)tiles * num_slabs);
  L.slab_start = L.zeroed;
  L.item_start = align256(L.slab_start + 4 * ((size_t)num_slabs + 1));
  L.off = align256(L.item_start + 4 * ((size_t)num_slabs + 1));
  L.val = align256(L.off + 2 * (size_t)m);
  L.total = align256(L.val + 4 * (size_t)m);
  return L;
}

template <typename T, int OP>
int reduce_launch(const Layout& L, unsigned char* base, int num_slabs, long long chunk, int n,
                  int shift, T ident, T* out, long long m, cudaStream_t s) {
  auto kernel = slab_reduce_kernel<T, OP>;
  const size_t smem = sizeof(T) << shift;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kReduceThreads, smem);
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * pb_num_sms();
  const long long most = num_slabs + m / chunk;  // the longest possible work list
  if (blocks > most) blocks = most;
  kernel<<<(unsigned)blocks, kReduceThreads, smem, s>>>(
      reinterpret_cast<const unsigned short*>(base + L.off),
      reinterpret_cast<const T*>(base + L.val), reinterpret_cast<const int*>(base + L.slab_start),
      reinterpret_cast<const int*>(base + L.item_start), num_slabs, chunk, n, shift, ident, out,
      reinterpret_cast<int*>(base + L.ready), reinterpret_cast<unsigned*>(base) + 1);
  return (int)cudaGetLastError();
}

template <typename T>
int reduce_launch_op(int op, const Layout& L, unsigned char* base, int num_slabs, long long chunk,
                     int n, int shift, T* out, long long m, cudaStream_t s) {
  if (op == kAdd) return reduce_launch<T, kAdd>(L, base, num_slabs, chunk, n, shift, T(0), out, m, s);
  // the identities of min and max are the finite dtype bounds (reduce_identity)
  if (op == kMin)
    return reduce_launch<T, kMin>(L, base, num_slabs, chunk, n, shift,
                                  std::numeric_limits<T>::max(), out, m, s);
  return reduce_launch<T, kMax>(L, base, num_slabs, chunk, n, shift,
                                std::numeric_limits<T>::lowest(), out, m, s);
}

int two_pass(const int* idx, const void* val, long long m, void* out, int n, int op, int dtype,
             int shift, long long chunk, void* scratch, cudaStream_t s) {
  if (shift < 0 || shift > 15 || chunk <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long slabs = (((long long)n - 1) >> shift) + 1;
  if (slabs > os::kMaxBins) return (int)cudaErrorInvalidValue;
  const int B = (int)slabs;
  const Layout L = layout_for(m, B);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  cudaMemsetAsync(base, 0, L.zeroed, s);
  long long want = (m + kCountThreads * kCountItems - 1) / (kCountThreads * kCountItems);
  const long long cap = 4LL * pb_num_sms();
  slab_count_kernel<<<(unsigned)(want < cap ? want : cap), kCountThreads, B * sizeof(int), s>>>(
      idx, m, n, shift, reinterpret_cast<int*>(base + L.counts), B);
  const size_t smem = bin_smem(B);
  cudaFuncSetAttribute(slab_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long tiles = (m + kBinTile - 1) / kBinTile;
  slab_bin_kernel<<<(unsigned)tiles, kBinThreads, smem, s>>>(
      idx, static_cast<const unsigned*>(val), m, n, shift, B, chunk,
      reinterpret_cast<const int*>(base + L.counts), reinterpret_cast<int*>(base + L.slab_start),
      reinterpret_cast<int*>(base + L.item_start),
      reinterpret_cast<unsigned long long*>(base + L.status), reinterpret_cast<unsigned*>(base),
      reinterpret_cast<unsigned short*>(base + L.off), reinterpret_cast<unsigned*>(base + L.val));
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (dtype == 0)
    return reduce_launch_op<float>(op, L, base, B, chunk, n, shift, static_cast<float*>(out), m, s);
  return reduce_launch_op<int>(op, L, base, B, chunk, n, shift, static_cast<int*>(out), m, s);
}

}  // namespace

// Bytes of scratch the two-pass design needs for m tuples over n indices
// in slabs of 2^shift (0 for the single sweep, which needs none).
extern "C" long long pb_fused_scratch(long long m, int num_indices, int shift) {
  if (m <= 0 || num_indices <= 0 || shift < 0) return 0;
  const long long slabs = (((long long)num_indices - 1) >> shift) + 1;
  if (slabs > os::kMaxBins) return 0;
  return (long long)layout_for(m, (int)slabs).total;
}

// op: 0 add, 1 min, 2 max. dtype: 0 float32, 1 int32. design 0 is the
// single sweep: `out` holds the op's identity on entry. design 1 is the
// two-pass kernel: it writes every entry of `out`, in slabs of 2^shift,
// splitting a slab's tuples into work items of `chunk`; `scratch` holds
// pb_fused_scratch(m, num_indices, shift) bytes.
extern "C" int pb_fused_accumulate(const int* idx, const void* val, long long m, void* out,
                                   int num_indices, int bin_range, int num_bins, int op,
                                   int dtype, int design, int shift, long long chunk,
                                   void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return (int)cudaGetLastError();
  if (op < 0 || op > 2 || dtype < 0 || dtype > 1 || bin_range <= 0)
    return (int)cudaErrorInvalidValue;
  if (design == 1)
    return two_pass(idx, val, m, out, num_indices, op, dtype, shift, chunk, scratch, s);
  if (design != 0) return (int)cudaErrorInvalidValue;
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

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
//   slabs per SM, 256 <= S <= 32768, so a slab's accumulator fits in
//   128 KB and an offset in 16 bits).
//   (1) slab_count_kernel: tuples per slab (shared-memory histogram);
//   (2) slab_bin_kernel: the binning phase. Persistent blocks of 1024
//       threads, one an SM; block b takes tiles b, b + grid, ... of
//       kBinTile tuples. Thread 0 keeps a ring of kBinStages tiles in
//       flight: when a stage frees it starts the block's next tile's idx
//       and val copies into it (cp.async.bulk, completing on the stage's
//       mbarrier), so the next tile loads while the block works on this
//       one. The block counts the tile by slab with shared-memory atomics
//       that also hand each tuple its rank in its slab (a warp whose tuples
//       share a slab makes one), claims each slab's run with one global
//       atomic on the slab's cursor (the order of a slab's runs, like the
//       order inside one, is free: the reduce is commutative, so no
//       look-back orders the tiles), stages the tile grouped by slab in
//       place in its stage (slot = the slab's staged start + rank), and
//       writes each slab's run to slab_start + cursor with coalesced
//       stores: a 16-bit offset inside the slab and the 4-byte value, 6
//       bytes a tuple (a run starts anywhere, so it is not a bulk store,
//       which wants 16-byte-aligned ends). Every block scans the slab
//       counts of (1) into the slab starts; block 0 also writes them and
//       the work list of (3);
//   (3) slab_reduce_kernel: the accumulate phase; persistent blocks of
//       1024 threads take work items by ticket. An item is a slab, or a
//       chunk of a slab that holds more than its share (`chunk` tuples,
//       twice the mean). Thread 0 copies the item's binned tuples,
//       kRedStage at a time, into a ring of kRedStages stages; a run starts
//       anywhere, so each copy is widened to the 16-byte window around it
//       and the head and tail are masked. The slab's accumulator is in
//       shared memory. int32 and min/max apply each tuple with a native
//       shared-memory atomic; a float32 add with exch_add, two native
//       exchanges (atomicAdd(float*) on shared memory is a compare-and-swap
//       loop on sm_90). In each warp the tuples of one index, lane 0's or,
//       in a split slab, the most frequent, are combined by shuffles and
//       applied once, so a hub does not serialise on one address. Then the
//       slab goes to `out` with coalesced stores. The first chunk of a
//       split slab writes its whole slab and then releases a flag; the
//       other chunks wait for it and merge each entry they touched with one
//       global atomic.
//   No global atomic per tuple. Bytes: 4m (1) + 8m read and 6m written
//   (2) + 6m read (3) + 4n written = 24m + 4n (0.245 ms at S2, m = 2^25,
//   n = 2^22). Measured on an H100 (PERF.md, kernel table rows 4, 4c, 4d;
//   scripts/torch_pb_kernels.py): about 0.42 ms at S2, of it 0.24 in (2),
//   0.10 in (3) and 0.05 in (1).
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
// results are exact; a float32 add depends on the order its tuples are
// summed (exchanges and atomics), which changes from run to run.
#include <limits>
#include <type_traits>

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
constexpr int kBinThreads = 1024;
constexpr int kBinItems = 8;
constexpr int kBinTile = kBinThreads * kBinItems;  // 8192 tuples
constexpr int kBinStages = 2;
constexpr int kRedThreads = 1024;
constexpr int kRedItems = 4;
constexpr int kRedStage = kRedThreads * kRedItems;  // 4096 tuples
constexpr int kRedStages = 3;
// A reduce stage holds its tuples' offsets and values in 16-byte-aligned
// windows: up to 7 offsets and 3 values more than its own, before and after.
constexpr int kRedOffBytes = 2 * (kRedStage + 8);
constexpr int kRedStageBytes = kRedOffBytes + 4 * (kRedStage + 4);
static_assert(kRedOffBytes % 16 == 0 && kRedStageBytes % 16 == 0, "16-byte stages");

// -- the copy ring: 1-D bulk copies (cp.async.bulk) that complete on mbarriers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive on ``bar`` and add ``bytes`` to the bytes its phase waits for.
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool bar_try(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of ``bar`` with this parity has completed. Every wait
// is on a copy the block issued itself, so one that lasts 10 s is a fault of
// the ring's bookkeeping: trap, and the launch fails instead of hanging.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  if (bar_try(bar, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!bar_try(bar, parity))
    if (globaltimer() - t0 > 10000000000ull) __trap();
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst`` (both
// 16-byte aligned); they complete on ``bar``.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's generic writes to shared memory before a later bulk
// copy into the same bytes (after a barrier with the thread that issues it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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

// Shared memory of slab_bin_kernel, in bytes: the ring's kBinStages tiles
// of idx and val (each tile is staged by slab in its own stage), then three
// int arrays of a slab each.
size_t bin_smem(int num_slabs) {
  return (size_t)kBinStages * kBinTile * 8 + 3 * (size_t)num_slabs * sizeof(int);
}

// Adds 1 to s[b] for each lane's slab b (b >= num_slabs: none) and returns
// the old value; a warp whose 32 lanes share one slab makes one atomic
// (lane l gets old + l), so a hub does not serialise.
__device__ __forceinline__ int slab_atomic(int* s, int b, int num_slabs) {
  const int lane = threadIdx.x & 31;
  const int b0 = __shfl_sync(PB_FULL_MASK, b, 0);
  if (__all_sync(PB_FULL_MASK, b == b0) && b0 < num_slabs) {
    int old = 0;
    if (lane == 0) old = atomicAdd(&s[b0], 32);
    return __shfl_sync(PB_FULL_MASK, old, 0) + lane;
  }
  return b < num_slabs ? atomicAdd(&s[b], 1) : 0;
}

// Persistent blocks; block b takes tiles b, b + grid, b + 2 grid, ... (the
// order is free, so no ticket, whose round trip would stall the block).
// Thread 0 keeps kBinStages tiles in flight: when a stage frees it starts
// the block's next tile's idx and val copies into it. A tile's run of slab
// b goes to slab_start[b] plus the cursor it claims with one global atomic
// per (tile, slab): the order of a slab's runs is free, so no look-back
// orders them.
__global__ void __launch_bounds__(kBinThreads, 1)
slab_bin_kernel(const int* __restrict__ idx, const unsigned* __restrict__ val, long long m,
                long long tiles, int n, int shift, int num_slabs, long long chunk,
                const int* __restrict__ counts, int* __restrict__ cursor,
                int* __restrict__ slab_start, int* __restrict__ item_start,
                unsigned short* __restrict__ out_off, unsigned* __restrict__ out_val) {
  constexpr int kPer = os::kMaxBins / kBinThreads;  // the slabs a thread owns: b = tid + r * threads
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int B = num_slabs;
  // [B] the tile's count per slab, then its run's destination - staged slot
  int* s_tot = reinterpret_cast<int*>(sh_raw + (size_t)kBinStages * kBinTile * 8);
  int* s_cur = s_tot + B;   // [B] the slab's next staged slot
  int* s_base = s_cur + B;  // [B] the slab starts
  __shared__ int s_warp[kBinThreads / 32 + 1];
  __shared__ long long s_tile[kBinStages];
  __shared__ __align__(8) unsigned long long s_full[kBinStages];

  // thread 0: the block's u-th tile into stage u % kBinStages, and its
  // copies (the whole 16-byte pieces; the stream's last 0-3 tuples are read
  // directly)
  auto fill = [&](int u) {
    const int s = u % kBinStages;
    const long long t = blockIdx.x + (long long)u * gridDim.x;
    s_tile[s] = t;
    const unsigned bar = smem_u32(&s_full[s]);
    const long long t0 = t * kBinTile;
    const int bulk = t < tiles ? (int)min((long long)kBinTile, m - t0) & ~3 : 0;
    if (bulk == 0) {
      bar_arrive(bar);
      return;
    }
    unsigned char* st = sh_raw + (size_t)s * kBinTile * 8;
    bar_expect(bar, 8u * bulk);
    bulk_load(smem_u32(st), idx + t0, 4u * bulk, bar);
    bulk_load(smem_u32(st + 4 * kBinTile), val + t0, 4u * bulk, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBinStages; ++s) bar_init(smem_u32(&s_full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < kBinStages; ++u) fill(u);
  }
  // every block: the slab starts; block 0 also writes them and the work
  // list of the reduce (max(1, ceil(count / chunk)) items a slab)
  for (int b = threadIdx.x; b < B; b += kBinThreads) {
    const int c = counts[b];
    s_base[b] = c;
    s_cur[b] = c > chunk ? (int)((c + chunk - 1) / chunk) : 1;
  }
  __syncthreads();
  const int total = os::block_exclusive_scan(s_base, B, s_warp);
  if (blockIdx.x == 0) {
    const int items = os::block_exclusive_scan(s_cur, B, s_warp);
    for (int b = threadIdx.x; b < B; b += kBinThreads) {
      slab_start[b] = s_base[b];
      item_start[b] = s_cur[b];
    }
    if (threadIdx.x == 0) {
      slab_start[B] = total;
      item_start[B] = items;
    }
  }
  const int mask = (1 << shift) - 1;
  for (int use = 0;; ++use) {
    const int s = use % kBinStages;
    bar_wait(smem_u32(&s_full[s]), (use / kBinStages) & 1);
    const long long tile = s_tile[s];
    if (tile >= tiles) break;  // the ring's later tiles are higher still
    int* st_idx = reinterpret_cast<int*>(sh_raw + (size_t)s * kBinTile * 8);
    unsigned* st_val = reinterpret_cast<unsigned*>(st_idx + kBinTile);
    const long long t0 = tile * kBinTile;
    const int len = (int)min((long long)kBinTile, m - t0);
    const int bulk = len & ~3;
    int id[kBinItems], rank[kBinItems];
#pragma unroll
    for (int j = 0; j < kBinItems; ++j) {
      const int i = j * kBinThreads + threadIdx.x;
      id[j] = i < bulk ? st_idx[i] : i < len ? __ldcs(idx + t0 + i) : -1;
    }
    for (int b = threadIdx.x; b < B; b += kBinThreads) s_tot[b] = 0;
    __syncthreads();  // the tile's slab counts are zero
    // the tile's count per slab, and each tuple's rank among its slab's
    // (the order of a slab's tuples inside the tile is free: the reduce is
    // commutative)
#pragma unroll
    for (int j = 0; j < kBinItems; ++j)
      rank[j] = slab_atomic(s_tot, (unsigned)id[j] < (unsigned)n ? id[j] >> shift : B, B);
    __syncthreads();
    int claim[kPer];  // the cursors' old values, in flight over the scan and the staging
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int b = threadIdx.x + r * kBinThreads;
      const int c = b < B ? s_tot[b] : 0;
      claim[r] = c ? atomicAdd(&cursor[b], c) : 0;
      if (b < B) s_cur[b] = c;
    }
    __syncthreads();
    const int staged = os::block_exclusive_scan(s_cur, B, s_warp);
    int first[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int b = threadIdx.x + r * kBinThreads;
      first[r] = b < B ? s_cur[b] : 0;
    }
    unsigned v[kBinItems];
#pragma unroll
    for (int j = 0; j < kBinItems; ++j) {
      const int i = j * kBinThreads + threadIdx.x;
      v[j] = i < bulk ? st_val[i] : i < len ? __ldcs(val + t0 + i) : 0u;
    }
    __syncthreads();  // every thread has read its tuples out of the stage
    // the tile grouped by slab, in place in its stage: slot = the slab's
    // staged start + the tuple's rank
#pragma unroll
    for (int j = 0; j < kBinItems; ++j) {
      const int b = (unsigned)id[j] < (unsigned)n ? id[j] >> shift : B;
      if (b < B) {
        const int slot = s_cur[b] + rank[j];
        st_idx[slot] = id[j];
        st_val[slot] = v[j];
      }
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int b = threadIdx.x + r * kBinThreads;
      if (b < B) s_tot[b] = s_base[b] + claim[r] - first[r];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBinItems; ++j) {
      const int i = j * kBinThreads + threadIdx.x;
      if (i < staged) {
        const int k = st_idx[i];
        const long long d = (long long)s_tot[k >> shift] + i;
        out_off[d] = (unsigned short)(k & mask);
        out_val[d] = st_val[i];
      }
    }
    fence_proxy_async();
    __syncthreads();  // the stage is free
    if (threadIdx.x == 0) fill(use + kBinStages);
  }
}

// A float32 add into shared memory by two native exchanges: take the
// entry (leaving 0), add it to v, put the sum back. What the second
// exchange returns is what another thread put there in between (0 if
// none); it is carried into the next pass. Every pass moves its value, so
// nothing is compared and nothing is lost, and the loop ends when nothing
// arrived in between. (atomicAdd(float*) on shared memory is a
// compare-and-swap loop on sm_90, ATOMS.CAST.SPIN.)
__device__ __forceinline__ void exch_add(float* p, float v) {
  int* q = reinterpret_cast<int*>(p);
  do {
    v += __int_as_float(atomicExch(q, 0));
    v = __int_as_float(atomicExch(q, __float_as_int(v)));
  } while (v != 0.f);
}

// Applies v to the slab's accumulator in shared memory: int32 and min/max
// by their native shared-memory atomics, a float32 add by exch_add.
template <int OP, typename T>
__device__ __forceinline__ void acc_apply(T* p, T v) {
  if constexpr (OP == kAdd && std::is_same<T, float>::value)
    exch_add(p, v);
  else
    apply<OP>(p, v);
}

// Shared memory of slab_reduce_kernel, in bytes: the ring's stages, then
// the slab's accumulator.
template <typename T>
size_t reduce_smem(int shift) {
  return (size_t)kRedStages * kRedStageBytes + (sizeof(T) << shift);
}

// Persistent blocks take work items by ticket. Thread 0 copies an item's
// binned tuples, kRedStage at a time, into a ring of kRedStages stages
// (widened to 16-byte windows, the head and tail masked by the consumers).
template <typename T, int OP>
__global__ void __launch_bounds__(kRedThreads)
slab_reduce_kernel(const unsigned short* __restrict__ off, const T* __restrict__ val,
                   const int* __restrict__ slab_start, const int* __restrict__ item_start,
                   int num_slabs, long long chunk, int n, int shift, T ident,
                   T* __restrict__ out, int* __restrict__ ready, unsigned* __restrict__ ticket) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  T* acc = reinterpret_cast<T*>(sh_raw + kRedStages * kRedStageBytes);
  __shared__ int s_item;
  __shared__ __align__(8) unsigned long long s_full[kRedStages];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRedStages; ++s) bar_init(smem_u32(&s_full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int items = item_start[num_slabs];
  int used = 0;  // ring stages this block has consumed
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
    const int stages = (int)((t_hi - t_lo + kRedStage - 1) / kRedStage);
    const int u0 = used;
    // thread 0: stage k of this item into ring slot (u0 + k) % kRedStages
    auto issue = [&](int k) {
      const long long a = t_lo + (long long)k * kRedStage;
      const long long e = a + kRedStage < t_hi ? a + kRedStage : t_hi;
      const long long oa = a & ~7LL, ob = (e + 7) & ~7LL;  // 8 offsets, 4 values: 16 bytes
      const long long va = a & ~3LL, vb = (e + 3) & ~3LL;
      const int slot = (u0 + k) % kRedStages;
      unsigned char* st = sh_raw + slot * kRedStageBytes;
      const unsigned bar = smem_u32(&s_full[slot]);
      bar_expect(bar, (unsigned)(2 * (ob - oa) + 4 * (vb - va)));
      bulk_load(smem_u32(st), off + oa, (unsigned)(2 * (ob - oa)), bar);
      bulk_load(smem_u32(st + kRedOffBytes), val + va, (unsigned)(4 * (vb - va)), bar);
    };
    if (threadIdx.x == 0)
      for (int k = 0; k < stages && k < kRedStages; ++k) issue(k);
    for (int j = threadIdx.x; j < len; j += kRedThreads) acc[j] = ident;
    __syncthreads();
    for (int k = 0; k < stages; ++k) {
      const int slot = (u0 + k) % kRedStages;
      bar_wait(smem_u32(&s_full[slot]), ((u0 + k) / kRedStages) & 1);
      const long long a = t_lo + (long long)k * kRedStage;
      const int cnt = (int)((a + kRedStage < t_hi ? a + kRedStage : t_hi) - a);
      const unsigned char* st = sh_raw + slot * kRedStageBytes;
      const unsigned short* s_off = reinterpret_cast<const unsigned short*>(st) + (a & 7);
      const T* s_val = reinterpret_cast<const T*>(st + kRedOffBytes) + (a & 3);
#pragma unroll
      for (int i = 0; i < kRedItems; ++i) {
        const int j = i * kRedThreads + threadIdx.x;
        const int kk = j < cnt ? (int)s_off[j] : -1;
        const T x = j < cnt ? s_val[j] : ident;
        // lanes past the end hold -1 and the identity; lane 0 is in
        // whenever any lane is
        if (__shfl_sync(PB_FULL_MASK, kk, 0) < 0) continue;
        // the warp's most frequent offset (in a hot item, found with
        // __match_any_sync; elsewhere lane 0's) is combined by shuffles
        // and applied once; every other lane applies its own tuple
        int kb = __shfl_sync(PB_FULL_MASK, kk, 0);
        if (hot) {
          const unsigned peers = __match_any_sync(PB_FULL_MASK, kk);
          const int best = __reduce_max_sync(PB_FULL_MASK, (__popc(peers) << 5) | lane);
          kb = __shfl_sync(PB_FULL_MASK, kk, best & 31);
        }
        const bool mine = kk == kb;
        if (__popc(__ballot_sync(PB_FULL_MASK, mine)) > 1) {  // the same for every lane
          T y = mine ? x : ident;
#pragma unroll
          for (int d = 16; d; d >>= 1) y = combine<OP>(y, __shfl_xor_sync(PB_FULL_MASK, y, d));
          if (lane == 0 && kb >= 0) acc_apply<OP>(&acc[kb], y);
          if (!mine && kk >= 0) acc_apply<OP>(&acc[kk], x);
        } else if (kk >= 0) {
          acc_apply<OP>(&acc[kk], x);
        }
      }
      __syncthreads();  // the stage is read: refill it
      if (threadIdx.x == 0 && k + kRedStages < stages) issue(k + kRedStages);
    }
    used = u0 + stages;
    __syncthreads();
    if (nch == 1 || c == 0) {
      for (int j = threadIdx.x; j < len; j += kRedThreads) out[o0 + j] = acc[j];
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
      for (int j = threadIdx.x; j < len; j += kRedThreads)
        if (acc[j] != ident) apply<OP>(&out[o0 + j], acc[j]);
    }
    __syncthreads();
  }
}

// Scratch layout of the two-pass design, in bytes: a zeroed head (the
// reduce's ticket, the ready flags, the slab counts, the slab cursors), then the
// slab starts and the work list, then the binned stream (offsets, values),
// and 256 bytes that the reduce's widened last window may read.
struct Layout {
  size_t ready, counts, cursor, zeroed, slab_start, item_start, off, val, total;
};

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

Layout layout_for(long long m, int num_slabs) {
  Layout L;
  L.ready = 256;
  L.counts = align256(L.ready + 4 * (size_t)num_slabs);
  L.cursor = align256(L.counts + 4 * (size_t)num_slabs);
  L.zeroed = align256(L.cursor + 4 * (size_t)num_slabs);
  L.slab_start = L.zeroed;
  L.item_start = align256(L.slab_start + 4 * ((size_t)num_slabs + 1));
  L.off = align256(L.item_start + 4 * ((size_t)num_slabs + 1));
  L.val = align256(L.off + 2 * (size_t)m);
  L.total = align256(L.val + 4 * (size_t)m) + 256;
  return L;
}

template <typename T, int OP>
int reduce_launch(const Layout& L, unsigned char* base, int num_slabs, long long chunk, int n,
                  int shift, T ident, T* out, long long m, cudaStream_t s) {
  auto kernel = slab_reduce_kernel<T, OP>;
  const size_t smem = reduce_smem<T>(shift);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRedThreads, smem);
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * pb_num_sms();
  const long long most = num_slabs + m / chunk;  // the longest possible work list
  if (blocks > most) blocks = most;
  kernel<<<(unsigned)blocks, kRedThreads, smem, s>>>(
      reinterpret_cast<const unsigned short*>(base + L.off),
      reinterpret_cast<const T*>(base + L.val), reinterpret_cast<const int*>(base + L.slab_start),
      reinterpret_cast<const int*>(base + L.item_start), num_slabs, chunk, n, shift, ident, out,
      reinterpret_cast<int*>(base + L.ready), reinterpret_cast<unsigned*>(base));
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
  if (shift < 8 || shift > 15 || chunk <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  // the bulk copies read idx and val from 16-byte boundaries (the wrapper
  // passes an aligned copy of a view that starts elsewhere)
  if ((reinterpret_cast<unsigned long long>(idx) | reinterpret_cast<unsigned long long>(val)) & 15)
    return (int)cudaErrorMisalignedAddress;
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
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slab_bin_kernel, kBinThreads, smem);
  const long long tiles = (m + kBinTile - 1) / kBinTile;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * pb_num_sms();
  if (blocks > tiles) blocks = tiles;
  slab_bin_kernel<<<(unsigned)blocks, kBinThreads, smem, s>>>(
      idx, static_cast<const unsigned*>(val), m, tiles, n, shift, B, chunk,
      reinterpret_cast<const int*>(base + L.counts), reinterpret_cast<int*>(base + L.cursor),
      reinterpret_cast<int*>(base + L.slab_start), reinterpret_cast<int*>(base + L.item_start),
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

// The on-chip variant of csrc/fused.cu's two-pass design, measured by
// scripts/torch_pb_kernels.py (the variant "onchip": this text goes into a
// copy of fused.cu, before the end of its anonymous namespace, and the
// two-pass entry calls onchip instead of two_pass). It is not shipped.
//
// Every slab's accumulator stays in the shared memory of one persistent
// block for the whole call (block g owns slabs g, g + grid, ...), and the
// stream goes through in chunks of kOcChunk tuples: the blocks bin a chunk
// into one half of a double-buffered scratch (12 MB a half, so it stays in
// the 50 MB L2), meet at a grid barrier, and each reduces its own slabs'
// runs of that chunk into shared memory. The next chunk bins into the other
// half, so one barrier a chunk suffices: the chunk after that comes after
// the next barrier, which a block reaches only after its reduce. HBM
// carries the tuples once (8m), the output once (4n) and a count pass
// (4m, counts per chunk and slab). Applies where ceil(slabs / blocks) slabs
// and a tile fit a block's shared memory (S2: 2 slabs of 64 KB a block);
// elsewhere it returns cudaErrorInvalidValue. The launch is cooperative, so
// every block is resident and the barrier cannot hang.

constexpr int kOcThreads = 1024;
constexpr int kOcItems = 8;
constexpr int kOcTile = kOcThreads * kOcItems;  // 8192 tuples
constexpr long long kOcChunk = 1LL << 21;       // tuples a chunk
constexpr size_t kOcSmemMax = 227 * 1024;

// [0] ns blocks waited at the barriers, summed; [1] ns the blocks ran,
// summed; [2] barriers a block crossed
__device__ unsigned long long pb_onchip_ns[4];

__global__ void __launch_bounds__(kCountThreads)
chunk_count_kernel(const int* __restrict__ idx, long long m, int n, int shift,
                   int* __restrict__ counts, int num_slabs) {
  extern __shared__ int h[];
  for (int b = threadIdx.x; b < num_slabs; b += kCountThreads) h[b] = 0;
  __syncthreads();
  const long long c0 = (long long)blockIdx.y * kOcChunk;
  const long long c1 = c0 + kOcChunk < m ? c0 + kOcChunk : m;
  for (long long i = c0 + (long long)blockIdx.x * kCountThreads + threadIdx.x; i < c1;
       i += (long long)gridDim.x * kCountThreads) {
    const int k = __ldcs(idx + i);
    if ((unsigned)k < (unsigned)n) atomicAdd(&h[k >> shift], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_slabs; b += kCountThreads)
    if (h[b]) atomicAdd(&counts[(size_t)blockIdx.y * num_slabs + b], h[b]);
}

__device__ __forceinline__ void oc_grid_sync(int* bar, int target, unsigned long long* wait) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer();
    __threadfence();
    atomicAdd(bar, 1);
    while (os::load_acquire(bar) < target)
      if (globaltimer() - t0 > 10000000000ull) __trap();  // a fault, not a wait: fail the launch
    *wait += globaltimer() - t0;
  }
  __syncthreads();
}

size_t onchip_smem(int per_block, int shift, int num_slabs, size_t tsize) {
  return ((size_t)per_block << shift) * tsize + (size_t)kOcTile * 8 + (4 * (size_t)num_slabs + 1) * 4;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kOcThreads, 1)
onchip_kernel(const int* __restrict__ idx, const T* __restrict__ val, long long m, int n,
              int shift, int num_slabs, int per_block, T ident, const int* __restrict__ counts,
              int* __restrict__ cursor, int* __restrict__ bar, unsigned short* __restrict__ buf_off,
              T* __restrict__ buf_val, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int B = num_slabs, S = 1 << shift, tid = threadIdx.x;
  T* acc = reinterpret_cast<T*>(sh_raw);
  int* st_idx = reinterpret_cast<int*>(sh_raw + ((size_t)per_block << shift) * sizeof(T));
  T* st_val = reinterpret_cast<T*>(st_idx + kOcTile);
  int* s_start = reinterpret_cast<int*>(st_val + kOcTile);  // [B + 1] the chunk's slab starts
  int* s_tot = s_start + B + 1;  // [B] the tile's count
  int* s_cur = s_tot + B;        // [B] the tile's staged starts
  int* s_dst = s_cur + B;        // [B] the run's destination - its staged start
  __shared__ int s_warp[kOcThreads / 32 + 1];
  unsigned long long wait = 0;
  const unsigned long long k0 = globaltimer();
  for (int j = tid; j < per_block * S; j += kOcThreads) acc[j] = ident;
  const long long chunks = (m + kOcChunk - 1) / kOcChunk;
  for (long long c = 0; c < chunks; ++c) {
    __syncthreads();  // the last reduce has read s_start
    for (int b = tid; b < B; b += kOcThreads) s_start[b] = counts[c * B + b];
    __syncthreads();
    const int total = os::block_exclusive_scan(s_start, B, s_warp);
    if (tid == 0) s_start[B] = total;
    unsigned short* boff = buf_off + (c & 1) * kOcChunk;
    T* bval = buf_val + (c & 1) * kOcChunk;
    int* cur = cursor + c * B;
    const long long c0 = c * kOcChunk;
    const long long len_c = m - c0 < kOcChunk ? m - c0 : kOcChunk;
    const long long tiles = (len_c + kOcTile - 1) / kOcTile;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long t0 = c0 + t * kOcTile;
      const int len = (int)(c0 + len_c - t0 < kOcTile ? c0 + len_c - t0 : kOcTile);
      int id[kOcItems], rank[kOcItems];
      T v[kOcItems];
#pragma unroll
      for (int j = 0; j < kOcItems; ++j) {
        const int i = j * kOcThreads + tid;
        id[j] = i < len ? __ldcs(idx + t0 + i) : -1;
        v[j] = i < len ? __ldcs(val + t0 + i) : T(0);
      }
      for (int b = tid; b < B; b += kOcThreads) s_tot[b] = 0;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kOcItems; ++j)
        rank[j] = slab_atomic(s_tot, (unsigned)id[j] < (unsigned)n ? id[j] >> shift : B, B);
      __syncthreads();
      for (int b = tid; b < B; b += kOcThreads) {
        const int k = s_tot[b];
        s_dst[b] = s_start[b] + (k ? atomicAdd(&cur[b], k) : 0);
        s_cur[b] = k;
      }
      __syncthreads();
      const int staged = os::block_exclusive_scan(s_cur, B, s_warp);
#pragma unroll
      for (int j = 0; j < kOcItems; ++j) {
        const int b = (unsigned)id[j] < (unsigned)n ? id[j] >> shift : B;
        if (b < B) {
          const int slot = s_cur[b] + rank[j];
          st_idx[slot] = id[j];
          st_val[slot] = v[j];
        }
      }
      for (int b = tid; b < B; b += kOcThreads) s_dst[b] -= s_cur[b];
      __syncthreads();
      for (int i = tid; i < staged; i += kOcThreads) {
        const int k = st_idx[i];
        const int d = s_dst[k >> shift] + i;
        boff[d] = (unsigned short)(k & (S - 1));
        bval[d] = st_val[i];
      }
      __syncthreads();
    }
    oc_grid_sync(bar, (int)((c + 1) * gridDim.x), &wait);  // chunk c is binned
    for (int p = 0; p < per_block; ++p) {
      const int b = blockIdx.x + p * gridDim.x;
      if (b >= B) break;
      T* mine = acc + ((size_t)p << shift);
      for (int i = s_start[b] + tid; i < s_start[b + 1]; i += kOcThreads)
        acc_apply<OP>(&mine[__ldcg(boff + i)], __ldcg(bval + i));
    }
  }
  __syncthreads();
  for (int p = 0; p < per_block; ++p) {
    const long long b = blockIdx.x + (long long)p * gridDim.x;
    if (b >= B) break;
    const int len = (int)(n - (b << shift) < S ? n - (b << shift) : S);
    for (int j = tid; j < len; j += kOcThreads) out[(b << shift) + j] = acc[((size_t)p << shift) + j];
  }
  if (tid == 0) {
    atomicAdd(&pb_onchip_ns[0], wait);
    atomicAdd(&pb_onchip_ns[1], globaltimer() - k0);
    atomicAdd(&pb_onchip_ns[2], (unsigned long long)chunks);
  }
}

size_t onchip_scratch(long long m, int num_slabs) {
  const long long chunks = (m + kOcChunk - 1) / kOcChunk;
  return 256 + align256(8 * (size_t)chunks * num_slabs) + 2 * (size_t)kOcChunk * 8 + 256;
}

template <typename T, int OP>
int onchip_launch(const int* idx, const T* val, long long m, T* out, int n, int shift, int B,
                  T ident, unsigned char* base, cudaStream_t s) {
  const long long chunks = (m + kOcChunk - 1) / kOcChunk;
  int* bar = reinterpret_cast<int*>(base);
  int* counts = reinterpret_cast<int*>(base + 256);
  int* cursor = counts + chunks * B;
  unsigned short* boff =
      reinterpret_cast<unsigned short*>(base + 256 + align256(8 * (size_t)chunks * B));
  T* bval = reinterpret_cast<T*>(boff + 2 * kOcChunk);
  cudaMemsetAsync(base, 0, 256 + 8 * (size_t)chunks * B, s);
  const int sms = pb_num_sms();
  const unsigned gx = (unsigned)(4 * sms / chunks > 0 ? 4 * sms / chunks : 1);
  chunk_count_kernel<<<dim3(gx, (unsigned)chunks), kCountThreads, B * sizeof(int), s>>>(
      idx, m, n, shift, counts, B);
  auto kernel = onchip_kernel<T, OP>;
  int grid = sms;
  const int per_block = (B + grid - 1) / grid;
  const size_t smem = onchip_smem(per_block, shift, B, sizeof(T));
  if (smem > kOcSmemMax) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kOcThreads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  int np = n, sh = shift, pb = per_block;
  void* args[] = {&idx, &val, &m, &np, &sh, &B, &pb, &ident, &counts, &cursor, &bar, &boff, &bval,
                  &out};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kOcThreads), args,
                                          smem, s);
}

template <typename T>
int onchip_op(int op, const int* idx, const T* val, long long m, T* out, int n, int shift, int B,
              unsigned char* base, cudaStream_t s) {
  if (op == kAdd) return onchip_launch<T, kAdd>(idx, val, m, out, n, shift, B, T(0), base, s);
  if (op == kMin)
    return onchip_launch<T, kMin>(idx, val, m, out, n, shift, B, std::numeric_limits<T>::max(),
                                  base, s);
  return onchip_launch<T, kMax>(idx, val, m, out, n, shift, B, std::numeric_limits<T>::lowest(),
                                base, s);
}

int onchip(const int* idx, const void* val, long long m, void* out, int n, int op, int dtype,
           int shift, long long, void* scratch, cudaStream_t s) {
  if (shift < 8 || shift > 15 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long slabs = (((long long)n - 1) >> shift) + 1;
  if (slabs > os::kMaxBins) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  if (dtype == 0)
    return onchip_op<float>(op, idx, static_cast<const float*>(val), m, static_cast<float*>(out), n,
                            shift, (int)slabs, base, s);
  return onchip_op<int>(op, idx, static_cast<const int*>(val), m, static_cast<int*>(out), n, shift,
                        (int)slabs, base, s);
}

}  // namespace

extern "C" int pb_fused_onchip_stats(unsigned long long* host) {
  cudaMemcpyFromSymbol(host, pb_onchip_ns, sizeof(pb_onchip_ns));
  const unsigned long long zero[4] = {};
  cudaMemcpyToSymbol(pb_onchip_ns, zero, sizeof(zero));
  return (int)cudaGetLastError();
}

namespace {

// Row-block fused bin-and-accumulate (SpMM / GNN aggregation): one sweep of
// an (idx, val) stream whose values are (m, F) rows, reduced by add, min
// or max into a dense out[num_indices, F].
//
// Replaces: src/repro/kernels/fused.py::cobra_bin_accumulate_rows_pallas.
// The TPU kernel keeps a (num_bins, bin_range, f_tile) accumulator in VMEM
// and re-streams the binned indices once per f_tile columns, flushing each
// C-Buffer by a one-hot matmul. On the H100 the accumulator is global
// memory (it is n*F*4 bytes, far past one SM's 227 KB), and f_tile — a VMEM
// fit — has no role: the wrapper validates it and the kernel ignores it.
// Reading row-major (m, F) values one f_tile-column slice per sweep would
// fetch each row F / f_tile times (at f_tile = 1, 4 bytes at a time).
//
// Bound on the H100: bytes — the 4*m*F bytes of rows and 4*m of indices
// read once, 4*n*F of output written (and initialised by the caller).
//
// Design: the row walks of pb_rows.cuh. Rows of at most 4 lanes (F <= 16
// with 16-byte loads: fig9's F = 1 and 8) take the narrow walk, a
// warp-cooperative segmented scan over 32 / lpr rows a step, so that a
// short row is not a long chain of dependent loads in one thread; a run
// of equal destinations is combined in registers and applied with one
// atomic per column (float min/max by pb_common.cuh's sign-split int/uint
// atomics). Wider rows (the GNN layer's F = 64, fig9's 32 and 128, the
// embedding backward's 1536 and 4096) take the tile walk: a block stages
// a 512-row tile's indices once in shared memory, sorts them by
// destination unless they already are, cuts the list into run-aligned
// segments for its lane groups, gathers four rows a lane before folding
// them, joins the pieces of a run cut between segments in shared memory,
// and applies a float32 add with one float4 reduction per run and 4
// columns. A destination-sorted stream (the GNN and fig9 streams,
// sorted_within = 1) therefore costs one reduction per (tile,
// destination) and column group; repeated destinations in an unsorted
// tile combine too; any order is right. Row offsets are 64-bit: m * F
// may exceed 2^31. Indices outside [0, num_indices), negative ones
// included, are dropped.
//
// bfloat16 rows (the MoE combine's weighted expert rows, F = 4096): read as
// bfloat16, combined in float32 registers and applied with float32 atomics
// to a float32 accumulator the wrapper allocates, then rounded once to
// bfloat16 by a second kernel (round to nearest even). No bfloat16 atomic
// touches the output, so the rounding does not depend on the order of the
// atomics. On the combine's token-ordered stream each token is one run of
// k = 8 rows inside one (already ordered) tile, so each accumulator column
// gets one reduction, or two where a run crosses a tile edge.
// Bound: 2*m*F bytes of rows and 4*m of indices read, 2*n*F written; the
// accumulator adds 4*n*F written and read, and its fill.
#include <cuda_bf16.h>

#include "pb_common.cuh"
#include "pb_rows.cuh"

namespace {

using namespace pb;

template <typename T>
int launch(int op, cudaStream_t s, const int* idx, const void* val, long long m, int F,
           void* out, int num_indices) {
  const T* v = static_cast<const T*>(val);
  T* o = static_cast<T*>(out);
  if (op == kAdd) return launch_rows<T, T, kAdd>(s, idx, v, m, F, o, num_indices);
  if (op == kMin) return launch_rows<T, T, kMin>(s, idx, v, m, F, o, num_indices);
  return launch_rows<T, T, kMax>(s, idx, v, m, F, o, num_indices);
}

constexpr int kCastThreads = 256;

// out[i] = bfloat16(acc[i]), round to nearest even, four at a time.
__global__ void __launch_bounds__(kCastThreads)
f32_to_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = n / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(acc)[i];
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + 4 * i);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16_rn(acc[i]);
}

}  // namespace

// op: 0 add, 1 min, 2 max. dtype: 0 float32, 1 int32. val is (m, F) and
// out (num_indices, F), both row-major; `out` holds the op's identity on
// entry.
extern "C" int pb_fused_accumulate_rows(const int* idx, const void* val, long long m,
                                        int F, void* out, int num_indices, int op,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || F <= 0) return (int)cudaGetLastError();
  if (op < 0 || op > 2 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(op, s, idx, val, m, F, out, num_indices);
  return launch<int>(op, s, idx, val, m, F, out, num_indices);
}

// bfloat16 rows: val (m, F) bfloat16, acc (num_indices, F) float32 holding
// the op's identity on entry, out (num_indices, F) bfloat16, all row-major.
// Reduces into acc in float32, then rounds acc into out once.
extern "C" int pb_fused_accumulate_rows_bf16(const int* idx, const void* val, long long m,
                                             int F, float* acc, void* out, int num_indices,
                                             int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(val);
  if (m > 0 && F > 0) {
    using B = __nv_bfloat16;
    const int rc =
        op == pb::kAdd   ? launch_rows<B, float, pb::kAdd>(s, idx, v, m, F, acc, num_indices)
        : op == pb::kMin ? launch_rows<B, float, pb::kMin>(s, idx, v, m, F, acc, num_indices)
                         : launch_rows<B, float, pb::kMax>(s, idx, v, m, F, acc, num_indices);
    if (rc != 0) return rc;
  }
  const long long n = (long long)num_indices * F;
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n / 4 + kCastThreads - 1) / kCastThreads;
  const long long cap = 16LL * pb_num_sms();  // grid-stride: a few waves
  blocks = blocks < 1 ? 1 : blocks > cap ? cap : blocks;
  f32_to_bf16_kernel<<<(unsigned)blocks, kCastThreads, 0, s>>>(
      acc, static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}

// Bin-Read scatter-add of a padded bin layout:
//   out[idx[b, l], :] += val[b, l, :]  for idx[b, l] in [0, B * R);
// padding (-1) is dropped and rows no tuple reaches are zero.
//
// Replaces: src/repro/kernels/binread.py::binread_scatter_add_pallas. The
// TPU kernel gives each bin one grid step, keeps the bin's (R, d) output
// slab in VMEM and adds the bin's rows with one (R, L) @ (L, d) one-hot
// matmul in float32. On the H100 a slab (4 MB at R = 4096, d = 256) is far
// past the 227 KB of shared memory a block has, and one bin may hold nearly
// all rows (260,808 of 262,144 in the zipf embedding-gradient stream), so
// one block per bin would serialise on it. So the (B, L) rows are split
// across blocks without regard to bins, and every block adds into a
// float32 accumulator in global memory; one bin's slab is what the
// atomics touch, and it sits in the 50 MB L2.
//
// Bound on the H100: bytes — the 4*B*L indices and the values of the real
// (non-padding) rows read once, B*R*d outputs written (and zeroed by the
// caller).
//
// Design: the row walk of pb_rows.cuh over the (B * L, d) rows, as in
// fused_rows.cu — a group of lanes spans a row (one 16-byte float32 or
// 8-byte bf16 load per lane), walks a chunk of rows and combines a run of
// equal indices in registers before one atomicAdd per column, so
// duplicates within a bin coalesce before they reach memory. Padding rows
// cost only their index. bf16 rows are accumulated in float32 (the
// caller's scratch) and then rounded once into the bf16 output by
// bf16_store_kernel, as the TPU kernel's preferred_element_type=float32
// dot is.
#include <cuda_bf16.h>

#include "pb_common.cuh"
#include "pb_rows.cuh"

namespace {

__global__ void bf16_store_kernel(const float* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16(acc[i]);
}

}  // namespace

// idx (B, L) int32, val (B, L, d) row-major; dtype 0 float32, 1 bfloat16.
// `acc` is a zeroed float32 (B*R, d) buffer: the output itself for float32,
// scratch for bfloat16, whose result goes to `out` (B*R, d).
extern "C" int pb_binread_scatter_add(const int* idx, const void* val, long long rows,
                                      int d, long long out_rows, float* acc, void* out,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (rows > 0 && d > 0) {
    const int st =
        dtype == 0
            ? launch_rows<float, float, pb::kAdd>(s, idx, static_cast<const float*>(val), rows,
                                                  d, acc, out_rows)
            : launch_rows<__nv_bfloat16, float, pb::kAdd>(
                  s, idx, static_cast<const __nv_bfloat16*>(val), rows, d, acc, out_rows);
    if (st != 0) return st;
  }
  if (dtype == 1 && out_rows > 0 && d > 0) {
    const long long n = out_rows * d;
    long long blocks = (n + 255) / 256;
    const long long cap = 16LL * pb_num_sms();
    bf16_store_kernel<<<(unsigned)(blocks < cap ? blocks : cap), 256, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(out), n);
  }
  return (int)cudaGetLastError();
}

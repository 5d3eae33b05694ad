// Row scatter: out[pos[i], :] = x[i, :] for every pos[i] in [0, out_rows);
// pos[i] = -1 drops row i, and rows no position names stay zero (the
// caller zeroes `out`).
//
// Replaces: src/repro/kernels/scatter_rows.py::scatter_rows_pallas, which
// walks each block's rows one at a time and stores each as a full
// VREG-line copy into an output that stays whole in VMEM, relying on
// grid steps that run in order.
//
// Bound on the H100: bytes — 4*m positions and m*d*itemsize of rows read,
// the same row bytes written (plus the zeroed output).
//
// Design: a row is row_bytes / W words of W bytes (W = 16 when the row
// width and both pointers allow it, else 4, else 2), and the (m, words)
// grid of words is walked flat by a grid-stride loop: consecutive threads
// copy consecutive words of a row, so both the read and the write of a
// row are coalesced. The payload is copied as bits, so float32, bfloat16
// and int32 rows take the same kernel. Positions are meant to be
// distinct, as the counting-sort destinations that feed it are. If two
// rows name one position, each of its W-byte words comes from one of
// them, chosen by the race: the row may mix the two.
#include <cstdint>

#include "pb_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const W* __restrict__ x, const int* __restrict__ pos, long long m,
                    long long words, W* __restrict__ out, long long out_rows) {
  const long long total = m * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long i = e / words;
    const long long p = __ldg(pos + i);
    if (p < 0 || p >= out_rows) continue;
    out[p * words + (e - i * words)] = __ldg(x + e);
  }
}

template <typename W>
void launch(cudaStream_t s, const void* x, const int* pos, long long m, long long row_bytes,
            void* out, long long out_rows) {
  const long long words = row_bytes / (long long)sizeof(W);
  const long long total = m * words;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 32LL * pb_num_sms();
  scatter_rows_kernel<W><<<(unsigned)(blocks < cap ? blocks : cap), kThreads, 0, s>>>(
      static_cast<const W*>(x), pos, m, words, static_cast<W*>(out), out_rows);
}

}  // namespace

// x (m, row_bytes) and out (out_rows, row_bytes) as raw bytes, row-major.
// row_bytes must be a multiple of 2.
extern "C" int pb_scatter_rows(const void* x, const int* pos, long long m,
                               long long row_bytes, void* out, long long out_rows,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || row_bytes <= 0 || out_rows <= 0) return (int)cudaGetLastError();
  if (row_bytes % 2) return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && a % 16 == 0)
    launch<uint4>(s, x, pos, m, row_bytes, out, out_rows);
  else if (row_bytes % 4 == 0 && a % 4 == 0)
    launch<unsigned>(s, x, pos, m, row_bytes, out, out_rows);
  else
    launch<unsigned short>(s, x, pos, m, row_bytes, out, out_rows);
  return (int)cudaGetLastError();
}

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
// Design: the row walks of pb_rows.cuh. A group of lanes spans a row with
// 16-byte loads and a run of equal destinations is combined in registers,
// then applied with one atomic per column (float min/max by
// pb_common.cuh's sign-split int/uint atomics). Rows of at most 4 lanes
// (F <= 16 with 16-byte loads: fig9's F = 1 and 8) take the narrow walk,
// a warp-cooperative segmented scan over 32 / lpr rows a step, so that a
// short row is not a long chain of dependent loads in one thread; wider
// rows (the GNN layer's F = 64, fig9's 32 and 128) walk a 64-row chunk
// per group of lanes. A destination-sorted stream (the GNN and fig9
// streams, sorted_within = 1) therefore costs one atomic per column per
// (chunk, destination) pair; any other order is still right, with more
// atomics. Row offsets are 64-bit: m * F may exceed 2^31. Indices outside
// [0, num_indices), negative ones included, are dropped.
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

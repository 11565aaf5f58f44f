// Sorted segment sum for the hash-grid backward, written for Hopper (sm_90a).
//
// Replaces the TPU kernel neus2_tpu/ops/segment_tile.py::_packed_kernel
// (launched by sorted_segment_sum_tiles_packed_planar).  Both compute, for
// every table row r of every level,
//
//     out[r, f] = sum of upd[m, f] over the updates m whose index is r,
//
// with updates quantized to bf16 and sums in fp32 (the CUDA reference's
// fp16-atomic kernel_grid_backward precision).
//
// Input layout (built by the Python wrapper, ops/segment_tile.py):
//   * the updates of all levels, sorted by a global row key (level row
//     offset + index) with a stable sort, as bf16 (n_upd, F) rows;
//   * bounds (n_rows + 1) int32: updates of row r are [bounds[r], bounds[r+1]).
// Output: (n_rows, F) fp32, every row written (a row without updates is
// exactly 0.0, which the optimizer's lazy skip keys off).
//
// Design: one warp per output row.  Lanes stride the row's contiguous
// segment, each lane accumulates in registers, and a fixed shuffle tree
// reduces the 32 partial sums, so every row's summation order depends only
// on the sorted stream: the result is bitwise the same from run to run.
// No atomics, no shared memory.  What bounds it on the card is memory
// traffic: the 2F B bf16 payload of each update and the 4 B bound of each
// row are read once, and each 4F B output row is written once (the 4 B
// keys were consumed by the sort before the launch).  Rows of
// the hashed levels hold ~4 updates, so most lanes of a warp idle there;
// a later version can give a warp several short rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int F>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_rows_kernel(const int32_t* __restrict__ bounds,
                        const __nv_bfloat16* __restrict__ upd,
                        float* __restrict__ out, int64_t n_rows) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // `row` is the same for all 32 lanes, so a warp leaves as a whole and the
  // full-mask shuffles below always see every lane.
  if (row >= n_rows) return;
  const int64_t begin = bounds[row];
  const int64_t end = bounds[row + 1];

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  for (int64_t m = begin + lane; m < end; m += 32) {
    const __nv_bfloat16* src = upd + m * F;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += __bfloat162float(src[f]);
  }

#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      acc[f] += __shfl_down_sync(0xffffffffu, acc[f], offset);
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) out[row * F + f] = acc[f];
  }
}

template <int F>
cudaError_t launch(const int32_t* bounds, const __nv_bfloat16* upd, float* out,
                   int64_t n_rows, cudaStream_t stream) {
  const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_rows_kernel<F><<<static_cast<unsigned int>(blocks),
                               32 * kWarpsPerBlock, 0, stream>>>(
      bounds, upd, out, n_rows);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Returns a cudaError_t (0 = launched).
extern "C" int segment_sum_rows(const void* bounds, const void* upd, void* out,
                                long long n_rows, int n_features,
                                void* stream) {
  if (n_rows <= 0) return 0;
  const auto* b = static_cast<const int32_t*>(bounds);
  const auto* u = static_cast<const __nv_bfloat16*>(upd);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_features) {
    case 2: return launch<2>(b, u, o, n_rows, s);
    case 8: return launch<8>(b, u, o, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

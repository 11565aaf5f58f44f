// Sorted segment sums, written for Hopper (sm_90a).
//
// Replaces the four TPU kernels of neus2_tpu/ops/segment_tile.py.  Each
// computes, for every row r of every level l of a sorted update stream,
//
//     out[l, r, f] = sum of payload[l, f, m] over the updates m whose index is r,
//
// in fp32.  They differ only in how the payload is stored and rounded, so
// this file has ONE kernel body, templated on a payload loader:
//
//   entry point (extern "C")  loader        TPU kernel it replaces
//   segment_sum_rows          Bf16Rows      _packed_kernel (:376) via
//                                           sorted_segment_sum_tiles_packed_planar
//   segment_sum_packed        PackedPairs   _packed_kernel (:376) via
//                                           sorted_segment_sum_tiles_packed
//   segment_sum_batched       Planar<true>  _batched_kernel (:211)
//   segment_sum_planar        Planar<false> _tile_kernel (:75)
//
//   * Bf16Rows: (n_upd, F) bf16 rows, all levels in one stream sorted by a
//     global row key (the hash-grid backward's layout, ops/segment_tile.py).
//   * PackedPairs: (L, P, Mp) int32, each int32 two bf16 channels (channel
//     2k in the low half, 2k+1 in the high half), split in registers.
//   * Planar<true>: (L, F, Mp) fp32, each value rounded to bf16 on load, as
//     the TPU kernel rounds its matmul operand (segment_tile.py:246-249).
//   * Planar<false>: (F, M) fp32, summed exactly in fp32 (one level).
//
// Row bounds come from the wrapper: bounds[l, r] .. bounds[l, r + 1] is row
// r's slice of level l's sorted stream ((L, n_rows + 1) int32, from
// torch.searchsorted; the 2^31 - 1 padding of the TPU layout falls past the
// last bound and is never read).
//
// Design: one warp per output row.  Lanes stride the row's contiguous
// slice (neighbouring lanes on neighbouring addresses: every load is
// coalesced), each lane accumulates in registers, and a fixed shuffle tree
// reduces the 32 partial sums, so a row's summation order depends only on
// the sorted stream and the result is bitwise the same from run to run.
// No atomics, no shared memory, every row written (a row without updates is
// exactly 0.0, which the optimizer's lazy skip keys off).  None of the TPU
// kernels' tiles, one-hot matmuls or DMA windows carry over: they were TPU
// constraints, and on this card there is no capacity limit either (the TPU
// _tile_kernel silently drops a tile's updates past its DMA window).
//
// What bounds it on the card is memory traffic: each update's payload and
// each row's bound are read once, each fp32 output row written once.  Rows
// of hashed levels hold ~4 updates, so most lanes of a warp idle there; a
// later version can give a warp several short rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// (n_upd, F) bf16 rows; one level (the caller folds levels into global rows).
template <int F>
struct Bf16Rows {
  const __nv_bfloat16* upd;
  __device__ __forceinline__ void add(int64_t, int64_t m, float (&acc)[F]) const {
    const __nv_bfloat16* src = upd + m * F;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += __bfloat162float(src[f]);
  }
};

// (L, F / 2, Mp) int32 of packed bf16 pairs.
template <int F>
struct PackedPairs {
  const uint32_t* packed;
  int64_t m_pad;
  __device__ __forceinline__ void add(int64_t level, int64_t m, float (&acc)[F]) const {
    constexpr int P = F / 2;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const uint32_t w = packed[(level * P + k) * m_pad + m];
      acc[2 * k] += bf16_bits_to_float(w & 0xffffu);
      acc[2 * k + 1] += bf16_bits_to_float(w >> 16);
    }
  }
};

// (L, F, Mp) fp32, optionally rounded to bf16 (round to nearest even).
template <int F, bool kRoundBf16>
struct Planar {
  const float* vals;
  int64_t m_pad;
  __device__ __forceinline__ void add(int64_t level, int64_t m, float (&acc)[F]) const {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float v = vals[(level * F + f) * m_pad + m];
      if (kRoundBf16) v = __bfloat162float(__float2bfloat16_rn(v));
      acc[f] += v;
    }
  }
};

// One warp per (level, row): blockIdx.y is the level, so no warp divides to
// find it.  out is (L, n_rows, F) row-major.
template <int F, class Load>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_kernel(const int32_t* __restrict__ bounds, Load load,
                   float* __restrict__ out, int64_t n_rows) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // `row` is the same for all 32 lanes, so a warp leaves as a whole and the
  // full-mask shuffles below always see every lane.
  if (row >= n_rows) return;
  const int64_t level = blockIdx.y;
  const int32_t* b = bounds + level * (n_rows + 1) + row;
  const int64_t begin = b[0];
  const int64_t end = b[1];

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int64_t m = begin + lane; m < end; m += 32) load.add(level, m, acc);

#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      acc[f] += __shfl_down_sync(0xffffffffu, acc[f], offset);
  }
  if (lane == 0) {
    float* o = out + (level * n_rows + row) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

template <int F, class Load>
int launch(const void* bounds, Load load, void* out, int64_t n_levels,
           int64_t n_rows, void* stream) {
  if (n_levels <= 0 || n_rows <= 0) return 0;
  if (n_levels > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  static_cast<unsigned int>(n_levels));
  segment_sum_kernel<F, Load>
      <<<grid, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(bounds), load, static_cast<float*>(out), n_rows);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadWidth = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Plain C entry points for ctypes.  Each returns a cudaError_t (0 = launched).
// F is 2 or 8 (configs/base.json and configs/l4f8.json).

// Kernel 1: all levels in one global-row stream of (n_upd, F) bf16 rows;
// bounds (n_rows + 1); out (n_rows, F).
extern "C" int segment_sum_rows(const void* bounds, const void* upd, void* out,
                                long long n_rows, int n_features,
                                void* stream) {
  const auto* u = static_cast<const __nv_bfloat16*>(upd);
  switch (n_features) {
    case 2: return launch<2>(bounds, Bf16Rows<2>{u}, out, 1, n_rows, stream);
    case 8: return launch<8>(bounds, Bf16Rows<8>{u}, out, 1, n_rows, stream);
    default: return kBadWidth;
  }
}

// Kernel 2: packed (L, F/2, Mp) int32; bounds (L, n_rows + 1); out (L, n_rows, F).
extern "C" int segment_sum_packed(const void* bounds, const void* packed,
                                  void* out, long long n_levels,
                                  long long n_rows, long long m_pad,
                                  int n_features, void* stream) {
  const auto* p = static_cast<const uint32_t*>(packed);
  switch (n_features) {
    case 2: return launch<2>(bounds, PackedPairs<2>{p, m_pad}, out, n_levels, n_rows, stream);
    case 8: return launch<8>(bounds, PackedPairs<8>{p, m_pad}, out, n_levels, n_rows, stream);
    default: return kBadWidth;
  }
}

// Kernel 3: fp32 (L, F, Mp) rounded to bf16 on load; bounds (L, n_rows + 1);
// out (L, n_rows, F).
extern "C" int segment_sum_batched(const void* bounds, const void* vals,
                                   void* out, long long n_levels,
                                   long long n_rows, long long m_pad,
                                   int n_features, void* stream) {
  const auto* v = static_cast<const float*>(vals);
  switch (n_features) {
    case 2: return launch<2>(bounds, Planar<2, true>{v, m_pad}, out, n_levels, n_rows, stream);
    case 8: return launch<8>(bounds, Planar<8, true>{v, m_pad}, out, n_levels, n_rows, stream);
    default: return kBadWidth;
  }
}

// Kernel 4: one level of fp32 (F, M), exact; bounds (n_rows + 1); out (n_rows, F).
extern "C" int segment_sum_planar(const void* bounds, const void* vals,
                                  void* out, long long n_rows, long long m,
                                  int n_features, void* stream) {
  const auto* v = static_cast<const float*>(vals);
  switch (n_features) {
    case 2: return launch<2>(bounds, Planar<2, false>{v, m}, out, 1, n_rows, stream);
    case 8: return launch<8>(bounds, Planar<8, false>{v, m}, out, 1, n_rows, stream);
    default: return kBadWidth;
  }
}

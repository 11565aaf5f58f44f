// Sorted segment sums, written for Hopper (sm_90a).
//
// Replaces the four TPU kernels of neus2_tpu/ops/segment_tile.py.  Each
// computes, for every row r of every level l of a sorted update stream,
//
//     out[l, r, f] = sum of payload[l, f, m] over the updates m whose key is r,
//
// in fp32.  They differ only in how the payload is stored and rounded, so
// ONE kernel body (stream_sum_kernel and its fixup pass) serves all four,
// templated on a payload loader:
//
//   entry point (extern "C")  loader         TPU kernel it replaces
//   segment_sum_rows          Bf16Rows       _packed_kernel (:376) via
//                                            sorted_segment_sum_tiles_packed_planar
//   segment_sum_planar        Planar<false>  _tile_kernel (:75)
//   segment_sum_packed        PackedPairs    _packed_kernel (:376) via
//                                            sorted_segment_sum_tiles_packed
//   segment_sum_batched       Planar<true>   _batched_kernel (:211)
//
//   * Bf16Rows: (M, F) bf16 rows, all levels in one stream sorted by a
//     global row key (the hash-grid backward's layout, ops/segment_tile.py).
//   * Planar<false>: (F, M) fp32, summed exactly in fp32 (one level).
//   * PackedPairs: (L, F / 2, Mp) int32, each int32 two bf16 channels
//     (channel 2k in the low half, 2k + 1 in the high half), split in
//     registers.
//   * Planar<true>: (L, F, Mp) fp32, each value rounded to bf16 on load (to
//     nearest even), as the TPU kernel rounds its matmul operand
//     (segment_tile.py:246-249).
//
// Every entry point takes L sorted int32 key streams of Mp keys each, (L,
// Mp) row-major (L = 1 for kernels 1 and 4), and writes (L, n_rows, F)
// fp32.  What bounds every variant on the card is memory traffic: each
// key and payload word read once, each fp32 output row written once.  No
// floating-point atomics anywhere: a row's summation order depends only on
// the sorted stream, so two launches on one input agree bit for bit
// (docs/MIGRATING.md:90), and every row is written (a row without updates
// is exactly 0.0, which the optimizer's lazy skip keys off).  None of the
// TPU kernels' one-hot matmuls or DMA windows carry over: they were TPU
// constraints, and on this card there is no capacity limit either (the TPU
// _tile_kernel silently drops a tile's updates past its DMA window).
//
// The body: a load-balanced reduce-by-key over each sorted key stream; it
// reads the keys itself, so no row bounds are computed in front of it.  Each
// level's stream is cut into tiles of consecutive updates (2,048 at F = 2
// and 4, 1,024 at F = 8), one block a tile, each thread a run of 8 (4 at
// F = 8) of them, read in 16-byte vector loads (keys as int4, bf16 rows as
// uint4, planar fp32 channels as float4, packed pairs as uint4; scalar loads
// where a base pointer or a level's or planar channel's row is not 16-byte
// aligned, and on the ragged last run).  Work per block is the same whatever
// the row lengths: a 4-update hashed row and a 4,096-update dense row cost
// the same per byte.  A head is key[m] != key[m-1].  Each thread sums its
// run serially, a segmented warp scan (__shfl_up_sync over head flags) and a
// carry through shared memory in warp order give every thread the partial
// sum entering its run, and the thread holding a row's last update writes
// the row.  A row that crosses a tile boundary is finished by a second small
// pass (stream_fixup_kernel): the tile holding the row's head adds, in tile
// order, the partials that the following tiles recorded for it, however many
// tiles the row spans.
//
// Levels: block b is tile b % T of level b / T, with T tiles a level, so a
// tile never spans two levels; its keys, payload and output are the
// level's, its level's first tile has no previous key and its last tile
// owns the rows up to the level's n_rows - 1.  A level's last update always
// ends its row, so the fixup pass never carries a row into the next level.
//
// Keys outside [0, n_rows) (the PAD_IDX tail of the JAX layout, anything
// negative) match no row.  The body reads their keys and payload (it cannot
// know where a stream's real updates end without them), but a key change is
// a head, so they sum into segments of their own that are never stored:
// nothing of the padding reaches a row.
//
// Empty rows: each tile owns the rows between the last key of the tile
// before it and its own last key and writes every one of them.  At F = 2
// and 4 it builds them in shared memory (zeros, then its sums) and stores
// them in one coalesced pass, so 8- and 16-byte rows reach L2 as whole
// sectors; at F = 8, or where a gap makes the range longer than a tile, it
// zeroes the range in place before its sums land on it.  The alternative,
// one cudaMemsetAsync of the whole output and then only the sums, writes
// the rows twice and took 6-21% longer for kernels 1 and 4 at F = 2 and 8
// on an H100 80GB HBM3 at 700 W (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
// The body's shape at F channels: kItems consecutive updates a thread
// (fewer at F = 8, so that a run's payload stays in registers), at least
// kMinBlocks blocks resident on an SM (at F = 2 and 8 the fastest of 1-6
// when timed on the H100), and the output rows staged in shared memory when
// a row is narrower than a 32-byte sector (F = 2 and 4), so that they reach
// L2 as whole sectors; an F = 8 row is a whole sector already.
//
// F = 4 (configs/tpu_opt.json) keeps F = 2's 8 updates a thread, so a run
// is 32 payload floats, as at F = 8, and a tile stages 2,048 rows of 16
// bytes: 32 KB beside its 8 KB of keys, 160 KB of the SM's 228 KB at 4
// blocks.  Registers bound it first: 4 blocks of 256 threads leave 64 a
// thread, where ptxas spills a few bytes a thread (its -v report, which
// chip_smoke.py's build prints).  kMinBlocks 4 was the fastest of 3-5 for
// kernel 1 at tpu_opt.json's shape on the H100 (and 4 updates a thread at
// 4-6 blocks no faster).
template <int F>
struct Stream {
  static constexpr int kItems = F >= 8 ? 4 : 8;
  static constexpr int kMinBlocks = F >= 8 ? 3 : (F >= 4 ? 4 : 5);
  static constexpr int64_t kTile = int64_t{kStreamThreads} * kItems;
  static constexpr bool kStageRows = F * sizeof(float) < 32;
};
constexpr int kHasHead = 1;  // tile flag: some row begins inside the tile
constexpr int kOpenOut = 2;  // tile flag: its last row goes on into the next tile

__host__ __device__ __forceinline__ bool is_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Each loader reads one level's payload: at_level(l) (loaders of kernels 2
// and 3) moves it to level l, fetch() loads a thread's run of kItems
// updates as stored, unpack() widens them to fp32 once they are needed, so
// a load in flight holds no instruction up.  aligned(m) says whether every
// run of a stream of m updates a level starts on 16 bytes (given the run
// and tile shape).

// (M, F) bf16 rows of one stream (the caller folds levels into global rows).
template <int F>
struct Bf16Rows {
  const __nv_bfloat16* upd;
  template <int kItems>
  struct Raw {
    uint32_t w[kItems * F / 2];
  };
  // A run's rows are kItems * F bf16 (a multiple of 16 bytes) from an m0
  // that is a multiple of kItems, so an aligned base gives aligned runs.
  __host__ __device__ bool aligned(int64_t) const { return is_aligned16(upd); }
  template <int kItems>
  __device__ __forceinline__ void fetch(int64_t m0, int cnt, bool vec, Raw<kItems>& r) const {
    static_assert(kItems * F % 8 == 0, "a run is a whole number of uint4");
    if (vec && cnt == kItems) {
      const uint4* src = reinterpret_cast<const uint4*>(upd + m0 * F);
#pragma unroll
      for (int q = 0; q < kItems * F / 8; ++q) {
        const uint4 x = __ldcs(src + q);
        r.w[4 * q] = x.x; r.w[4 * q + 1] = x.y; r.w[4 * q + 2] = x.z; r.w[4 * q + 3] = x.w;
      }
    } else {
      const auto* src = reinterpret_cast<const uint16_t*>(upd + m0 * F);
      const int n = cnt * F;
#pragma unroll
      for (int e = 0; e < kItems * F; e += 2)
        r.w[e / 2] = (e < n ? src[e] : 0u) | (e + 1 < n ? uint32_t{src[e + 1]} << 16 : 0u);
    }
  }
  template <int kItems>
  __device__ __forceinline__ void unpack(const Raw<kItems>& r, float (&v)[kItems][F]) const {
#pragma unroll
    for (int e = 0; e < kItems * F; e += 2) {  // channel 2k in the low half
      v[e / F][e % F] = __uint_as_float(r.w[e / 2] << 16);
      v[(e + 1) / F][(e + 1) % F] = __uint_as_float(r.w[e / 2] & 0xffff0000u);
    }
  }
};

// (L, F / 2, Mp) int32 of packed bf16 pairs: pair k of level l is the
// planar row (l * F / 2 + k) * Mp.  The halves are split in registers,
// exactly (a bf16 widens to fp32 without rounding).
template <int F>
struct PackedPairs {
  static constexpr int P = F / 2;
  const uint32_t* packed;
  int64_t m_pad;
  template <int kItems>
  struct Raw {
    uint32_t w[P][kItems];
  };
  __device__ __forceinline__ PackedPairs at_level(int64_t l) const {
    return {packed + l * P * m_pad, m_pad};
  }
  // Pair k's run starts at k * Mp + m0: 16-byte aligned for every k only
  // if Mp is a multiple of 4.
  __host__ __device__ bool aligned(int64_t m) const { return is_aligned16(packed) && m % 4 == 0; }
  template <int kItems>
  __device__ __forceinline__ void fetch(int64_t m0, int cnt, bool vec, Raw<kItems>& r) const {
    static_assert(kItems % 4 == 0, "a pair's run is a whole number of uint4");
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const uint32_t* src = packed + k * m_pad + m0;
      if (vec && cnt == kItems) {
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q) {
          const uint4 x = __ldcs(reinterpret_cast<const uint4*>(src) + q);
          r.w[k][4 * q] = x.x; r.w[k][4 * q + 1] = x.y;
          r.w[k][4 * q + 2] = x.z; r.w[k][4 * q + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kItems; ++i) r.w[k][i] = i < cnt ? src[i] : 0u;
      }
    }
  }
  template <int kItems>
  __device__ __forceinline__ void unpack(const Raw<kItems>& r, float (&v)[kItems][F]) const {
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int i = 0; i < kItems; ++i) {  // channel 2k in the low half
        v[i][2 * k] = __uint_as_float(r.w[k][i] << 16);
        v[i][2 * k + 1] = __uint_as_float(r.w[k][i] & 0xffff0000u);
      }
  }
};

// (L, F, Mp) fp32, optionally rounded to bf16 (round to nearest even).
template <int F, bool kRoundBf16>
struct Planar {
  const float* vals;
  int64_t m_pad;
  template <int kItems>
  struct Raw {
    float w[F][kItems];
  };
  __device__ __forceinline__ static float rounded(float v) {
    return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
  __device__ __forceinline__ Planar at_level(int64_t l) const {
    return {vals + l * F * m_pad, m_pad};
  }
  // Channel f's run starts at f * Mp + m0: 16-byte aligned for every f only
  // if Mp is a multiple of 4.
  __host__ __device__ bool aligned(int64_t m) const { return is_aligned16(vals) && m % 4 == 0; }
  template <int kItems>
  __device__ __forceinline__ void fetch(int64_t m0, int cnt, bool vec, Raw<kItems>& r) const {
    static_assert(kItems % 4 == 0, "a channel's run is a whole number of float4");
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float* src = vals + f * m_pad + m0;
      if (vec && cnt == kItems) {
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q) {
          const float4 x = __ldcs(reinterpret_cast<const float4*>(src) + q);
          r.w[f][4 * q] = x.x; r.w[f][4 * q + 1] = x.y;
          r.w[f][4 * q + 2] = x.z; r.w[f][4 * q + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kItems; ++i) r.w[f][i] = i < cnt ? src[i] : 0.0f;
      }
    }
  }
  template <int kItems>
  __device__ __forceinline__ void unpack(const Raw<kItems>& r, float (&v)[kItems][F]) const {
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int i = 0; i < kItems; ++i) v[i][f] = rounded(r.w[f][i]);
  }
};

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ out, int64_t row,
                                          const float (&s)[F]) {
  float* o = out + row * F;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      reinterpret_cast<float4*>(o)[q] =
          make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int q = 0; q < F / 2; ++q)
      reinterpret_cast<float2*>(o)[q] = make_float2(s[2 * q], s[2 * q + 1]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = s[f];
  }
}

// out[a, b) = src[0, b - a) (zeros without src), by the whole block, in
// float4 stores between scalar ends; out is the whole (16-byte aligned)
// output, and a later level's rows are offsets from it.
__device__ __forceinline__ void write_floats(float* __restrict__ out, int64_t a, int64_t b,
                                             const float* src) {
  const auto at = [&](int64_t g) { return src ? src[g - a] : 0.0f; };
  const int64_t a4 = (a + 3) & ~int64_t{3};
  const int64_t b4 = b & ~int64_t{3};
  if (a4 >= b4) {
    for (int64_t g = a + threadIdx.x; g < b; g += kStreamThreads) out[g] = at(g);
    return;
  }
  if (threadIdx.x < a4 - a) out[a + threadIdx.x] = at(a + threadIdx.x);
  if (threadIdx.x < b - b4) out[b4 + threadIdx.x] = at(b4 + threadIdx.x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t e = a4 / 4 + threadIdx.x; e < b4 / 4; e += kStreamThreads)
    o4[e] = make_float4(at(4 * e), at(4 * e + 1), at(4 * e + 2), at(4 * e + 3));
}

// A key's row for the ownership of empty rows: -1 below the table, n_rows - 1
// at or above its end (monotone, so the tiles' ranges cover every row once).
__device__ __forceinline__ int64_t clamp_row(int32_t key, int64_t n_rows) {
  return key < 0 ? -1 : (key < n_rows ? key : n_rows - 1);
}

// One block per tile of kTile updates of one level: block b is tile b %
// n_tiles of level b / n_tiles, and keys (L, m), out (L, n_rows, F) and the
// loader are moved to that level (kLevels: kernels 2 and 3; kernels 1 and 4
// take one stream and compile without it).  The tile owns the output rows
// after the last key of the tile before it, up to its own last key (the level's last
// tile: up to the table's end), and writes all of them: staged in shared
// memory and stored in one coalesced pass when kStageRows and they are at
// most kTile rows, else zeroed in place before the sums land on them.  part
// is (L * n_tiles, 2, F), indexed by b: [b, 0] the tile's share of a row
// begun in an earlier tile, [b, 1] the share of its last row when that row
// goes on into the next tile; flags (L * n_tiles,) says which (kHasHead,
// kOpenOut).  Only the entries that stream_fixup_kernel reads are written.
template <int F, class Load, bool kLevels>
__global__ void __launch_bounds__(kStreamThreads, Stream<F>::kMinBlocks)
stream_sum_kernel(const int32_t* __restrict__ keys, Load load, float* __restrict__ out,
                  float* __restrict__ part, int32_t* __restrict__ flags, int64_t m,
                  int64_t n_rows, unsigned int n_tiles, bool vec) {
  constexpr int kItems = Stream<F>::kItems;
  constexpr int64_t kTile = Stream<F>::kTile;
  __shared__ __align__(16) int32_t s_keys[kTile];
  __shared__ float s_rows[Stream<F>::kStageRows ? kTile * F : 1];
  __shared__ int32_t s_edge[2];  // the keys just before and just after the tile
  __shared__ int32_t s_wflag[kStreamWarps];
  __shared__ float s_wsum[kStreamWarps][F];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t block = blockIdx.x;
  const unsigned int level = kLevels ? blockIdx.x / n_tiles : 0;
  const int64_t tile = kLevels ? blockIdx.x - level * n_tiles : blockIdx.x;
  const int64_t last_tile = kLevels ? n_tiles - 1 : gridDim.x - 1;
  const int64_t out0 = kLevels ? level * n_rows * F : 0;  // the level's first float of out
  if constexpr (kLevels) keys += level * m;
  const Load lv = [&] {
    if constexpr (kLevels) return load.at_level(level); else return load;
  }();
  const int64_t tile_start = tile * kTile;
  const int64_t tile_end = tile_start + kTile < m ? tile_start + kTile : m;
  const int n_tile = static_cast<int>(tile_end - tile_start);
  const int r0 = tid * kItems;  // the run's first update, within the tile
  const int cnt = n_tile - r0 <= 0 ? 0 : (n_tile - r0 < kItems ? n_tile - r0 : kItems);
  const int64_t m0 = tile_start + r0;

  // Every global load of the tile is issued before the first use of any.
  int32_t k[kItems];
  if (vec && cnt == kItems) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(keys + m0) + q);
      k[4 * q] = x.x; k[4 * q + 1] = x.y; k[4 * q + 2] = x.z; k[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) k[i] = i < cnt ? keys[m0 + i] : 0;
  }
  if (tid == 0) s_edge[0] = tile_start > 0 ? keys[tile_start - 1] : 0;
  if (tid == 1) s_edge[1] = tile_end < m ? keys[tile_end] : 0;
  typename Load::template Raw<kItems> raw;
  lv.template fetch<kItems>(m0, cnt, vec, raw);
  if (cnt == kItems) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q)
      reinterpret_cast<int4*>(s_keys + r0)[q] =
          make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (i < cnt) s_keys[r0 + i] = k[i];
  }
  __syncthreads();

  const bool has_prev = tid > 0 || tile_start > 0;
  const int32_t prev = tid > 0 ? s_keys[r0 - 1] : s_edge[0];
  const bool next_in_tile = r0 + kItems < n_tile;
  const bool has_next = next_in_tile || tile_end < m;
  const int32_t next = next_in_tile ? s_keys[r0 + kItems] : s_edge[1];

  // The rows this tile owns: (lo, hi].  The barrier after the warp
  // aggregates below orders their zeros before the tile's sums.
  const int64_t lo = tile_start > 0 ? clamp_row(s_edge[0], n_rows) : -1;
  const int64_t hi =
      tile == last_tile ? n_rows - 1 : clamp_row(s_keys[n_tile - 1], n_rows);
  const bool staged = Stream<F>::kStageRows && hi - lo <= kTile;
  if (staged) {
    for (int e = tid; e < (hi - lo) * F; e += kStreamThreads) s_rows[e] = 0.0f;
  } else {
    write_floats(out, out0 + (lo + 1) * F, out0 + (hi + 1) * F, nullptr);
  }

  float v[kItems][F];
  lv.unpack(raw, v);
  bool head[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    head[i] = i < cnt && (i == 0 ? (!has_prev || prev != k[0]) : k[i] != k[i - 1]);

  // The run's aggregate: a head anywhere in it, and the sum since its last
  // head (of the whole run if it has none), summed in stream order.
  int flag = 0;
  float inc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) inc[f] = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (head[i]) {
      flag = 1;
#pragma unroll
      for (int f = 0; f < F; ++f) inc[f] = 0.0f;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) inc[f] += v[i][f];  // 0.0 past cnt
  }

  // Segmented inclusive scan over the warp's runs:
  // (fa, a) then (fb, b) -> (fa | fb, fb ? b : a + b).
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(0xffffffffu, flag, d);
    float o[F];
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = __shfl_up_sync(0xffffffffu, inc[f], d);
    if (lane >= d) {
      if (!flag) {
#pragma unroll
        for (int f = 0; f < F; ++f) inc[f] = o[f] + inc[f];
      }
      flag |= of;
    }
  }
  if (lane == 31) {
    s_wflag[warp] = flag;
#pragma unroll
    for (int f = 0; f < F; ++f) s_wsum[warp][f] = inc[f];
  }
  // Exclusive within the warp.
  int eflag = __shfl_up_sync(0xffffffffu, flag, 1);
  float carry[F];
#pragma unroll
  for (int f = 0; f < F; ++f) carry[f] = __shfl_up_sync(0xffffffffu, inc[f], 1);
  if (lane == 0) {
    eflag = 0;
#pragma unroll
    for (int f = 0; f < F; ++f) carry[f] = 0.0f;
  }
  __syncthreads();
  // The earlier warps' aggregates, combined in warp order.
  int pflag = 0;
  float pre[F];
#pragma unroll
  for (int f = 0; f < F; ++f) pre[f] = 0.0f;
  for (int w = 0; w < warp; ++w) {
    const bool reset = s_wflag[w] != 0;
#pragma unroll
    for (int f = 0; f < F; ++f) pre[f] = reset ? s_wsum[w][f] : pre[f] + s_wsum[w][f];
    pflag |= s_wflag[w];
  }
  if (!eflag) {
#pragma unroll
    for (int f = 0; f < F; ++f) carry[f] = pre[f] + carry[f];
  }
  // carry: the tile's share of the row open at the run's start; in_tile:
  // whether that row's head lies in this tile.
  bool in_tile = (eflag | pflag) != 0;

  bool tail = false;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < cnt) {
      if (head[i]) {
        in_tile = true;
#pragma unroll
        for (int f = 0; f < F; ++f) carry[f] = 0.0f;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) carry[f] += v[i][f];
      tail = i + 1 < cnt ? k[i] != k[i + 1] : (!has_next || next != k[i]);
      if (tail) {
        if (!in_tile) {
          // The end of a row begun in an earlier tile: its share here.
#pragma unroll
          for (int f = 0; f < F; ++f) part[(block * 2) * F + f] = carry[f];
        } else if (k[i] >= 0 && k[i] < n_rows) {  // a row in (lo, hi]
          if (staged) {
#pragma unroll
            for (int f = 0; f < F; ++f) s_rows[(k[i] - lo - 1) * F + f] = carry[f];
          } else {
            store_row<F>(out + out0, k[i], carry);
          }
        }
      }
    }
  }

  // The tile's last run says how the tile meets the next one.
  if (cnt > 0 && r0 + cnt == n_tile) {
    if (!tail) {
      // The last row goes on: its share is [b, 1] if it began here, else the
      // whole tile belongs to a row begun earlier ([b, 0]).
      float* dst = part + (block * 2 + (in_tile ? 1 : 0)) * F;
#pragma unroll
      for (int f = 0; f < F; ++f) dst[f] = carry[f];
    }
    flags[block] = (in_tile ? kHasHead : 0) | (tail ? 0 : kOpenOut);
  }

  if (staged) {
    __syncthreads();
    write_floats(out, out0 + (lo + 1) * F, out0 + (hi + 1) * F, s_rows);
  }
}

// One thread per tile of every level: a tile whose last row begins in it
// and goes on adds the next tiles' shares of that row, in tile order, and
// writes the row.  Only launched with n_tiles > 1 a level, so every tile is
// non-empty and has its flag.
template <int F>
__global__ void __launch_bounds__(kStreamThreads)
stream_fixup_kernel(const int32_t* __restrict__ keys, const float* __restrict__ part,
                    const int32_t* __restrict__ flags, float* __restrict__ out,
                    int64_t n_blocks, int64_t n_tiles, int64_t m, int64_t n_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_blocks || flags[t] != (kHasHead | kOpenOut)) return;
  const int64_t level = t / n_tiles;
  const int64_t level_end = (level + 1) * n_tiles;
  float s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s[f] = part[(t * 2 + 1) * F + f];
  // The row ends in the first later tile that has a head or is not open;
  // a level's last tile is never open, and the bound says so again.
  for (int64_t u = t + 1; u < level_end; ++u) {
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] += part[(u * 2) * F + f];
    if (flags[u] != kOpenOut) break;
  }
  // Tile t is full: it has a successor in its level.
  const int32_t key = keys[level * m + (t - level * n_tiles + 1) * Stream<F>::kTile - 1];
  if (key >= 0 && key < n_rows) store_row<F>(out + level * n_rows * F, key, s);
}

template <int F>
int64_t stream_tiles(int64_t m) {
  constexpr int64_t kTile = Stream<F>::kTile;
  return m > kTile ? (m + kTile - 1) / kTile : 1;
}

// kLevels: the entry point takes L streams (kernels 2 and 3); without it,
// exactly one (kernels 1 and 4).
template <int F, bool kLevels, class Load>
int launch_stream(const void* keys, Load load, void* out, void* scratch, int64_t n_levels,
                  int64_t m, int64_t n_rows, void* stream) {
  if (n_levels < 0 || m < 0 || n_rows < 0 || n_rows > INT32_MAX || (!kLevels && n_levels > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_levels == 0 || n_rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = stream_tiles<F>(m);
  if (n_tiles > INT32_MAX / n_levels) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = n_levels * n_tiles;
  auto* part = static_cast<float*>(scratch);
  auto* flags = reinterpret_cast<int32_t*>(part + n_blocks * 2 * F);
  const auto* k = static_cast<const int32_t*>(keys);
  auto* o = static_cast<float*>(out);
  // A later level's keys start 4 * l * m bytes in.
  const bool vec = is_aligned16(keys) && (n_levels == 1 || m % 4 == 0) && load.aligned(m);
  stream_sum_kernel<F, Load, kLevels>
      <<<static_cast<unsigned int>(n_blocks), kStreamThreads, 0, s>>>(
      k, load, o, part, flags, m, n_rows, static_cast<unsigned int>(n_tiles), vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 1) return static_cast<int>(err);
  stream_fixup_kernel<F>
      <<<static_cast<unsigned int>((n_blocks + kStreamThreads - 1) / kStreamThreads),
         kStreamThreads, 0, s>>>(k, part, flags, o, n_blocks, n_tiles, m, n_rows);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadWidth = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Plain C entry points for ctypes.  Each launch returns a cudaError_t (0 =
// launched).  F is 2, 4 or 8 (configs/base.json, configs/tpu_opt.json and
// configs/l4f8.json); any other width returns cudaErrorInvalidValue.  All
// four take keys (n_levels, m) int32, ascending within each level, the
// payload of m updates a level, out (n_levels, n_rows, F) fp32, and the
// per-tile scratch.

// Bytes of per-tile scratch the entry points need for n_levels streams of
// m updates of F channels (the wrapper allocates it); 0 for a width
// without a kernel.
extern "C" long long segment_sum_stream_scratch_bytes(long long n_levels, long long m,
                                                      int n_features) {
  int64_t n_tiles;
  switch (n_features) {
    case 2: n_tiles = stream_tiles<2>(m); break;
    case 4: n_tiles = stream_tiles<4>(m); break;
    case 8: n_tiles = stream_tiles<8>(m); break;
    default: return 0;
  }
  return n_levels * n_tiles * (2LL * n_features + 1) * 4;
}

// Kernel 1: all levels in one global-row stream (n_levels must be 1): upd
// (m, F) bf16 rows in key order.
extern "C" int segment_sum_rows(const void* keys, const void* upd, void* out, void* scratch,
                                long long n_levels, long long n_rows, long long m,
                                int n_features, void* stream) {
  const auto* u = static_cast<const __nv_bfloat16*>(upd);
  switch (n_features) {
    case 2:
      return launch_stream<2, false>(keys, Bf16Rows<2>{u},
                                     out, scratch, n_levels, m, n_rows, stream);
    case 4:
      return launch_stream<4, false>(keys, Bf16Rows<4>{u},
                                     out, scratch, n_levels, m, n_rows, stream);
    case 8:
      return launch_stream<8, false>(keys, Bf16Rows<8>{u},
                                     out, scratch, n_levels, m, n_rows, stream);
    default: return kBadWidth;
  }
}

// Kernel 4: vals (F, m) fp32 of one stream (n_levels must be 1), exact.
extern "C" int segment_sum_planar(const void* keys, const void* vals, void* out, void* scratch,
                                  long long n_levels, long long n_rows, long long m,
                                  int n_features, void* stream) {
  const auto* v = static_cast<const float*>(vals);
  switch (n_features) {
    case 2:
      return launch_stream<2, false>(keys, Planar<2, false>{v, m},
                                     out, scratch, n_levels, m, n_rows, stream);
    case 4:
      return launch_stream<4, false>(keys, Planar<4, false>{v, m},
                                     out, scratch, n_levels, m, n_rows, stream);
    case 8:
      return launch_stream<8, false>(keys, Planar<8, false>{v, m},
                                     out, scratch, n_levels, m, n_rows, stream);
    default: return kBadWidth;
  }
}

// Kernel 2: packed (n_levels, F / 2, m) int32 bf16 pairs.
extern "C" int segment_sum_packed(const void* keys, const void* packed, void* out, void* scratch,
                                  long long n_levels, long long n_rows, long long m,
                                  int n_features, void* stream) {
  const auto* p = static_cast<const uint32_t*>(packed);
  switch (n_features) {
    case 2:
      return launch_stream<2, true>(keys, PackedPairs<2>{p, m},
                                    out, scratch, n_levels, m, n_rows, stream);
    case 4:
      return launch_stream<4, true>(keys, PackedPairs<4>{p, m},
                                    out, scratch, n_levels, m, n_rows, stream);
    case 8:
      return launch_stream<8, true>(keys, PackedPairs<8>{p, m},
                                    out, scratch, n_levels, m, n_rows, stream);
    default: return kBadWidth;
  }
}

// Kernel 3: vals (n_levels, F, m) fp32, rounded to bf16 on load.
extern "C" int segment_sum_batched(const void* keys, const void* vals, void* out, void* scratch,
                                   long long n_levels, long long n_rows, long long m,
                                   int n_features, void* stream) {
  const auto* v = static_cast<const float*>(vals);
  switch (n_features) {
    case 2:
      return launch_stream<2, true>(keys, Planar<2, true>{v, m},
                                    out, scratch, n_levels, m, n_rows, stream);
    case 4:
      return launch_stream<4, true>(keys, Planar<4, true>{v, m},
                                    out, scratch, n_levels, m, n_rows, stream);
    case 8:
      return launch_stream<8, true>(keys, Planar<8, true>{v, m},
                                    out, scratch, n_levels, m, n_rows, stream);
    default: return kBadWidth;
  }
}

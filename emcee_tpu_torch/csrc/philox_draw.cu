// K14: the counter-based Philox draws of the moves and the shuffled split.
//
// Replaces the draws that XLA fuses into their consumers in the JAX
// package: the shuffled split's permutation bits
// (emcee_tpu/moves/red_blue.py:218, vmapped over the rungs by
// parallel/tempering.py:538) and the normals and uniforms of
// moves/dime.py:320-351, de_z.py:158-219, walk.py:78-88,
// gaussian.py:125-142, slice.py:168-257, side.py:66-82 and kde.py:80.
// There is no Pallas kernel behind it.  The port's plain version
// (ops/philox.py philox4x32_torch) is ten torch calls a round, about a
// hundred launches a draw.
//
// One launch computes, for counters (lane, block + j, offset) with lane
// row0 + r for r < n (and ROLL_LANE for r == n with `roll`), j < k, one
// of:
//   words     the four words as int64 (four planes, the plain functions'
//             layout) or only word `word`;
//   uniforms  (rows, d), uniform 4j + w from word w (row_uniforms), or
//             (rows, k) of word `word` alone; float32 or float64;
//   normals   (rows, d), normal 2j by Box-Muller on words 0 and 2, normal
//             2j + 1 on words 1 and 3 (ops/philox.py normals), the tail
//             cut at d; float32 or float64.
// With a key table (the rung axis) the grid's second dimension is the rung
// and rung t draws under keys[t] (ops/philox.py RungKeys.table), as K1 and
// K2 take their keys; the output gains a leading rung axis.  The block
// word is `block`, or read from block_dev (a counter on the card, such as
// the slice move's shrink iteration) and the offset from offset_dev, so a
// CUDA graph records the launch and every replay reads fresh values.
//
// What bounds it on an H100: at the callers' shapes the bytes written
// (e.g. DIME's 5e4 x 6 normals, 1.2 MB, 0.36 us at 3.35 TB/s) and the
// Philox rounds (40 instructions a counter) are both far below the launch
// floor (~1.3-1.5 us); workload 4's shuffle writes 32 KB.  So the design
// is the simple one: one thread a counter, consecutive threads on
// consecutive counters (so each warp's stores are contiguous), the key,
// block and offset words loaded once per thread before the rounds.
// Arithmetic is bit for bit the plain version's: exact uniforms, and in
// Box-Muller the _rn intrinsics with the accurate logf / cosf and the IEEE
// sqrt (float32, philox_normal as K11 uses it) or the libdevice log / cos
// and the IEEE sqrt that torch's float64 ops call, no FMA contraction.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;  // DRAW_THREADS in ops/philox_kernel.py
constexpr int kWords = 0, kUniforms = 1, kNormals = 2;  // KINDS

template <typename F>
struct Draw;

template <>
struct Draw<float> {
  static __device__ __forceinline__ float uniform(uint32_t w) {
    return philox_uniform(w);
  }
  static __device__ __forceinline__ float normal(uint32_t w0, uint32_t w2) {
    return philox_normal(w0, w2);
  }
};

template <>
struct Draw<double> {
  static __device__ __forceinline__ double uniform(uint32_t w) {
    return static_cast<double>(w >> 8) * 5.9604644775390625e-08;  // 2^-24
  }
  // sqrt(-2 log(1 - u0)) cos(2 pi u2) in float64, each operation rounded
  // once, with 2 pi the float32 constant (ops/philox.py TWO_PI_F32).
  static __device__ __forceinline__ double normal(uint32_t w0, uint32_t w2) {
    const double r =
        __dsqrt_rn(__dmul_rn(-2.0, log(__dsub_rn(1.0, uniform(w0)))));
    return __dmul_rn(r, cos(__dmul_rn(6.28318548202514648, uniform(w2))));
  }
};

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

template <int kKind, typename F>
__global__ void __launch_bounds__(kThreads) philox_draw_kernel(
    void* __restrict__ out, int rows, int n, int k, int d, int word,
    uint32_t row0, uint32_t block, const long long* __restrict__ block_dev,
    uint32_t k0, uint32_t k1, const long long* __restrict__ keys,
    const long long* __restrict__ offset_dev, unsigned long long offset_inc) {
  const int64_t count = static_cast<int64_t>(rows) * k;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= count) return;
  const int rung = blockIdx.y;
  // Independent loads, all issued before the rounds need them.
  const uint32_t b0 =
      block_dev != nullptr ? static_cast<uint32_t>(*block_dev) : block;
  const uint64_t offset = philox_offset(offset_dev, offset_inc);
  if (keys != nullptr) {
    const uint64_t key = static_cast<uint64_t>(keys[rung]);
    k0 = static_cast<uint32_t>(key);
    k1 = static_cast<uint32_t>(key >> 32);
  }
  const int r = static_cast<int>(t / k);
  const int j = static_cast<int>(t - static_cast<int64_t>(r) * k);
  const uint32_t lane =
      r < n ? row0 + static_cast<uint32_t>(r) : EMCEE_ROLL_LANE;
  const uint4 w =
      philox_at(lane, b0 + static_cast<uint32_t>(j), offset, k0, k1);
  const int64_t at = static_cast<int64_t>(rung) * count + t;  // (rung, r, j)
  if constexpr (kKind == kWords) {
    long long* o = static_cast<long long*>(out);
    if (word >= 0) {
      o[at] = word_of(w, word);
    } else {
      const int64_t plane = static_cast<int64_t>(gridDim.y) * count;
      o[at] = w.x;
      o[plane + at] = w.y;
      o[2 * plane + at] = w.z;
      o[3 * plane + at] = w.w;
    }
  } else if constexpr (kKind == kUniforms) {
    F* o = static_cast<F*>(out);
    if (word >= 0) {
      o[at] = Draw<F>::uniform(word_of(w, word));
    } else {
      const int c = 4 * j;
      F* row = o + (static_cast<int64_t>(rung) * rows + r) * d + c;
      row[0] = Draw<F>::uniform(w.x);
      if (c + 1 < d) row[1] = Draw<F>::uniform(w.y);
      if (c + 2 < d) row[2] = Draw<F>::uniform(w.z);
      if (c + 3 < d) row[3] = Draw<F>::uniform(w.w);
    }
  } else {
    F* o = static_cast<F*>(out);
    const int c = 2 * j;
    F* row = o + (static_cast<int64_t>(rung) * rows + r) * d + c;
    row[0] = Draw<F>::normal(w.x, w.z);
    if (c + 1 < d) row[1] = Draw<F>::normal(w.y, w.w);
  }
}

template <int kKind, typename F>
void launch(dim3 grid, cudaStream_t st, void* out, int rows, int n, int k,
            int d, int word, uint32_t row0, uint32_t block,
            const long long* block_dev, uint32_t k0, uint32_t k1,
            const long long* keys, const long long* offset_dev,
            unsigned long long offset) {
  philox_draw_kernel<kKind, F><<<grid, kThreads, 0, st>>>(
      out, rows, n, k, d, word, row0, block, block_dev, k0, k1, keys,
      offset_dev, offset);
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/philox_kernel.py).  `out` is
// a device buffer of the kind's layout: int64 (4 or 1, ntemps, rows, k) for
// words (kind 0), `dtype` 0 (float32) or 1 (float64) (ntemps, rows, d) or
// (ntemps, rows, k) for uniforms (kind 1), (ntemps, rows, d) for normals
// (kind 2).  rows = n or n + 1 (the ROLL_LANE row); word -1 for every word,
// else 0-3; row0 + n <= 2^32.  block_dev (nullable) replaces `block` by a
// 0-d int64 on the card; keys (nullable) is the (ntemps,) int64 key table,
// else `seed` keys every rung.  The offset is *offset_dev + offset
// (offset alone when offset_dev is null).  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, and no launch, for a kind or
// dtype it does not take or shapes out of range).
extern "C" int emcee_philox_draw(void* out, int kind, int dtype, int ntemps,
                                 int rows, int n, int k, int d, int word,
                                 unsigned int row0, unsigned int block,
                                 const long long* block_dev,
                                 unsigned long long seed,
                                 const long long* keys,
                                 const long long* offset_dev,
                                 unsigned long long offset, void* stream) {
  const int64_t count = static_cast<int64_t>(rows) * k;
  if (ntemps < 1 || ntemps > 65535 || rows < 1 || k < 1 || n < 0 ||
      n > rows || word < -1 || word > 3 || count > (int64_t{1} << 31) - 1 ||
      (kind != kWords && dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((count + kThreads - 1) / kThreads),
                  static_cast<unsigned>(ntemps));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  const bool f64 = dtype == 1;
  switch (kind) {
    case kWords:
      launch<kWords, long long>(grid, st, out, rows, n, k, d, word, row0,
                                block, block_dev, k0, k1, keys, offset_dev,
                                offset);
      break;
    case kUniforms:
      if (f64) {
        launch<kUniforms, double>(grid, st, out, rows, n, k, d, word, row0,
                                  block, block_dev, k0, k1, keys, offset_dev,
                                  offset);
      } else {
        launch<kUniforms, float>(grid, st, out, rows, n, k, d, word, row0,
                                 block, block_dev, k0, k1, keys, offset_dev,
                                 offset);
      }
      break;
    case kNormals:
      if (f64) {
        launch<kNormals, double>(grid, st, out, rows, n, k, d, word, row0,
                                 block, block_dev, k0, k1, keys, offset_dev,
                                 offset);
      } else {
        launch<kNormals, float>(grid, st, out, rows, n, k, d, word, row0,
                                block, block_dev, k0, k1, keys, offset_dev,
                                offset);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// What bounds it on an H100: latency, and at the larger shapes the
// instructions of the accurate normals.  At the callers' shapes the bytes
// written (DIME's 5e4 x 6 normals, 1.2 MB, 0.36 us at 3.35 TB/s; workload
// 4's shuffle keys, 32 KB) are far below the launch floor (~1 us: torch's
// fill of the same outputs takes 0.99 and 1.15 us), and at the DIME
// stage's shape the accurate logf / cosf bind it: a float32 normal row's
// thread runs ~275 instructions on the fast path of its 440 (SASS), some
// 1.3e6 warp instructions at 1.5e5 threads, ~1.2 us of the card's issue
// rate on top of the launch.  The first design (one
// thread a counter in blocks of 256) was slower than that fill at both
// shapes: workload 4's 16 x 256 counters ran on 16 SMs, every thread paid a
// 64-bit division and 64-bit index arithmetic, and a normal row's two
// values were stored one by one.  The design:
//   * One thread a counter over every rung's counters, one after the
//     other, in blocks of 128 (ops/philox_kernel.py draw_plan).  In graph
//     replays on the H100 blocks of 128 were the fastest of 32-1024 at
//     both shapes: at workload 4's 4096 counters smaller blocks cost their
//     dispatch (32 threads: 128 blocks) and larger ones the issue of all
//     their warps on one SM (1024 threads: 4 blocks, 1.7 us); several
//     counters a thread, with the round keys made once, were slower too.
//   * 32-bit index arithmetic and no division: thread ta's rung is ta /
//     (rows k), its counter's row r = t / k and column t - r k, each
//     quotient a multiply-high and a shift by a magic number the host
//     computes (ops/_wrap.py divisor; exact below 2^31).  Where a row
//     has no tail, counter ta's values lie at ta (or 4 ta, 2 ta) of the
//     whole output, so its stores need no row arithmetic at all.
//   * offset_dev and block_dev are loaded first, so their trips to memory
//     overlap the index set-up; the key table word follows as soon as the
//     rung is known.
//   * Wide stores where a row has no tail (kVec: d = 4k for uniforms of
//     every word, 2k for normals): one float4 / float2 / double2 store a
//     counter (two double2 for float64 uniforms).  A row with a tail
//     stores value by value.
// Arithmetic is bit for bit the plain version's, as before: exact
// uniforms, and in Box-Muller the _rn intrinsics with the accurate logf /
// cosf and the IEEE sqrt (float32, philox_normal as K11 uses it) or the
// libdevice log / cos and the IEEE sqrt that torch's float64 ops call, no
// FMA contraction and no fast math.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

// The largest block (DRAW_THREADS_LIMIT in ops/philox_kernel.py).
constexpr int kMaxThreads = 1024;
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

// Two values of type F as one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// Four values of type F as wide stores (one float4, two double2).
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b,
                                       double c, double d) {
  store2(p, a, b);
  store2(p + 2, c, d);
}

// a / b by a multiply-high and a shift (ops/_wrap.py divisor;
// mul == 0 stands for b == 1).
__device__ __forceinline__ uint32_t div_by(uint32_t a, uint32_t mul,
                                           int shr) {
  return mul == 0 ? a : __umulhi(a, mul) >> shr;
}

// F is the stored type (long long for words).  Thread ta (< total, every
// rung's counters one after the other) draws counter t = ta % count of
// rung ta / count: row t / k, column t % k of the draw.  rung_elems: the
// elements of one rung's output (one plane's for words).  (rung_mul,
// rung_shr) divide by count, (div_mul, div_shr) by k.
template <int kKind, typename F, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) philox_draw_kernel(
    F* __restrict__ out, uint32_t total, uint32_t count,
    long long rung_elems, int n, int k, int d, int word, uint32_t row0,
    uint32_t block, const long long* __restrict__ block_dev, uint32_t k0,
    uint32_t k1, const long long* __restrict__ keys,
    const long long* __restrict__ offset_dev, unsigned long long offset_inc,
    uint32_t rung_mul, int rung_shr, uint32_t div_mul, int div_shr) {
  // The loads first: nothing below up to the rounds waits for them.
  const uint32_t b0 =
      block_dev != nullptr ? static_cast<uint32_t>(*block_dev) : block;
  const uint64_t offset = philox_offset(offset_dev, offset_inc);
  const uint32_t ta = blockIdx.x * blockDim.x + threadIdx.x;
  if (ta >= total) return;
  const uint32_t rung = div_by(ta, rung_mul, rung_shr);
  if (keys != nullptr) {
    const uint64_t key = static_cast<uint64_t>(keys[rung]);
    k0 = static_cast<uint32_t>(key);
    k1 = static_cast<uint32_t>(key >> 32);
  }
  const uint32_t t = ta - rung * count;
  const uint32_t r = div_by(t, div_mul, div_shr);
  const uint32_t j = t - r * static_cast<uint32_t>(k);
  const uint32_t lane =
      r < static_cast<uint32_t>(n) ? row0 + r : EMCEE_ROLL_LANE;
  const uint4 w = philox_at(lane, b0 + j, offset, k0, k1);
  // Every rung's output follows the one before, so a counter without a
  // tail in its row stores at ta (or its vector at 4 ta, 2 ta).
  if constexpr (kKind == kWords) {
    if (word >= 0) {
      out[ta] = word_of(w, word);
    } else {
      out[ta] = w.x;
      out[total + ta] = w.y;
      out[2 * static_cast<int64_t>(total) + ta] = w.z;
      out[3 * static_cast<int64_t>(total) + ta] = w.w;
    }
  } else if constexpr (kKind == kUniforms) {
    if (word >= 0) {
      out[ta] = Draw<F>::uniform(word_of(w, word));
    } else if constexpr (kVec) {  // d == 4k: values 4 ta .. 4 ta + 3
      store4(out + 4 * static_cast<int64_t>(ta), Draw<F>::uniform(w.x),
             Draw<F>::uniform(w.y), Draw<F>::uniform(w.z),
             Draw<F>::uniform(w.w));
    } else {
      const int c = 4 * static_cast<int>(j);
      F* row = out + rung * rung_elems + static_cast<int64_t>(r) * d + c;
      row[0] = Draw<F>::uniform(w.x);
      if (c + 1 < d) row[1] = Draw<F>::uniform(w.y);
      if (c + 2 < d) row[2] = Draw<F>::uniform(w.z);
      if (c + 3 < d) row[3] = Draw<F>::uniform(w.w);
    }
  } else {
    const F z0 = Draw<F>::normal(w.x, w.z);
    if constexpr (kVec) {  // d == 2k: values 2 ta, 2 ta + 1
      store2(out + 2 * static_cast<int64_t>(ta), z0,
             Draw<F>::normal(w.y, w.w));
    } else {
      const int c = 2 * static_cast<int>(j);
      F* row = out + rung * rung_elems + static_cast<int64_t>(r) * d + c;
      row[0] = z0;
      if (c + 1 < d) row[1] = Draw<F>::normal(w.y, w.w);
    }
  }
}

struct Args {
  unsigned blocks;
  int threads;
  cudaStream_t st;
  void* out;
  uint32_t total, count;
  long long rung_elems;
  int n, k, d, word;
  uint32_t row0, block;
  const long long* block_dev;
  uint32_t k0, k1;
  const long long* keys;
  const long long* offset_dev;
  unsigned long long offset;
  uint32_t rung_mul;
  int rung_shr;
  uint32_t div_mul;
  int div_shr;
};

template <int kKind, typename F, bool kVec>
void launch(const Args& a) {
  philox_draw_kernel<kKind, F, kVec><<<a.blocks, a.threads, 0, a.st>>>(
      static_cast<F*>(a.out), a.total, a.count, a.rung_elems, a.n, a.k, a.d,
      a.word, a.row0, a.block, a.block_dev, a.k0, a.k1, a.keys, a.offset_dev,
      a.offset, a.rung_mul, a.rung_shr, a.div_mul, a.div_shr);
}

template <int kKind, typename F>
void launch_vec(const Args& a, bool vec) {
  if (vec) {
    launch<kKind, F, true>(a);
  } else {
    launch<kKind, F, false>(a);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/philox_kernel.py).  `out` is
// a device buffer of the kind's layout: int64 (4 or 1, ntemps, rows, k) for
// words (kind 0), `dtype` 0 (float32) or 1 (float64) (ntemps, rows, d) or
// (ntemps, rows, k) for uniforms (kind 1), (ntemps, rows, d) for normals
// (kind 2), aligned as torch allocates it.  rows = n or n + 1 (the
// ROLL_LANE row); word -1 for every word, else 0-3; row0 + n <= 2^32;
// ntemps * rows * k < 2^31.  block_dev (nullable) replaces `block` by a
// 0-d int64 on the card; keys (nullable) is the (ntemps,) int64 key table,
// else `seed` keys every rung.  The offset is *offset_dev + offset (offset
// alone when offset_dev is null).  threads, vec, rung_mul, rung_shr,
// div_mul and div_shr are the launch plan (ops/philox_kernel.py
// draw_plan): threads a block (a multiple of 32 up to kMaxThreads), one
// counter a thread over every rung's counters, vec != 0 where every row is
// whole counters (d == 4k for uniforms of every word, d == 2k for normals;
// ignored for other draws), and a / (rows k), a / k as __umulhi(a, mul)
// >> shr (mul 0 for a divisor of 1).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue, and no launch, for a kind or dtype it does
// not take or arguments out of range).
extern "C" int emcee_philox_draw(void* out, int kind, int dtype, int ntemps,
                                 int rows, int n, int k, int d, int word,
                                 unsigned int row0, unsigned int block,
                                 const long long* block_dev,
                                 unsigned long long seed,
                                 const long long* keys,
                                 const long long* offset_dev,
                                 unsigned long long offset, int threads,
                                 int vec, unsigned int rung_mul, int rung_shr,
                                 unsigned int div_mul, int div_shr,
                                 void* stream) {
  const int64_t count = static_cast<int64_t>(rows) * k;
  const int64_t total = count * ntemps;
  if (ntemps < 1 || ntemps > 65535 || rows < 1 || k < 1 || n < 0 ||
      n > rows || word < -1 || word > 3 || total > (int64_t{1} << 31) - 1 ||
      (kind != kWords && dtype != 0 && dtype != 1) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || div_shr < 0 ||
      div_shr > 31 || rung_shr < 0 || rung_shr > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool every = word < 0 && kind != kWords;  // rows of d values
  if (vec && every && d != (kind == kUniforms ? 4 : 2) * k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.blocks = static_cast<unsigned>((total + threads - 1) / threads);
  a.threads = threads;
  a.st = static_cast<cudaStream_t>(stream);
  a.out = out;
  a.total = static_cast<uint32_t>(total);
  a.count = static_cast<uint32_t>(count);
  a.rung_elems = every ? static_cast<long long>(rows) * d : count;
  a.n = n;
  a.k = k;
  a.d = d;
  a.word = word;
  a.row0 = row0;
  a.block = block;
  a.block_dev = block_dev;
  a.k0 = static_cast<uint32_t>(seed);
  a.k1 = static_cast<uint32_t>(seed >> 32);
  a.keys = keys;
  a.offset_dev = offset_dev;
  a.offset = offset;
  a.rung_mul = rung_mul;
  a.rung_shr = rung_shr;
  a.div_mul = div_mul;
  a.div_shr = div_shr;
  const bool f64 = dtype == 1;
  const bool wide = vec && every;
  switch (kind) {
    case kWords:
      launch<kWords, long long, false>(a);
      break;
    case kUniforms:
      if (f64) {
        launch_vec<kUniforms, double>(a, wide);
      } else {
        launch_vec<kUniforms, float>(a, wide);
      }
      break;
    case kNormals:
      if (f64) {
        launch_vec<kNormals, double>(a, wide);
      } else {
        launch_vec<kNormals, float>(a, wide);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

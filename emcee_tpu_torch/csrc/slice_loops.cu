// K9: the slice move's stepping-out and shrinkage, as loops whose every
// trip evaluates only the ends and walkers still looping.
//
// Replaces the XLA-fused while_loops of emcee_tpu/moves/slice.py:143-299
// (EnsembleSliceMove._inner: the pair and window draws and the slice
// level, :158-202; stepping out, :204-241; shrinkage, :243-293; the
// update, :295-299), vmapped over the rungs by emcee_tpu/parallel/
// tempering.py:449-541.  The JAX loops evaluate every walker of the group
// in every trip until the slowest lands; the port ran them so too, as
// ~20 masked torch launches a trip.  Here each trip evaluates a list: the
// ends still expanding (stepping out) or the walkers not yet landed
// (shrinkage), in walker order, their points in the first rows of one
// evaluation buffer.  A walker's path depends only on its own values and
// on its own trip number, which equals the group's trip counter for as
// long as it loops, so every walker ends as in the masked loop.  The plain
// versions are ops/slice_kernel.py slice_setup_plain, slice_step_out_plain,
// slice_shrink_plain and slice_finish_plain; each kernel agrees with them
// bit for bit: every product and sum rounded once (the _rn intrinsics, so
// nothing is contracted into a fused multiply-add), logf as torch's on the
// card, the draws those of ops/philox.py at the same counters.
//
// K9a, slice_setup_kernel, a thread a walker i of the group (row lo + i):
//   draws u0..u3 from words 0-3 of (row, SLICE_BLOCK) and the level's
//     uniform from word 1 of (i, split) (K2's accept counter), each
//     injectable; i' = min(int(u0 nc), nc - 1), j' = min(int(u1 (nc - 1)),
//     nc - 2), then j' + 1 where j' >= i'; reads both complement rows in
//     place (r + ng past the group's first row);
//   eta = mu' (c_i - c_j), mu' = mu or mu scale[r]; y = lp + log u; L =
//     -u2, R = L + 1; jL = min(int(u3 max_steps), max_steps - 1), jR =
//     max_steps - 1 - jL; cnt = 0;
//   lists the ends with cnt < j (code 2 i + side) and writes their points
//     s + L eta or s + R eta.
// K9b, slice_step_out_kernel, a thread an entry of the list: reads the
//   log-prob of its point; an end inside the slice moves (L - 1, R + 1),
//   counts an expansion and stays listed while cnt < j, with its next
//   point.  JAX's iteration counter becomes trip + 2 where an end expanded
//   (the loop runs once more) and its expansions are counted as integers.
// K9c, slice_shrink_kernel, a thread a walker still looping: reads the
//   log-prob of its point s + t eta; a walker inside the slice lands (t,
//   its log-prob and its blob rows into t_acc, lp_acc and blobs_acc);
//   otherwise it counts a contraction, moves L (t < 0) or R to t and, while
//   trip + 1 < max_shrink, stays listed with t = L + u (R - L), u from word
//   0 of (row, SHRINK_BLOCK | trip + 1).  kSetup: the first list, every
//   walker with u at SHRINK_BLOCK | 0.
// K9d, slice_finish_kernel, a thread a walker: where it landed, q = s +
//   t_acc eta, its log-prob and blob rows into the ensemble; the
//   acceptance and its count; the group's counts folded into the
//   proposal's sums and the loop counters.
//
// The list is compacted in walker order without atomics on the order: a
// block scan of each thread's survivors, then a decoupled look-back over
// the tiles before it (Merrill & Garland 2016), each tile's status one
// 64-bit word (the launch's serial, a flag, the count).  The serial, the
// next length and a count of finished blocks are words of the rung; the
// last block to finish (its count) publishes the length, advances the
// trip and the serial.  Two lists and two evaluation buffers alternate by
// the trip's parity, a kernel argument fixed in a recorded graph: a trip
// reads the points and list of one and writes those of the other, so a
// log-prob that returns a view of its rows (a blob x) is never written
// while it is read.
//
// What bounds them on an H100: latency.  A trip reads a list entry, its
// walker's words and log-prob and writes its next point: ~60 bytes an
// entry at ndim 5, tens of microseconds of bytes at 1e5 entries and
// nanoseconds at the list's tail; the log-prob between trips is the
// user's.
//
// The rung axis: blockIdx.y is the rung, with its rows, state, list,
// words and tiles one rung after the other; rung r draws under keys[r]
// (null keys: seed) at the one-ensemble counters, so every rung ends as
// the same rung alone.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

// One blob leaf (ops/slice_kernel.py _Leaf): rows of row_bytes bytes, a
// rung's rows src_rung / dst_rung bytes after the last rung's.
struct SliceLeaf {
  const char* src;
  char* dst;
  long long src_rung;
  long long dst_rung;
  int row_bytes;
  int pad;
};

// The leaves one launch takes (LEAVES_MAX in ops/slice_kernel.py).
constexpr int kMaxLeaves = 16;

// The arguments of every K9 kernel (ops/slice_kernel.py _Args, field for
// field).  Outside the anonymous namespace: the C entry points take it.
struct SliceArgs {
  float* x;          // (T, nw, nd) the ensemble
  float* lp_ens;     // (T, nw) its log-probs
  const float* lp;   // (T, bucket) the trip's log-probs
  float* eta;        // (T, ng, nd)
  float* y;          // (T, ng) the levels
  float* ends;       // (T, ng, 2) each walker's window [L, R]
  int* budget;       // (T, ng, 2) each end's expansion budget
  int* cnt;          // (T, ng, 2) each end's expansions
  float* t;          // (T, ng) the listed walker's point
  float* t_acc;      // (T, ng)
  float* lp_acc;     // (T, ng)
  unsigned char* done;    // (T, ng)
  int* lists;        // (2, T, cap)
  float* pts;        // (2, T, cap, nd)
  unsigned long long* status;  // (T, tiles)
  int* words;        // (T, kWords)
  long long* counters;  // (4, 2): iterations, trips, evaluations, rows
  int* sums;         // (2, T): the proposal's expansions, contractions
  const float* scale;    // (T,) or null
  unsigned char* accepted;  // (T, nw)
  int* count;        // (T, nw) or null
  const int* i_in;   // injected draws, (T, ng) each, or null
  const int* j_in;
  const float* u_in;
  const int* jl_in;
  const float* logu_in;
  const float* shrink_in;  // (T, ng, shrink_cols)
  const long long* offset_dev;
  const long long* keys;
  unsigned long long offset_inc;
  unsigned long long seed;
  int nw, nd, ng, split, ntemps, cap, tiles, bucket, parity;
  int max_steps, max_shrink, count_evals, shrink_cols, nleaves;
  float mu;
  SliceLeaf leaves[kMaxLeaves];
};

namespace {

// ops/philox.py SLICE_BLOCK, SHRINK_BLOCK
constexpr uint32_t kSliceBlock = 0x08000000u | 0x400000u;
constexpr uint32_t kShrinkBlock = 0x08000000u | 0x800000u;
// ops/slice_kernel.py THREADS and the word slots
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLen = 0, kTrip = 1, kDone = 2, kSerial = 3, kNext = 4,
              kItOut = 5, kItShr = 6, kNexp = 7, kNcon = 8, kWords = 16;
constexpr unsigned long long kAgg = 1ull << 30, kPrefix = 2ull << 30;
constexpr unsigned kValue = (1u << 30) - 1u;

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ Key rung_key(const SliceArgs& a, int r) {
  const unsigned long long s =
      a.keys != nullptr ? static_cast<unsigned long long>(a.keys[r]) : a.seed;
  return Key{static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)};
}

__device__ __forceinline__ int load_word(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// The exclusive prefix of v over the block's threads, and the block's
// total in *total.  Every thread of the block calls it.
__device__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) sh[lane] = s;
  }
  __syncthreads();
  *total = sh[kWarps - 1];
  return (warp ? sh[warp - 1] : 0) + x - v;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned serial,
                                        unsigned long long flag, int v) {
  atomicExch(p, (static_cast<unsigned long long>(serial) << 32) | flag |
                    static_cast<unsigned>(v));
}

// Tile `tile`'s exclusive prefix among the tiles of its launch (serial):
// its aggregate published, the tiles before it read back to one whose
// inclusive prefix is published.  One thread of the tile calls it.
__device__ int look_back(unsigned long long* st, int tile, int agg,
                         unsigned serial) {
  if (tile == 0) {
    publish(st, serial, kPrefix, agg);
    return 0;
  }
  publish(st + tile, serial, kAgg, agg);
  int excl = 0;
  int t = tile - 1;
  for (;;) {
    const unsigned long long s =
        *reinterpret_cast<const volatile unsigned long long*>(st + t);
    if (static_cast<unsigned>(s >> 32) != serial || (s & (3ull << 30)) == 0)
      continue;
    excl += static_cast<int>(s & kValue);
    if ((s & (3ull << 30)) == kPrefix) break;
    --t;
  }
  publish(st + tile, serial, kPrefix, excl + agg);
  return excl;
}

// Whether this block is the last of the rung's nblocks to get here (every
// write of the others visible to it).
__device__ bool last_block(int* done_word, int nblocks, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(done_word, 1) == nblocks - 1;
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

// Rows of every leaf: src row sk of rung r to dst row dk.
__device__ void copy_leaves(const SliceArgs& a, int r, long long sk,
                            long long dk) {
  for (int l = 0; l < a.nleaves; ++l) {
    const SliceLeaf& f = a.leaves[l];
    const char* s = f.src + r * f.src_rung + sk * f.row_bytes;
    char* d = f.dst + r * f.dst_rung + dk * f.row_bytes;
    if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d) |
          static_cast<uintptr_t>(f.row_bytes)) & 3u) == 0) {
      for (int b = 0; b < f.row_bytes; b += 4)
        *reinterpret_cast<uint32_t*>(d + b) =
            *reinterpret_cast<const uint32_t*>(s + b);
    } else {
      for (int b = 0; b < f.row_bytes; ++b) d[b] = s[b];
    }
  }
}

// The point s + v eta of walker w of rung r into row k of evaluation
// buffer p.
__device__ __forceinline__ void write_point(const SliceArgs& a, int r,
                                            int w, int p, int k, float v) {
  const int nd = a.nd;
  const float* s =
      a.x + (static_cast<long long>(r) * a.nw + a.split * a.ng + w) * nd;
  const float* e = a.eta + (static_cast<long long>(r) * a.ng + w) * nd;
  float* q =
      a.pts + ((static_cast<long long>(p) * a.ntemps + r) * a.cap + k) * nd;
  for (int c = 0; c < nd; ++c) q[c] = __fadd_rn(s[c], __fmul_rn(v, e[c]));
}

// The compaction of the block's survivors (n of them this thread, the
// codes c0, c1): each written at its place in the next list with its
// point.  `code_point` gives an entry's walker and value.  Returns the
// block's survivors' total.
template <typename Point>
__device__ void compact(const SliceArgs& a, int r, int tile, int ntiles,
                        int n, const int* codes, unsigned serial, int p_next,
                        int* sh, int* s_excl, Point point) {
  int total;
  const int excl = block_scan(n, sh, &total);
  if (threadIdx.x == 0) {
    const int before =
        look_back(a.status + static_cast<long long>(r) * a.tiles, tile,
                  total, serial);
    *s_excl = before;
    if (tile == ntiles - 1)
      *reinterpret_cast<volatile int*>(a.words + r * kWords + kNext) =
          before + total;
  }
  __syncthreads();
  int* next =
      a.lists + (static_cast<long long>(p_next) * a.ntemps + r) * a.cap;
  for (int m = 0; m < n; ++m) {
    const int k = *s_excl + excl + m;
    next[k] = codes[m];
    point(codes[m], k);
  }
}

__global__ void __launch_bounds__(kThreads) slice_setup_kernel(
    const SliceArgs a) {
  __shared__ int sh[kWarps];
  __shared__ int s_excl;
  __shared__ bool s_last;
  __shared__ unsigned s_serial;
  const int r = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int* wd = a.words + r * kWords;
  if (threadIdx.x == 0)
    s_serial = static_cast<unsigned>(load_word(wd + kSerial));
  const long long w = static_cast<long long>(r) * a.ng + i;
  const int nd = a.nd, ng = a.ng, nc = a.nw - a.ng, lo = a.split * a.ng;
  int n = 0;
  int codes[2];
  if (i < ng) {
    const Key key = rung_key(a, r);
    const uint64_t off = philox_offset(a.offset_dev, a.offset_inc);
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (a.i_in == nullptr || a.j_in == nullptr || a.u_in == nullptr ||
        a.jl_in == nullptr)
      u = philox_at(static_cast<uint32_t>(lo + i), kSliceBlock, off, key.k0,
                    key.k1);
    int pi = a.i_in != nullptr
                 ? a.i_in[w]
                 : min(static_cast<int>(__fmul_rn(philox_uniform(u.x),
                                                  static_cast<float>(nc))),
                       nc - 1);
    int pj = a.j_in != nullptr
                 ? a.j_in[w]
                 : min(static_cast<int>(__fmul_rn(philox_uniform(u.y),
                                                  static_cast<float>(nc - 1))),
                       nc - 2);
    pj = pj >= pi ? pj + 1 : pj;
    const float* xr = a.x + static_cast<long long>(r) * a.nw * nd;
    const float* ci =
        xr + static_cast<long long>(pi >= lo ? pi + ng : pi) * nd;
    const float* cj =
        xr + static_cast<long long>(pj >= lo ? pj + ng : pj) * nd;
    const float mu = a.scale != nullptr ? __fmul_rn(a.mu, a.scale[r]) : a.mu;
    float* e = a.eta + w * nd;
    for (int c = 0; c < nd; ++c) e[c] = __fmul_rn(mu, __fsub_rn(ci[c], cj[c]));
    float lu;
    if (a.logu_in != nullptr) {
      lu = a.logu_in[w];
    } else {
      const uint4 v = philox_at(static_cast<uint32_t>(i),
                                static_cast<uint32_t>(a.split), off, key.k0,
                                key.k1);
      lu = logf(philox_uniform(v.y));
    }
    a.y[w] =
        __fadd_rn(a.lp_ens[static_cast<long long>(r) * a.nw + lo + i], lu);
    const float L = -(a.u_in != nullptr ? a.u_in[w] : philox_uniform(u.z));
    const float R = __fadd_rn(L, 1.0f);
    a.ends[2 * w] = L;
    a.ends[2 * w + 1] = R;
    const int jl =
        a.jl_in != nullptr
            ? a.jl_in[w]
            : min(static_cast<int>(__fmul_rn(philox_uniform(u.w),
                                             static_cast<float>(a.max_steps))),
                  a.max_steps - 1);
    const int jr = a.max_steps - 1 - jl;
    a.budget[2 * w] = jl;
    a.budget[2 * w + 1] = jr;
    a.cnt[2 * w] = 0;
    a.cnt[2 * w + 1] = 0;
    if (jl > 0) codes[n++] = 2 * i;
    if (jr > 0) codes[n++] = 2 * i + 1;
  }
  __syncthreads();
  const int ntiles = gridDim.x;
  compact(a, r, blockIdx.x, ntiles, n, codes, s_serial, 0, sh, &s_excl,
          [&](int code, int k) {
            write_point(a, r, code >> 1, 0, k,
                        a.ends[static_cast<long long>(r) * 2 * a.ng + code]);
          });
  if (last_block(wd + kDone, gridDim.x, &s_last) && threadIdx.x == 0) {
    wd[kLen] = load_word(wd + kNext);
    wd[kTrip] = 0;
    wd[kItOut] = a.max_steps > 0 ? 1 : 0;
    wd[kNexp] = 0;
    wd[kSerial] = static_cast<int>(s_serial + 1u);
    wd[kDone] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) slice_step_out_kernel(
    const SliceArgs a) {
  __shared__ int sh[kWarps];
  __shared__ int s_excl;
  __shared__ bool s_last;
  const int r = blockIdx.y;
  int* wd = a.words + r * kWords;
  if (blockIdx.x == 0 && r == 0 && threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 2), 1ull);
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 6),
              static_cast<unsigned long long>(a.ntemps) * a.bucket);
  }
  const int m = load_word(wd + kLen);
  if (m == 0) return;
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.count_evals)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 4),
              static_cast<unsigned long long>(m));
  const int trip = load_word(wd + kTrip);
  const unsigned serial = static_cast<unsigned>(load_word(wd + kSerial));
  const int ntiles = (m + kThreads - 1) / kThreads;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int* cur =
      a.lists + (static_cast<long long>(a.parity) * a.ntemps + r) * a.cap;
  bool in = false;
  int n = 0;
  int codes[1];
  if (k < m) {
    const int code = cur[k];
    const long long e = static_cast<long long>(r) * 2 * a.ng + code;
    in = a.lp[static_cast<long long>(r) * a.bucket + k] >
         a.y[static_cast<long long>(r) * a.ng + (code >> 1)];
    if (in) {
      a.ends[e] = (code & 1) ? __fadd_rn(a.ends[e], 1.0f)
                             : __fsub_rn(a.ends[e], 1.0f);
      const int c = a.cnt[e] + 1;
      a.cnt[e] = c;
      n = c < a.budget[e];
      codes[0] = code;
    }
  }
  const int nin = __syncthreads_count(in);
  if (threadIdx.x == 0 && nin) {
    atomicAdd(wd + kNexp, nin);
    atomicMax(wd + kItOut, min(trip + 2, a.max_steps));
  }
  if (blockIdx.x < ntiles)
    compact(a, r, blockIdx.x, ntiles, n, codes, serial, a.parity ^ 1, sh,
            &s_excl, [&](int code, int kk) {
              write_point(
                  a, r, code >> 1, a.parity ^ 1, kk,
                  a.ends[static_cast<long long>(r) * 2 * a.ng + code]);
            });
  if (last_block(wd + kDone, gridDim.x, &s_last) && threadIdx.x == 0) {
    wd[kLen] = load_word(wd + kNext);
    wd[kTrip] = trip + 1;
    wd[kSerial] = static_cast<int>(serial + 1u);
    wd[kDone] = 0;
  }
}

// The shrink uniform of walker wi at trip `trip`.
__device__ __forceinline__ float shrink_u(const SliceArgs& a, int r, int wi,
                                          int trip) {
  const long long w = static_cast<long long>(r) * a.ng + wi;
  if (a.shrink_in != nullptr)
    return a.shrink_in[w * a.shrink_cols + min(trip, a.shrink_cols - 1)];
  const Key key = rung_key(a, r);
  const uint64_t off = philox_offset(a.offset_dev, a.offset_inc);
  const uint4 v = philox_at(static_cast<uint32_t>(a.split * a.ng + wi),
                            kShrinkBlock | static_cast<uint32_t>(trip), off,
                            key.k0, key.k1);
  return philox_uniform(v.x);
}

// t = L + u (R - L) of walker wi at trip `trip`, stored, its point written
// into row k of evaluation buffer p.
__device__ __forceinline__ void next_t(const SliceArgs& a, int r, int wi,
                                       int trip, int p, int k) {
  const long long w = static_cast<long long>(r) * a.ng + wi;
  const float L = a.ends[2 * w], R = a.ends[2 * w + 1];
  const float t = __fadd_rn(L, __fmul_rn(shrink_u(a, r, wi, trip),
                                         __fsub_rn(R, L)));
  a.t[w] = t;
  write_point(a, r, wi, p, k, t);
}

template <bool kSetup>
__global__ void __launch_bounds__(kThreads) slice_shrink_kernel(
    const SliceArgs a) {
  __shared__ int sh[kWarps];
  __shared__ int s_excl;
  __shared__ bool s_last;
  const int r = blockIdx.y;
  int* wd = a.words + r * kWords;
  if (kSetup) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < a.ng) {
      a.done[static_cast<long long>(r) * a.ng + i] = 0;
      a.lists[static_cast<long long>(r) * a.cap + i] = i;
      next_t(a, r, i, 0, 0, i);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      wd[kLen] = a.max_shrink > 0 ? a.ng : 0;
      wd[kTrip] = 0;
      wd[kItShr] = 0;
      wd[kNcon] = 0;
    }
    return;
  }
  if (blockIdx.x == 0 && r == 0 && threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 3), 1ull);
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 7),
              static_cast<unsigned long long>(a.ntemps) * a.bucket);
  }
  const int m = load_word(wd + kLen);
  if (m == 0) return;
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.count_evals)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 5),
              static_cast<unsigned long long>(m));
  const int trip = load_word(wd + kTrip);
  const unsigned serial = static_cast<unsigned>(load_word(wd + kSerial));
  const bool last_trip = trip + 1 >= a.max_shrink;
  const int ntiles = (m + kThreads - 1) / kThreads;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int* cur =
      a.lists + (static_cast<long long>(a.parity) * a.ntemps + r) * a.cap;
  bool miss = false;
  int n = 0;
  int codes[1];
  if (k < m) {
    const int wi = cur[k];
    const long long w = static_cast<long long>(r) * a.ng + wi;
    const float lpt = a.lp[static_cast<long long>(r) * a.bucket + k];
    const float t = a.t[w];
    if (lpt > a.y[w]) {
      a.t_acc[w] = t;
      a.lp_acc[w] = lpt;
      a.done[w] = 1;
      copy_leaves(a, r, k, wi);
    } else {
      miss = true;
      a.ends[2 * w + (t < 0.0f ? 0 : 1)] = t;
      if (!last_trip) {
        n = 1;
        codes[0] = wi;
      }
    }
  }
  const int nmiss = __syncthreads_count(miss);
  if (threadIdx.x == 0 && nmiss) atomicAdd(wd + kNcon, nmiss);
  if (blockIdx.x < ntiles)
    compact(a, r, blockIdx.x, ntiles, n, codes, serial, a.parity ^ 1, sh,
            &s_excl, [&](int wi, int kk) {
              next_t(a, r, wi, trip + 1, a.parity ^ 1, kk);
            });
  if (last_block(wd + kDone, gridDim.x, &s_last) && threadIdx.x == 0) {
    wd[kLen] = load_word(wd + kNext);
    wd[kTrip] = trip + 1;
    wd[kItShr] = trip + 1;
    wd[kSerial] = static_cast<int>(serial + 1u);
    wd[kDone] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) slice_finish_kernel(
    const SliceArgs a) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int* wd = a.words + r * kWords;
    a.sums[r] += wd[kNexp];
    a.sums[a.ntemps + r] += wd[kNcon];
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 0),
              static_cast<unsigned long long>(wd[kItOut]));
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters + 1),
              static_cast<unsigned long long>(wd[kItShr]));
  }
  if (i >= a.ng) return;
  const long long w = static_cast<long long>(r) * a.ng + i;
  const long long row = static_cast<long long>(r) * a.nw + a.split * a.ng + i;
  const bool done = a.done[w] != 0;
  a.accepted[row] = done;
  if (!done) return;
  if (a.count != nullptr) a.count[row] += 1;
  const int nd = a.nd;
  float* s = a.x + row * nd;
  const float* e = a.eta + w * nd;
  const float t = a.t_acc[w];
  for (int c = 0; c < nd; ++c) s[c] = __fadd_rn(s[c], __fmul_rn(t, e[c]));
  a.lp_ens[row] = a.lp_acc[w];
  copy_leaves(a, r, i, a.split * a.ng + i);
}

int launch_kernel(int which, const SliceArgs& a, cudaStream_t st) {
  const int n = which == 1 || which == 2 ? a.bucket : a.ng;
  const dim3 grid((n + kThreads - 1) / kThreads, a.ntemps);
  switch (which) {
    case 0:
      slice_setup_kernel<<<grid, kThreads, 0, st>>>(a);
      break;
    case 1:
      slice_step_out_kernel<<<grid, kThreads, 0, st>>>(a);
      break;
    case 2:
      slice_shrink_kernel<false><<<grid, kThreads, 0, st>>>(a);
      break;
    case 3:
      slice_shrink_kernel<true><<<grid, kThreads, 0, st>>>(a);
      break;
    default:
      slice_finish_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int checked(int which, const SliceArgs* args, void* stream) {
  const SliceArgs& a = *args;
  const int n = which == 1 || which == 2 ? a.bucket : a.ng;
  if (a.nd < 1 || a.ng < 1 || a.nw - a.ng < 2 || a.ntemps < 1 ||
      a.ntemps > 65535 || a.cap < 2 * a.ng || n < 1 || n > a.cap ||
      a.nleaves < 0 || a.nleaves > kMaxLeaves ||
      a.tiles < (a.cap + kThreads - 1) / kThreads || a.parity < 0 ||
      a.parity > 1 || 2 * a.ng >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(which, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/slice_kernel.py): the
// arguments by pointer to a host struct; each returns cudaGetLastError()
// after its launch.
extern "C" int emcee_slice_setup(const SliceArgs* a, void* stream) {
  return checked(0, a, stream);
}

extern "C" int emcee_slice_step_out(const SliceArgs* a, void* stream) {
  return checked(1, a, stream);
}

extern "C" int emcee_slice_shrink(const SliceArgs* a, void* stream) {
  return checked(a->bucket > 0 ? 2 : 3, a, stream);
}

extern "C" int emcee_slice_finish(const SliceArgs* a, void* stream) {
  return checked(4, a, stream);
}

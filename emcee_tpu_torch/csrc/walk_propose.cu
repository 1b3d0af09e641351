// K18a and K18b: the walk move's proposals, from the shared factor and
// from each walker's subset.
//
// Replaces the XLA-fused chains of emcee_tpu/moves/walk.py:73-79 (the
// shared covariance's step, q = s + adj (z L^T)) and :81-97 (each
// walker's subset of the complement, its covariance and a normal step),
// vmapped over a ladder's rungs by emcee_tpu/parallel/tempering.py:
// 449-541.  There is no Pallas kernel behind them.  The port ran them as
// plain torch: K14's normals, a batched cov + cholesky_ex + matmul, and
// for the subset an argsort of (ng, nc) Philox keys, a gather of (ng, s0,
// nd) rows and an einsum.  The factor of the shared route is K8a + K8b's
// walk mode (csrc/dime_moments.cu); these kernels take over after it.
// The plain versions are ops/walk_kernel.py walk_propose_plain and
// walk_subset_plain; both kernels equal them bit for bit (every sum from
// +0.0 in a fixed order, every operation rounded once by the _rn
// intrinsics; logf and cosf as the Box-Muller normals use them).
//
// K18a, walk_propose_kernel: one thread a walker f of the flat (rung,
// walker) range.  Row = split * ng + g draws its nd normals at the
// counters the plain move drew at (normal 2j from words 0 and 2, 2j + 1
// from words 1 and 3 of (row, NORMAL_BLOCK | j)), or reads them injected,
// and forms
//   q_d = s_d + adj * sum_{k <= d} z_k L[d][k]     (k in column order)
// (q_d = s_d + the sum untuned).  The normals are written into the
// walker's q row first and q is formed from the last column down: q_d
// reads z_0 .. z_d only, which no later column has overwritten, so any
// ndim needs no more than the row.  factor = 0.
//
// K18b, the subset step, per walker (row as above) and column d:
//   picks p_0 .. p_{s0-1}: the exact subset (nc <= exact_subset_max) is
//     the s0 smallest of the walker's nc uniforms at (row, PICK_BLOCK |
//     j) (uniform 4j + w from word w), ties by index: the words (key24 <<
//     32) | m, key24 = word >> 8, sorted ascending (a uniform is key24
//     2^-24, so this is torch.argsort(uniforms, stable=True)).  Bootstrap
//     (nc larger): p_k = min(int(u_k nc), nc - 1) from the same counters.
//   mean_d = (sum_k x[p_k][d]) / s0
//   dz_d   = (sum_k z_k (x[p_k][d] - mean_d)) / sqrt(s0 - 1)
//   q_d    = s_d + adj dz_d
// with z_k the walker's normals as K18a draws them, z_k beside the k-th
// smallest key's row.  s0 = 1 gives 0 / 0 = NaN, as the plain version
// does (the proposal is rejected).  Three routes (ops/walk_kernel.py
// walk_subset):
//   * route 0, bootstrap, walk_subset_kernel: a block of walkers writes
//     their picks and normals into shared memory, a thread a Philox
//     block, then a thread a (walker, column) sums; where a walker's s0
//     picks and normals do not fit 48 KB, one thread a (walker, column)
//     draws its picks and normals as it sums (the Philox blocks again
//     for the second pass: no buffer, any s0);
//   * route 1, an exact subset of nc <= kSortMax, walk_sort_kernel: one
//     block a walker sorts its nc words by a bitonic network in shared
//     memory (the next power of two, padded with all-ones words, which
//     sort last) and writes its s0 normals there, then a thread a column
//     sums over the first s0;
//   * route 2, picks read from an int64 buffer (pick = the low word):
//     K16's sorted words of a larger exact subset (walk_keys_kernel
//     writes each walker's nc keys, csrc/shuffle_order.cu sorts them, a
//     range of walkers at a time) or injected picks; walk_subset_kernel,
//     staged or not as route 0.
//
// What bounds them on an H100.  K18a: the bytes, s read and q written
// (about 2 MB of a split at 1e5 x 5); the normals are a Philox block and
// two Box-Muller normals a pair of columns.  K18b: the ensemble's rows
// once (2 MB at 1e5 x 5) at the least, but its gathers issue the s0
// picked rows a walker as 32-byte sectors (26 MB at 1e5 x 5, s0 = 16,
// bootstrap; most from L2), and the exact sort's network takes about
// nc log2(nc)^2 / 4 compare-swaps a walker at ladder widths.
//
// The rung axis: rung r = f / ng reads its own rows (x + r nw nd), factor
// L + r nd nd, scale[r] and key keys[r]; one launch serves every rung.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

#define EMCEE_NORMAL_BLOCK 0x40000000u
#define EMCEE_PICK_BLOCK 0x20000000u

// The arguments of every entry point (ops/walk_kernel.py _Args, field for
// field).  Declared outside the anonymous namespace: the C entry points
// take it.
struct WalkArgs {
  const float* x;              // (ntemps, nw, nd)
  float* q;                    // (ntemps, ng, nd)
  float* factor;               // (ntemps, ng)
  const float* L;              // K18a: (ntemps, nd, nd)
  const float* scale;          // (ntemps,) or null
  const float* z_in;           // (ntemps, ng, nd | s0) or null
  const long long* picks;      // route 2: (count | ntemps ng, stride)
  long long* keys_out;         // walk_keys: (count, nc)
  const long long* offset_dev;
  const long long* keys;       // the rungs' key table, or null
  unsigned long long offset_inc, seed;
  int nw, nd, ng, split, ntemps, s0, nc;
  int route;                   // K18b: 0 bootstrap, 1 sorted, 2 buffer
  int f0, count;               // the flat (rung, walker) range
  int pick_stride;             // route 2: picks a walker in the buffer
  int walkers;                 // routes 0, 2: walkers a block, staged
  int threads;
};

namespace {

// The longest exact subset a block sorts (ops/walk_kernel.py SORT_MAX):
// 4096 8-byte words, 32 KB of shared memory.
constexpr int kSortMax = 4096;
// The staged picks and normals a block of routes 0 and 2 holds, at most
// (ops/walk_kernel.py STAGED_SMEM).
constexpr size_t kStagedMax = 48 * 1024;

__device__ __forceinline__ int complement_row(int r, int lo, int ng) {
  return r + (r >= lo ? ng : 0);
}

// A walker's Philox key and offset.
struct Stream {
  uint32_t k0, k1, row;
  uint64_t off;
};

__device__ __forceinline__ Stream stream_of(const WalkArgs& a, int rung,
                                            int g) {
  Stream s;
  unsigned long long key = a.seed;
  if (a.keys != nullptr) key = static_cast<unsigned long long>(a.keys[rung]);
  s.k0 = static_cast<uint32_t>(key);
  s.k1 = static_cast<uint32_t>(key >> 32);
  s.row = static_cast<uint32_t>(a.split * a.ng + g);
  s.off = philox_offset(a.offset_dev, a.offset_inc);
  return s;
}

// The walker's normals in order, a Philox block a pair (kept while the
// next normal is of the same block).
struct Normals {
  Stream s;
  int block = -1;
  uint4 w;
  __device__ __forceinline__ float at(int k) {
    const int j = k >> 1;
    if (j != block) {
      w = philox_at(s.row, EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(j),
                    s.off, s.k0, s.k1);
      block = j;
    }
    return (k & 1) ? philox_normal(w.y, w.w) : philox_normal(w.x, w.z);
  }
};

// The walker's bootstrap picks in order, a Philox block four.
struct Boot {
  Stream s;
  int nc;
  int block = -1;
  uint4 w;
  __device__ __forceinline__ int at(int k) {
    const int j = k >> 2;
    if (j != block) {
      w = philox_at(s.row, EMCEE_PICK_BLOCK | static_cast<uint32_t>(j),
                    s.off, s.k0, s.k1);
      block = j;
    }
    const int i = k & 3;
    const uint32_t word = i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
    return min(static_cast<int>(__fmul_rn(philox_uniform(word),
                                          static_cast<float>(nc))),
               nc - 1);
  }
};

// dz_d of one walker and column: pick(k) gives the complement index of
// the k-th pick, normal(k) its normal.
template <class Pick, class Normal>
__device__ __forceinline__ float subset_dz(const float* __restrict__ x,
                                           int nd, int d, int s0, int lo,
                                           int ng, Pick&& pick,
                                           Normal&& normal) {
  float m = 0.0f;
  for (int k = 0; k < s0; ++k)
    m = __fadd_rn(
        m, x[static_cast<int64_t>(complement_row(pick(k), lo, ng)) * nd + d]);
  m = __fdiv_rn(m, static_cast<float>(s0));
  float acc = 0.0f;
  for (int k = 0; k < s0; ++k) {
    const float v =
        x[static_cast<int64_t>(complement_row(pick(k), lo, ng)) * nd + d];
    acc = __fadd_rn(acc, __fmul_rn(normal(k), __fsub_rn(v, m)));
  }
  return __fdiv_rn(acc, __fsqrt_rn(static_cast<float>(s0 - 1)));
}

__global__ void __launch_bounds__(256) walk_propose_kernel(WalkArgs a) {
  const int f = a.f0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= a.f0 + a.count) return;
  const int rung = f / a.ng, g = f - rung * a.ng;
  const int nd = a.nd;
  const float* s = a.x + (static_cast<int64_t>(rung) * a.nw + a.split * a.ng +
                          g) * nd;
  const float* L = a.L + static_cast<int64_t>(rung) * nd * nd;
  float* q = a.q + static_cast<int64_t>(f) * nd;
  // The normals into the row first.
  if (a.z_in != nullptr) {
    const float* z = a.z_in + static_cast<int64_t>(f) * nd;
    for (int k = 0; k < nd; ++k) q[k] = z[k];
  } else {
    Normals zs{stream_of(a, rung, g)};
    for (int k = 0; k < nd; ++k) q[k] = zs.at(k);
  }
  const bool tuned = a.scale != nullptr;
  const float adj = tuned ? a.scale[rung] : 1.0f;
  for (int d = nd - 1; d >= 0; --d) {
    float acc = 0.0f;
    for (int k = 0; k <= d; ++k)
      acc = __fadd_rn(acc, __fmul_rn(q[k], L[d * nd + k]));
    q[d] = __fadd_rn(s[d], tuned ? __fmul_rn(adj, acc) : acc);
  }
  a.factor[f] = 0.0f;
}

// Routes 0 and 2, staged: a block of `walkers` walkers of the flat range
// first writes each walker's s0 picks (complement indices) and normals
// into shared memory, a thread a Philox block (or a buffer's pick), then
// a thread a (walker, column) sums.  Dynamic shared memory: walkers * s0
// picks, then walkers * s0 normals.
__device__ __forceinline__ void subset_staged(const WalkArgs& a) {
  extern __shared__ int staged[];
  const int W = a.walkers, s0 = a.s0, nd = a.nd, ng = a.ng;
  const int lo = a.split * ng;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int fb = a.f0 + blockIdx.x * W;
  const int nwk = min(W, a.f0 + a.count - fb);
  int* picks = staged;
  float* zs = reinterpret_cast<float*>(staged + W * s0);
  if (a.route == 0) {
    const int per = (s0 + 3) / 4;
    for (int e = tid; e < nwk * per; e += bd) {
      const int w = e / per, j = e - w * per;
      const int f = fb + w, rung = f / ng;
      const Stream st = stream_of(a, rung, f - rung * ng);
      const uint4 u = philox_at(st.row,
                                EMCEE_PICK_BLOCK | static_cast<uint32_t>(j),
                                st.off, st.k0, st.k1);
      const uint32_t ws[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * j + i < s0)
          picks[w * s0 + 4 * j + i] =
              min(static_cast<int>(__fmul_rn(philox_uniform(ws[i]),
                                             static_cast<float>(a.nc))),
                  a.nc - 1);
    }
  } else {
    for (int e = tid; e < nwk * s0; e += bd) {
      const int w = e / s0, k = e - w * s0;
      picks[e] = static_cast<int>(
          a.picks[static_cast<int64_t>(fb - a.f0 + w) * a.pick_stride + k] &
          0xFFFFFFFF);
    }
  }
  if (a.z_in != nullptr) {
    for (int e = tid; e < nwk * s0; e += bd)
      zs[e] = a.z_in[static_cast<int64_t>(fb) * s0 + e];
  } else {
    const int per = (s0 + 1) / 2;
    for (int e = tid; e < nwk * per; e += bd) {
      const int w = e / per, j = e - w * per;
      const int f = fb + w, rung = f / ng;
      const Stream st = stream_of(a, rung, f - rung * ng);
      const uint4 u = philox_at(st.row,
                                EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(j),
                                st.off, st.k0, st.k1);
      zs[w * s0 + 2 * j] = philox_normal(u.x, u.z);
      if (2 * j + 1 < s0) zs[w * s0 + 2 * j + 1] = philox_normal(u.y, u.w);
    }
  }
  __syncthreads();
  for (int e = tid; e < nwk * nd; e += bd) {
    const int w = e / nd, d = e - w * nd;
    const int f = fb + w, rung = f / ng, g = f - rung * ng;
    const float* x = a.x + static_cast<int64_t>(rung) * a.nw * nd;
    const int* p = picks + w * s0;
    const float* z = zs + w * s0;
    const float dz = subset_dz(x, nd, d, s0, lo, ng,
                               [&](int k) { return p[k]; },
                               [&](int k) { return z[k]; });
    const float sd = x[static_cast<int64_t>(lo + g) * nd + d];
    a.q[static_cast<int64_t>(f) * nd + d] = __fadd_rn(
        sd, a.scale != nullptr ? __fmul_rn(a.scale[rung], dz) : dz);
    if (d == 0) a.factor[f] = 0.0f;
  }
}

// Routes 0 and 2: staged (above) where a walker's s0 picks and normals
// fit the block's shared memory (ops/walk_kernel.py subset_walkers), else
// a thread a (walker, column) of the flat range, drawing its picks and
// normals as it sums.
template <bool kStaged>
__global__ void __launch_bounds__(256) walk_subset_kernel(WalkArgs a) {
  if constexpr (kStaged) {
    subset_staged(a);
    return;
  }
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= static_cast<int64_t>(a.count) * a.nd) return;
  const int fl = static_cast<int>(item / a.nd);
  const int d = static_cast<int>(item - static_cast<int64_t>(fl) * a.nd);
  const int f = a.f0 + fl;
  const int rung = f / a.ng, g = f - rung * a.ng;
  const int nd = a.nd, ng = a.ng, lo = a.split * ng;
  const float* x = a.x + static_cast<int64_t>(rung) * a.nw * nd;
  const Stream st = stream_of(a, rung, g);
  const float* z_in =
      a.z_in != nullptr ? a.z_in + static_cast<int64_t>(f) * a.s0 : nullptr;
  Normals zs{st};
  auto normal = [&](int k) { return z_in != nullptr ? z_in[k] : zs.at(k); };
  float dz;
  if (a.route == 0) {
    Boot b{st, a.nc};
    dz = subset_dz(x, nd, d, a.s0, lo, ng, [&](int k) { return b.at(k); },
                   normal);
  } else {
    const long long* p =
        a.picks + static_cast<int64_t>(fl) * a.pick_stride;
    dz = subset_dz(x, nd, d, a.s0, lo, ng,
                   [&](int k) { return static_cast<int>(p[k] & 0xFFFFFFFF); },
                   normal);
  }
  const float sd = x[static_cast<int64_t>(lo + g) * nd + d];
  a.q[static_cast<int64_t>(f) * nd + d] = __fadd_rn(
      sd, a.scale != nullptr ? __fmul_rn(a.scale[rung], dz) : dz);
  if (d == 0) a.factor[f] = 0.0f;
}

// Route 1: one block a walker f0 + blockIdx.x sorts its nc words and
// writes its s0 normals (a thread a Philox block), then a thread a column
// sums.  Dynamic shared memory: the next power of two of nc words, then s0
// normals (at most 32 KB + 16 KB).
__global__ void __launch_bounds__(512) walk_sort_kernel(WalkArgs a) {
  extern __shared__ unsigned long long words[];
  const int f = a.f0 + blockIdx.x;
  const int rung = f / a.ng, g = f - rung * a.ng;
  const int nd = a.nd, ng = a.ng, lo = a.split * ng, nc = a.nc;
  const int tid = threadIdx.x, bd = blockDim.x;
  int P = 2;
  while (P < nc) P <<= 1;
  const Stream st = stream_of(a, rung, g);
  float* zs = reinterpret_cast<float*>(words + P);
  if (a.z_in != nullptr) {
    for (int k = tid; k < a.s0; k += bd)
      zs[k] = a.z_in[static_cast<int64_t>(f) * a.s0 + k];
  } else {
    for (int j = tid; 2 * j < a.s0; j += bd) {
      const uint4 u = philox_at(st.row,
                                EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(j),
                                st.off, st.k0, st.k1);
      zs[2 * j] = philox_normal(u.x, u.z);
      if (2 * j + 1 < a.s0) zs[2 * j + 1] = philox_normal(u.y, u.w);
    }
  }
  for (int j = tid; 4 * j < P; j += bd) {
    uint4 w = make_uint4(0, 0, 0, 0);
    if (4 * j < nc)
      w = philox_at(st.row, EMCEE_PICK_BLOCK | static_cast<uint32_t>(j),
                    st.off, st.k0, st.k1);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * j + i;
      if (m < P)
        words[m] = m < nc ? (static_cast<unsigned long long>(ws[i] >> 8)
                             << 32) | static_cast<unsigned long long>(m)
                          : ~0ull;
    }
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (P >> 1); i += bd) {
        const int l = 2 * i - (i & (stride - 1));
        const int h = l + stride;
        const unsigned long long u = words[l], v = words[h];
        if ((u > v) == ((l & size) == 0)) {
          words[l] = v;
          words[h] = u;
        }
      }
      __syncthreads();
    }
  }
  const float* x = a.x + static_cast<int64_t>(rung) * a.nw * nd;
  for (int d = tid; d < nd; d += bd) {
    const float dz = subset_dz(
        x, nd, d, a.s0, lo, ng,
        [&](int k) { return static_cast<int>(words[k] & 0xFFFFFFFF); },
        [&](int k) { return zs[k]; });
    const float sd = x[static_cast<int64_t>(lo + g) * nd + d];
    a.q[static_cast<int64_t>(f) * nd + d] = __fadd_rn(
        sd, a.scale != nullptr ? __fmul_rn(a.scale[rung], dz) : dz);
  }
  if (tid == 0) a.factor[f] = 0.0f;
}

// The sort keys of a larger exact subset: word >> 8 of uniform m of
// walker f0 + i into keys_out[i nc + m], a thread a Philox block.
__global__ void __launch_bounds__(256) walk_keys_kernel(WalkArgs a) {
  const int per = (a.nc + 3) / 4;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= static_cast<int64_t>(a.count) * per) return;
  const int fl = static_cast<int>(item / per);
  const int j = static_cast<int>(item - static_cast<int64_t>(fl) * per);
  const int f = a.f0 + fl;
  const int rung = f / a.ng, g = f - rung * a.ng;
  const Stream st = stream_of(a, rung, g);
  const uint4 w = philox_at(st.row,
                            EMCEE_PICK_BLOCK | static_cast<uint32_t>(j),
                            st.off, st.k0, st.k1);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  long long* out = a.keys_out + static_cast<int64_t>(fl) * a.nc;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * j + i < a.nc) out[4 * j + i] = static_cast<long long>(ws[i] >> 8);
}

int blocks_of(int64_t n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/walk_kernel.py).  Every
// pointer in the arguments is a device pointer; the flat (rung, walker)
// range [f0, f0 + count) of ntemps * ng walkers.  emcee_walk_propose: K18a
// (L the rungs' factors).  emcee_walk_subset: K18b by route (1: at most
// kSortMax complement rows, dynamic shared memory of the next power of two
// of nc words).  emcee_walk_keys: the sort keys of the range into
// keys_out.  Each returns cudaGetLastError() after its launch.
extern "C" int emcee_walk_propose(const WalkArgs* a, void* stream) {
  if (a->threads < 32 || a->threads > 256 || a->count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  walk_propose_kernel<<<blocks_of(a->count, a->threads), a->threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emcee_walk_subset(const WalkArgs* a, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (a->count < 1 || a->s0 < 1 || a->nc < 2 || a->route < 0 ||
      a->route > 2 || (a->route == 1 && a->nc > kSortMax) ||
      (a->route == 2 && a->picks == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->route == 1) {
    if (a->threads < 32 || a->threads > 512)
      return static_cast<int>(cudaErrorInvalidValue);
    int P = 2;
    while (P < a->nc) P <<= 1;
    walk_sort_kernel<<<a->count, a->threads,
                       sizeof(unsigned long long) * P + sizeof(float) * a->s0,
                       st>>>(*a);
  } else if (a->walkers > 0) {
    const size_t smem = sizeof(int) * 2 * static_cast<size_t>(a->walkers) *
                        a->s0;
    if (a->threads < 32 || a->threads > 256 || smem > kStagedMax)
      return static_cast<int>(cudaErrorInvalidValue);
    walk_subset_kernel<true><<<blocks_of(a->count, a->walkers), a->threads,
                               smem, st>>>(*a);
  } else {
    if (a->threads < 32 || a->threads > 256)
      return static_cast<int>(cudaErrorInvalidValue);
    walk_subset_kernel<false><<<blocks_of(static_cast<int64_t>(a->count) *
                                              a->nd,
                                          a->threads),
                                a->threads, 0, st>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emcee_walk_keys(const WalkArgs* a, void* stream) {
  if (a->threads < 32 || a->threads > 256 || a->count < 1 ||
      a->keys_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  walk_keys_kernel<<<blocks_of(static_cast<int64_t>(a->count) *
                                   ((a->nc + 3) / 4),
                               a->threads),
                     a->threads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

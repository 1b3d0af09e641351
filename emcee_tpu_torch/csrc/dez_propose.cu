// K10a and K10b: DE-Z's complement spread and its proposal.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/de_z.py:144-225
// (get_proposal: the pool of the complement and the filled archive, the
// picks, the DE step with its gamma jitter and g1_prob jump, the noise
// scaled by the complement's spread and its floor, the snooker update and
// its factor).  The port ran it as plain torch: per split two K14 draws,
// five pool gathers, a copy of the complement for one std and ~15
// elementwise kernels.  The plain versions are ops/dez_kernel.py
// dez_spread_plain, spread_plain and dez_propose_plain; each kernel agrees
// with them bit for bit: every sum from +0.0 in a fixed order, every
// operation rounded once (the _rn intrinsics, so nothing is contracted
// into a fused multiply-add), logf as torch's on the card, the draws those
// of ops/philox.py at the same counters.
//
// K10a, dez_spread_kernel: block (b, rung) takes runs [b G, (b + 1) G) of
// rows rows each of the rung's set (its rows outside [lo, lo + count): a
// split's complement read in place).  Each (run, column) item forms the
// run's count, its mean as an offset from the set's first row (the rows'
// offsets from that row, summed in row order, over the count: no mean is
// rounded near a large value) and its centered sum of squares (in row
// order); the block merges its runs by the pairwise tree's first
// levels (level s: node p takes node p + s, Chan's combine) and writes one
// partial (count, mean[nd], M2[nd]).  The rows are staged in shared memory
// where they fit (kStaged).
//
// K10b, dez_propose_kernel: one thread a walker.  The block's prologue
// (where de_noise > 0) merges the rung's partials by the rest of the tree:
// copied to shared memory and merged level by level by every thread
// (tree_shared), or, where they do not fit, a thread a column in a stack
// that merges two subtrees of one level as the level-by-level tree does,
// then folds from its top (the same bits); then the spread sqrt(M2 / n),
// its floor
// max(spread, 0.01 mean(spread) + 1e-12) (the mean summed in column order)
// and the noise scale de_noise * spread, in shared memory.  Each thread
// then:
//   reads n_avail = nc + filled[rung] (a device word: graph replays see it
//     grow until the ring is full);
//   draws uniforms u0..u7 from words 0-3 of (row, DEZ_BLOCK | 0) and
//     (row, DEZ_BLOCK | 1), and normal m (0 the gamma jitter, 1 + c the
//     noise of column c) by Box-Muller on words (0, 2) (m even) or (1, 3)
//     (m odd) of (row, NORMAL_BLOCK | m / 2); any draw may be injected;
//   picks i = pick(u0, n_avail), j = pick(u1, n_avail - 1) (then j + 1
//     where j >= i), a, b, e from u2, u3, u4, with pick(u, n) = max(min(
//     int(u n), n - 1), 0) in float32; jump = u5 < g1_prob, snooker = u6 <
//     snooker_prob (only where those are > 0);
//   reads pool row r in place: complement row r (r + ng past the split's
//     first row) for r < nc, else archive row r - nc;
//   writes q = s + gamma (p_j - p_i) + scale z_{1..} with gamma = g0 (1 +
//     sigma z_0) (1 on a jump) and the factor 0, or for a snooker walker
//     q = s + u (gammas u.(p_b - p_e)), u = (s - p_a) / norm, norm =
//     sqrt(max(|s - p_a|^2, 1e-24)) and the factor (ndim - 1) (log(max(|
//     norm + gp|, 1e-24)) - log(norm)), the sums in column order.
//
// What bounds them on an H100: bytes.  K10a reads the complement once (1
// MB of a split's at 1e5 x 5); its serial chains are a run's 128 rows.
// K10b reads its row, two pool rows (a snooker walker three), writes q and
// the factor, and draws 2 + ceil((nd + 1) / 2) Philox blocks: at nd 5 the
// pool rows' random reads and the rounds are close.  A walker's loops over
// the columns unroll for nd <= 8 (kNd).
//
// The rung axis (emcee_tpu/parallel/tempering.py:449-541 vmaps DE-Z over
// the ladder): blockIdx.y is the rung, with its rows, archive, filled word,
// partials, outputs and injected draws one rung after the other, and (in
// K10b, kRungs) its own key keys[r].
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

// ops/philox.py NORMAL_BLOCK, DEZ_BLOCK
constexpr uint32_t kNormalBlock = 0x40000000u;
constexpr uint32_t kDezBlock = 0x08000000u | 0x100000u;
// ops/dez_kernel.py DEZ_GROUP_MAX
constexpr int kGroupMax = 8;
// K10b's merge stack: one entry a level of a tree of up to 2^31 partials
constexpr int kStack = 33;
constexpr int kThreadsMax = 256;

// Chan's combine of (na, ma, qa) and (nb, mb, qb), one column: A where B
// is empty, B where A is (ops/dez_kernel.py _merge).
__device__ __forceinline__ void chan(float na, float ma, float qa, float nb,
                                     float mb, float qb, float& n, float& m,
                                     float& q) {
  if (nb == 0.0f) {
    n = na;
    m = ma;
    q = qa;
    return;
  }
  if (na == 0.0f) {
    n = nb;
    m = mb;
    q = qb;
    return;
  }
  const float nn = __fadd_rn(na, nb);
  const float d = __fsub_rn(mb, ma);
  const float coef = __fdiv_rn(__fmul_rn(na, nb), nn);
  m = __fadd_rn(ma, __fmul_rn(d, __fdiv_rn(nb, nn)));
  q = __fadd_rn(__fadd_rn(qa, qb), __fmul_rn(coef, __fmul_rn(d, d)));
  n = nn;
}

// Levels s = 1, 2, 4, ... below `upto` of the pairwise tree over the
// partials node[0 .. count) (1 + 2 nd floats apart, in shared memory):
// node p takes node p + s for p = 0, 2s, ... by Chan's combine, an item a
// (node, column), every thread of the block; the counts after a barrier,
// since each column's combine reads them.  Control flow is uniform.
__device__ void tree_levels(float* node, int count, int upto, int nd) {
  const int width = 1 + 2 * nd;
  for (int s = 1; s < upto && s < count; s *= 2) {
    const int pairs = (count - s + 2 * s - 1) / (2 * s);
    for (int item = threadIdx.x; item < pairs * nd; item += blockDim.x) {
      const int k = item / nd;
      const int c = item - k * nd;
      float* A = node + 2 * s * k * width;
      const float* B = A + s * width;
      float nn, m, q;
      chan(A[0], A[1 + c], A[1 + nd + c], B[0], B[1 + c], B[1 + nd + c], nn,
           m, q);
      A[1 + c] = m;
      A[1 + nd + c] = q;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
      float* A = node + 2 * s * k * width;
      A[0] = __fadd_rn(A[0], A[s * width]);
    }
    __syncthreads();
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreadsMax) dez_spread_kernel(
    const float* __restrict__ x, float* __restrict__ part, int nw, int nd,
    int lo, int count, int rows, int group, int blocks) {
  extern __shared__ float smem[];
  const int rung = blockIdx.y;
  const int b = blockIdx.x;
  const int n = nw - count;
  const int nruns = (n + rows - 1) / rows;
  const float* xr = x + static_cast<int64_t>(rung) * nw * nd;
  const int64_t first = static_cast<int64_t>(b) * rows * group;
  const int span = static_cast<int>(
      min(static_cast<int64_t>(rows) * group, static_cast<int64_t>(n) - first));
  const int stride = rows * nd + 1;  // a run's rows, a word of padding
  const int width = 1 + 2 * nd;
  float* node = smem + (kStaged ? group * stride : 0);
  if constexpr (kStaged) {
    // Unrolled, so that several loads are in flight before their stores.
#pragma unroll 8
    for (int e = threadIdx.x; e < span * nd; e += blockDim.x) {
      const int r = e / nd;
      const int c = e - r * nd;
      const int g = r / rows;
      const int64_t sr = first + r;
      const int64_t xrow = sr < lo ? sr : sr + count;
      smem[g * stride + (r - g * rows) * nd + c] = xr[xrow * nd + c];
    }
    __syncthreads();
  }
  // Each run's (count, mean, M2), an item a (run, column).
  for (int item = threadIdx.x; item < group * nd; item += blockDim.x) {
    const int g = item / nd;
    const int c = item - g * nd;
    const int r0 = g * rows;
    const int len = min(rows, span - r0);
    float* out = node + g * width;
    if (len <= 0) {
      if (c == 0) out[0] = 0.0f;
      continue;
    }
    const auto val = [&](int r) -> float {
      if constexpr (kStaged) {
        return smem[g * stride + r * nd + c];
      } else {
        const int64_t sr = first + r0 + r;
        return xr[(sr < lo ? sr : sr + count) * nd + c];
      }
    };
    // The set's first row: every run's offsets and mean are from it.
    const float shift = xr[static_cast<int64_t>(lo > 0 ? 0 : count) * nd + c];
    float s = 0.0f;
#pragma unroll 8
    for (int r = 0; r < len; ++r) s = __fadd_rn(s, __fsub_rn(val(r), shift));
    const float cnt = static_cast<float>(len);
    const float mean = __fdiv_rn(s, cnt);
    float m2 = 0.0f;
#pragma unroll 8
    for (int r = 0; r < len; ++r) {
      const float t = __fsub_rn(__fsub_rn(val(r), shift), mean);
      m2 = __fadd_rn(m2, __fmul_rn(t, t));
    }
    if (c == 0) out[0] = cnt;
    out[1 + c] = mean;
    out[1 + nd + c] = m2;
  }
  __syncthreads();
  // The tree's first levels over the block's runs (those of the set only).
  tree_levels(node, min(group, nruns - b * group), group, nd);
  float* dst = part + (static_cast<int64_t>(rung) * blocks + b) * width;
  for (int k = threadIdx.x; k < width; k += blockDim.x) dst[k] = node[k];
}

}  // namespace

// K10b's arguments (ops/dez_kernel.py _ProposeArgs, field for field).
// Pointers are device pointers; the injected draws null where drawn, part
// null where de_noise is 0.
struct DezProposeArgs {
  const float* x;
  const float* archive;
  const int* filled;
  const float* part;
  float* q;
  float* factor;
  const float* z_in;
  const int* i_in;
  const int* j_in;
  const int* a_in;
  const int* b_in;
  const int* e_in;
  const unsigned char* jump_in;
  const unsigned char* snooker_in;
  const long long* offset_dev;
  const long long* keys;
  unsigned long long offset_inc;
  unsigned long long seed;
  int nw, nd, ng, split, capacity, ntemps, blocks, threads, draw_u0, draw_u1,
      draw_z, g1, snooker, tree_shared;
  float gamma0, sigma, g1_prob, snooker_prob, gammas, de_noise, ndim_m1;
};

namespace {

// Normal m of a walker row from Philox block word w of counter m / 2.
__device__ __forceinline__ float normal_of(const uint4& w, int m) {
  return (m & 1) ? philox_normal(w.y, w.w) : philox_normal(w.x, w.z);
}

// torch.maximum: NaN where either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// The port's randint(0, n): max(min(int(u n), n - 1), 0) in float32.
__device__ __forceinline__ int pick(float u, int n) {
  const int k = static_cast<int>(__fmul_rn(u, static_cast<float>(n)));
  return max(min(k, n - 1), 0);
}

template <int kNd, bool kRungs>
__global__ void __launch_bounds__(kThreadsMax) dez_propose_kernel(
    DezProposeArgs a) {
  extern __shared__ float scale[];  // the noise scale a column, the floor
  const int rung = kRungs ? blockIdx.y : 0;
  const int nd = kNd > 0 ? kNd : a.nd;
  if (a.part != nullptr) {
    const int width = 1 + 2 * nd;
    const float* pr = a.part + static_cast<int64_t>(rung) * a.blocks * width;
    if (a.tree_shared) {
      // The partials in shared memory, then the tree's levels there.
      float* tree = scale + nd + 1;
#pragma unroll 4
      for (int e = threadIdx.x; e < a.blocks * width; e += blockDim.x)
        tree[e] = pr[e];
      __syncthreads();
      tree_levels(tree, a.blocks, a.blocks, nd);
      for (int c = threadIdx.x; c < nd; c += blockDim.x)
        scale[c] = __fsqrt_rn(__fdiv_rn(tree[1 + nd + c], tree[0]));
    } else {
      // Too many partials for shared memory: a thread a column merges them
      // from global memory in a stack.
      for (int c = threadIdx.x; c < nd; c += blockDim.x) {
        float sn[kStack], sm[kStack], sq[kStack];
        int sl[kStack];
        int top = 0;
        for (int p = 0; p < a.blocks; ++p) {
          float n = pr[p * width];
          float m = pr[p * width + 1 + c];
          float q = pr[p * width + 1 + nd + c];
          int level = 0;
          while (top > 0 && sl[top - 1] == level) {
            --top;
            chan(sn[top], sm[top], sq[top], n, m, q, n, m, q);
            ++level;
          }
          sn[top] = n;
          sm[top] = m;
          sq[top] = q;
          sl[top] = level;
          ++top;
        }
        float n = sn[top - 1], m = sm[top - 1], q = sq[top - 1];
        for (int k = top - 2; k >= 0; --k)
          chan(sn[k], sm[k], sq[k], n, m, q, n, m, q);
        scale[c] = __fsqrt_rn(__fdiv_rn(q, n));
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.0f;
      for (int c = 0; c < nd; ++c) sum = __fadd_rn(sum, scale[c]);
      scale[nd] = __fadd_rn(
          __fmul_rn(static_cast<float>(0.01),
                    __fdiv_rn(sum, static_cast<float>(nd))),
          static_cast<float>(1e-12));
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nd; c += blockDim.x)
      scale[c] = __fmul_rn(a.de_noise, nan_max(scale[c], scale[nd]));
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.ng) return;
  const int64_t w = static_cast<int64_t>(rung) * a.ng + i;  // walker index
  const float* xr = a.x + static_cast<int64_t>(rung) * a.nw * nd;
  const float* ar = a.archive + static_cast<int64_t>(rung) * a.capacity * nd;
  uint32_t k0 = static_cast<uint32_t>(a.seed);
  uint32_t k1 = static_cast<uint32_t>(a.seed >> 32);
  if (kRungs && a.keys != nullptr) {
    const auto key = static_cast<unsigned long long>(a.keys[rung]);
    k0 = static_cast<uint32_t>(key);
    k1 = static_cast<uint32_t>(key >> 32);
  }
  const uint64_t off = philox_offset(a.offset_dev, a.offset_inc);
  const int row0 = a.split * a.ng;
  const uint32_t row = static_cast<uint32_t>(row0 + i);
  const int nc = a.nw - a.ng;
  const int n_avail = nc + a.filled[rung];
  const float* s = xr + static_cast<int64_t>(row0 + i) * nd;
  float* q = a.q + w * nd;
  const auto pool = [&](int r) -> const float* {
    return r < nc ? xr + static_cast<int64_t>(r >= row0 ? r + a.ng : r) * nd
                  : ar + static_cast<int64_t>(r - nc) * nd;
  };
  uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
  if (a.draw_u0) u0 = philox_at(row, kDezBlock, off, k0, k1);
  if (a.draw_u1) u1 = philox_at(row, kDezBlock | 1u, off, k0, k1);
  bool use_sn = false;
  if (a.snooker)
    use_sn = a.snooker_in != nullptr
                 ? a.snooker_in[w] != 0
                 : philox_uniform(u1.z) < a.snooker_prob;
  const int ncol = kNd > 0 ? kNd : nd;

  if (use_sn) {
    const int pa = a.a_in != nullptr ? a.a_in[w]
                                     : pick(philox_uniform(u0.z), n_avail);
    const int pb = a.b_in != nullptr ? a.b_in[w]
                                     : pick(philox_uniform(u0.w), n_avail);
    const int pe = a.e_in != nullptr ? a.e_in[w]
                                     : pick(philox_uniform(u1.x), n_avail);
    const float* za = pool(pa);
    const float* zb = pool(pb);
    const float* ze = pool(pe);
    const float lim = static_cast<float>(1e-24);
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const float d = __fsub_rn(s[c], za[c]);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
    const float norm = __fsqrt_rn(clamp_min(ss, lim));
    float proj = 0.0f;
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const float u = __fdiv_rn(__fsub_rn(s[c], za[c]), norm);
      proj = __fadd_rn(proj, __fmul_rn(u, __fsub_rn(zb[c], ze[c])));
    }
    const float gp = __fmul_rn(a.gammas, proj);
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const float u = __fdiv_rn(__fsub_rn(s[c], za[c]), norm);
      q[c] = __fadd_rn(s[c], __fmul_rn(u, gp));
    }
    a.factor[w] = __fmul_rn(
        a.ndim_m1, __fsub_rn(logf(clamp_min(fabsf(__fadd_rn(norm, gp)), lim)),
                             logf(norm)));
    return;
  }

  int pi = a.i_in != nullptr ? a.i_in[w] : pick(philox_uniform(u0.x), n_avail);
  int pj = a.j_in != nullptr ? a.j_in[w]
                             : pick(philox_uniform(u0.y), n_avail - 1);
  pj = pj >= pi ? pj + 1 : pj;
  bool jump = false;
  if (a.g1)
    jump = a.jump_in != nullptr ? a.jump_in[w] != 0
                                : philox_uniform(u1.y) < a.g1_prob;
  const int zw = 1 + nd;
  uint4 wd = make_uint4(0u, 0u, 0u, 0u);
  if (a.draw_z) wd = philox_at(row, kNormalBlock, off, k0, k1);
  const float z0 = a.draw_z ? normal_of(wd, 0) : a.z_in[w * zw];
  const float gamma =
      jump ? 1.0f
           : __fmul_rn(a.gamma0, __fadd_rn(1.0f, __fmul_rn(a.sigma, z0)));
  const float* pjr = pool(pj);
  const float* pir = pool(pi);
  const bool noise = a.part != nullptr;
#pragma unroll
  for (int c = 0; c < ncol; ++c) {
    float v = __fadd_rn(s[c], __fmul_rn(gamma, __fsub_rn(pjr[c], pir[c])));
    if (noise) {
      const int m = 1 + c;
      if (a.draw_z && (m & 1) == 0)
        wd = philox_at(row, kNormalBlock | static_cast<uint32_t>(m >> 1), off,
                       k0, k1);
      const float z = a.draw_z ? normal_of(wd, m) : a.z_in[w * zw + m];
      v = __fadd_rn(v, __fmul_rn(scale[c], z));
    }
    q[c] = v;
  }
  a.factor[w] = 0.0f;
}

template <int kNd>
int launch_propose(const DezProposeArgs& a, cudaStream_t stream) {
  const dim3 grid((a.ng + a.threads - 1) / a.threads, a.ntemps);
  const size_t smem =
      a.part == nullptr
          ? 0
          : sizeof(float) *
                (a.nd + 1 + (a.tree_shared ? a.blocks * (1 + 2 * a.nd) : 0));
  if (a.ntemps > 1)
    dez_propose_kernel<kNd, true><<<grid, a.threads, smem, stream>>>(a);
  else
    dez_propose_kernel<kNd, false><<<grid, a.threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/dez_kernel.py).
//
// K10a: x (ntemps, nw, nd) the rows, the set those outside [lo, lo +
// count); part (ntemps, blocks, 1 + 2 nd) out; runs of `rows` rows, `group`
// a block; staged: the block's rows in shared memory; smem the dynamic
// shared memory (ops/dez_kernel.py spread_smem).  Returns
// cudaGetLastError() after the launch.
extern "C" int emcee_dez_spread(const float* x, float* part, int nw, int nd,
                                int lo, int count, int rows, int group,
                                int blocks, int ntemps, int threads,
                                int staged, int smem, void* stream) {
  if (threads < 32 || threads > kThreadsMax || nd < 1 || rows < 1 ||
      group < 1 || group > kGroupMax || blocks < 1 || ntemps < 1 ||
      nw - count < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, ntemps);
  if (staged)
    dez_spread_kernel<true><<<grid, threads, smem, st>>>(
        x, part, nw, nd, lo, count, rows, group, blocks);
  else
    dez_spread_kernel<false><<<grid, threads, smem, st>>>(
        x, part, nw, nd, lo, count, rows, group, blocks);
  return static_cast<int>(cudaGetLastError());
}

// K10b: the arguments by pointer to a host struct; x (ntemps, nw, nd) the
// rows, archive (ntemps, capacity, nd), filled (ntemps,), part K10a's, q
// (ntemps, ng, nd) and factor (ntemps, ng) out; keys null for one key
// (seed), else rung r's key keys[r].  Returns cudaGetLastError() after the
// launch.
extern "C" int emcee_dez_propose(const DezProposeArgs* args, void* stream) {
  const DezProposeArgs a = *args;
  if (a.threads < 32 || a.threads > kThreadsMax || a.ng < 1 || a.nd < 1 ||
      a.capacity < 1 || a.ntemps < 1 ||
      (a.part != nullptr &&
       (a.blocks < 1 ||
        4 * (a.nd + 1 + (a.tree_shared ? a.blocks * (1 + 2 * a.nd) : 0)) >
            48 * 1024)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (a.nd) {
#define EMCEE_DEZ_ND(N) \
  case N:               \
    return launch_propose<N>(a, st);
    EMCEE_DEZ_ND(1)
    EMCEE_DEZ_ND(2)
    EMCEE_DEZ_ND(3)
    EMCEE_DEZ_ND(4)
    EMCEE_DEZ_ND(5)
    EMCEE_DEZ_ND(6)
    EMCEE_DEZ_ND(7)
    EMCEE_DEZ_ND(8)
#undef EMCEE_DEZ_ND
    default:
      return launch_propose<0>(a, st);
  }
}

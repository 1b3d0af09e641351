// K8c: DIME's proposal and Hastings factor, one thread a walker.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/dime.py:298-431
// (get_proposal and _get_proposal_mixture: the draws, q_t = mean + L z
// sqrt(df / chi2), the DE step, the two Mahalanobis forms or the mixture's
// logsumexp, the factor).  The port ran it as plain torch with cuBLAS
// products and K14's draws.  The plain version is ops/dime_kernel.py
// dime_propose_plain; the two agree bit for bit: every sum from +0.0 in
// index order, every operation rounded once (the _rn intrinsics), logf /
// log1pf / expf / cosf as torch's on the card, the draws those of
// ops/philox.py at the same counters:
//   normal m of walker row r: Box-Muller on words (0, 2) (m even) or
//     (1, 3) (m odd) of (r, NORMAL_BLOCK | m / 2): z_0 .. z_{nd-1}, then
//     the DE jitter zg = normal nd;
//   uniforms u0 .. u3: words 0-3 of (r, DIME_BLOCK): the kernel select
//     (u0 < aimh_prob), the DE picks i = min(int(u1 nc), nc - 1) and j =
//     min(int(u2 (nc - 1)), nc - 2) (then j + 1 where j >= i), the
//     component (the count of cdf_k <= u3, k < K - 1);
//   chi2 of an integer df: the sum of df squared normals at (r,
//     CHI2_BLOCK | m / 2) in order; of another df the first accepted of
//     `candidates` Marsaglia-Tsang candidates (candidate k: a normal from
//     words 0 and 2, its uniform from word 1, of (r, CHI2_BLOCK | k)), df
//     and one more exhaustion on the device counter where none is.
// Any draw may be injected instead (the parity mode).
//
// The table is K8b's for this rung (ops/dime_kernel.py unpack_table):
// means, factors L, inverses L^-1, log-weights, log-determinants, the
// weights' running sum.  q_t_j = mean_j + (sum_{i<=j} z_i L_ji) ts, ts =
// sqrt(df / chi2) (one component), or mean_cj + ((mean_cj + sum z_i L_cji)
// - mean_cj) ts (the component c of the mixture, as the JAX package
// forms it).  A walker's rows live in registers for nd <= kNd; above it
// the q row itself holds z, then q_t, then (for a DE walker) the DE step.
// The factor: for one component (-(df + nd) / 2) (log1p(m_s / df) -
// log1p(m_q / df)) or (m_q - m_s) / 2 with m = |L^-1 (x - mean)|^2 summed
// in index order; for the mixture log q(s) - log q(q_t), log q a
// logsumexp over the components of (logw - logdet) - ((df + nd) / 2)
// log1p(m / df) (or - m / 2), its maximum set to 0 where infinite.  The
// factor is 0 for a DE walker.
//
// What bounds it on an H100: bytes (each walker's row read, its q and
// factor written, its partners' rows for a DE step) and, at nd 5, the
// Philox rounds and the special functions of its draws.  A walker's
// normals, uniforms and chi-square cost ceil((nd + 1) / 2) + 1 + 5
// Philox blocks; the table is a few hundred bytes read through L1.
//
// The rung axis (emcee_tpu/parallel/tempering.py:449-541 vmaps DIME over
// the ladder): kRungs takes rung blockIdx.y, under its own key keys[r],
// with its rows, table, outputs and injected draws one rung after the
// other.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

// ops/philox.py NORMAL_BLOCK, DIME_BLOCK, CHI2_BLOCK
constexpr uint32_t kNormalBlock = 0x40000000u;
constexpr uint32_t kDimeBlock = 0x08000000u | 0x200000u;
constexpr uint32_t kChi2Block = 0x08000000u | 0x300000u;
}  // namespace

// The launch's arguments (ops/dime_kernel.py _ProposeArgs, field for
// field).  Pointers are device pointers; the injected draws null where
// drawn.
struct DimeProposeArgs {
  const float* x;
  const float* table;
  float* q;
  float* factor;
  const float* z_in;
  const float* zg_in;
  const int* i_in;
  const int* j_in;
  const unsigned char* use_in;
  const float* chi2_in;
  const int* comp_in;
  unsigned long long* exhausted;
  const long long* offset_dev;
  const long long* keys;
  unsigned long long offset_inc;
  unsigned long long seed;
  int nw, nd, ng, split, K, ntemps, df_mode, df_int, de, draw_u, threads,
      candidates;
  float df, mt_d, mt_c, mt_2d, fac_t, fac_mix, aimh, gamma0, sigma;
};

namespace {

// Normal m of a walker row from Philox block word w of counter m / 2.
__device__ __forceinline__ float normal_of(const uint4& w, int m) {
  return (m & 1) ? philox_normal(w.y, w.w) : philox_normal(w.x, w.z);
}

// The rows of a walker: registers for kNd > 0, else the q row.
template <int kNd>
struct Row {
  float r[kNd > 0 ? kNd : 1];
  float* g;
  __device__ __forceinline__ float& operator[](int i) {
    if constexpr (kNd > 0) {
      return r[i];
    } else {
      return g[i];
    }
  }
};

// |L^-1 (x - mean)|^2: y_j = sum_{i<=j} (x_i - mean_i) Li_ji, then sum y_j^2.
template <int kNd, typename X>
__device__ __forceinline__ float quad(X& x, const float* mean,
                                      const float* li, int nd) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < (kNd > 0 ? kNd : nd); ++j) {
    float y = 0.0f;
#pragma unroll
    for (int i = 0; i <= j; ++i)
      y = __fadd_rn(y, __fmul_rn(__fsub_rn(x[i], mean[i]), li[j * nd + i]));
    m = __fadd_rn(m, __fmul_rn(y, y));
  }
  return m;
}

// The mixture's log-density of x up to the shared constant.
template <int kNd, typename X>
__device__ __forceinline__ float logq(X& x, const float* mean,
                                      const float* li, const float* logw,
                                      const float* logdet, int K, int nd,
                                      int df_mode, float df, float fac_mix) {
  const int nn = nd * nd;
  float mx = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float m = quad<kNd>(x, mean + k * nd, li + k * nn, nd);
    const float base = __fsub_rn(logw[k], logdet[k]);
    const float c =
        df_mode == 0
            ? __fsub_rn(base, __fmul_rn(0.5f, m))
            : __fsub_rn(base, __fmul_rn(fac_mix, log1pf(__fdiv_rn(m, df))));
    if (k == 0 || c > mx || isnan(c)) mx = c;
  }
  if (fabsf(mx) == INFINITY) mx = 0.0f;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float m = quad<kNd>(x, mean + k * nd, li + k * nn, nd);
    const float base = __fsub_rn(logw[k], logdet[k]);
    const float c =
        df_mode == 0
            ? __fsub_rn(base, __fmul_rn(0.5f, m))
            : __fsub_rn(base, __fmul_rn(fac_mix, log1pf(__fdiv_rn(m, df))));
    acc = __fadd_rn(acc, expf(__fsub_rn(c, mx)));
  }
  return __fadd_rn(logf(acc), mx);
}

// A row of the buffer as an indexable source.
struct Global {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const { return p[i]; }
};

template <int kNd, bool kRungs>
__global__ void __launch_bounds__(256) dime_propose_kernel(
    DimeProposeArgs a) {
  const int rung = kRungs ? blockIdx.y : 0;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.ng) return;
  const int nd = kNd > 0 ? kNd : a.nd;
  const int nn = nd * nd;
  const int K = a.K;
  const int64_t tab = static_cast<int64_t>(K) * (nd + 2 * nn + 3);
  const float* x = a.x + static_cast<int64_t>(rung) * a.nw * nd;
  const float* table = a.table + rung * tab;
  const int64_t w = static_cast<int64_t>(rung) * a.ng + i;  // walker index
  float* q = a.q + w * nd;
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
  const float* s = x + static_cast<int64_t>(row0 + i) * nd;
  const float* mean = table;
  const float* L = table + K * nd;
  const float* li = L + K * nn;
  const float* logw = li + K * nn;
  const float* logdet = logw + K;
  const float* cdf = logdet + K;

  // The draws.
  Row<kNd> z;
  z.g = q;
  float zg = 0.0f;
  if (a.z_in != nullptr) {
#pragma unroll
    for (int m = 0; m < (kNd > 0 ? kNd : nd); ++m) z[m] = a.z_in[w * nd + m];
  } else {
#pragma unroll
    for (int m = 0; m < (kNd > 0 ? kNd : nd); m += 2) {
      const uint4 wd = philox_at(row, kNormalBlock | (m >> 1), off, k0, k1);
      z[m] = normal_of(wd, m);
      if (m + 1 < nd) z[m + 1] = normal_of(wd, m + 1);
    }
  }
  if (a.de) {
    if (a.zg_in != nullptr) {
      zg = a.zg_in[w];
    } else {
      const uint4 wd = philox_at(row, kNormalBlock | (nd >> 1), off, k0, k1);
      zg = normal_of(wd, nd);
    }
  }
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (a.draw_u) u = philox_at(row, kDimeBlock, off, k0, k1);
  bool use_t = true;
  if (a.de)
    use_t = a.use_in != nullptr ? a.use_in[w] != 0
                                : philox_uniform(u.x) < a.aimh;
  int comp = 0;
  if (K > 1) {
    if (a.comp_in != nullptr) {
      comp = a.comp_in[w];
    } else {
      const float u3 = philox_uniform(u.w);
      for (int k = 0; k < K - 1; ++k) comp += u3 >= cdf[k] ? 1 : 0;
    }
  }
  float ts = 1.0f;
  if (a.df_mode != 0) {
    float chi2;
    if (a.chi2_in != nullptr) {
      chi2 = a.chi2_in[w];
    } else if (a.df_mode == 1) {
      chi2 = 0.0f;
      for (int m = 0; m < a.df_int; m += 2) {
        const uint4 wd = philox_at(row, kChi2Block | (m >> 1), off, k0, k1);
        const float n0 = normal_of(wd, m);
        chi2 = __fadd_rn(chi2, __fmul_rn(n0, n0));
        if (m + 1 < a.df_int) {
          const float n1 = normal_of(wd, m + 1);
          chi2 = __fadd_rn(chi2, __fmul_rn(n1, n1));
        }
      }
    } else {
      chi2 = a.df;
      bool got = false;
      for (int k = 0; k < a.candidates && !got; ++k) {
        const uint4 wd = philox_at(row, kChi2Block | k, off, k0, k1);
        const float xn = philox_normal(wd.x, wd.z);
        const float un = philox_uniform(wd.y);
        const float t = __fadd_rn(1.0f, __fmul_rn(a.mt_c, xn));
        const float v = __fmul_rn(__fmul_rn(t, t), t);
        const float vc = v < static_cast<float>(1e-30)
                              ? static_cast<float>(1e-30)
                              : v;
        const float rhs = __fadd_rn(
            __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, xn), xn), a.mt_d),
                      __fmul_rn(a.mt_d, v)),
            __fmul_rn(a.mt_d, logf(vc)));
        if (v > 0.0f && logf(un) < rhs) {
          chi2 = __fmul_rn(a.mt_2d, v);
          got = true;
        }
      }
      if (!got && a.exhausted != nullptr) atomicAdd(a.exhausted, 1ull);
    }
    ts = __fsqrt_rn(__fdiv_rn(a.df, chi2));
  }

  // q_t in z's place, from the last column down (column j reads z_0..z_j).
  const float* mc = mean + comp * nd;
  const float* Lc = L + comp * nn;
#pragma unroll
  for (int j = (kNd > 0 ? kNd : nd) - 1; j >= 0; --j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k <= j; ++k)
      acc = __fadd_rn(acc, __fmul_rn(z[k], Lc[j * nd + k]));
    if (K == 1) {
      z[j] = __fadd_rn(mc[j], a.df_mode != 0 ? __fmul_rn(acc, ts) : acc);
    } else {
      const float v = __fadd_rn(mc[j], acc);
      z[j] = a.df_mode != 0
                 ? __fadd_rn(mc[j], __fmul_rn(__fsub_rn(v, mc[j]), ts))
                 : v;
    }
  }

  // The factor.
  float f;
  const Global sg{s};
  if (K == 1) {
    const float ms = quad<kNd>(sg, mean, li, nd);
    const float mq = quad<kNd>(z, mean, li, nd);
    f = a.df_mode == 0
            ? __fmul_rn(0.5f, __fsub_rn(mq, ms))
            : __fmul_rn(a.fac_t, __fsub_rn(log1pf(__fdiv_rn(ms, a.df)),
                                           log1pf(__fdiv_rn(mq, a.df))));
  } else {
    f = __fsub_rn(
        logq<kNd>(sg, mean, li, logw, logdet, K, nd, a.df_mode, a.df,
                  a.fac_mix),
        logq<kNd>(z, mean, li, logw, logdet, K, nd, a.df_mode, a.df,
                  a.fac_mix));
  }
  a.factor[w] = use_t ? f : 0.0f;

  if (use_t) {
    if constexpr (kNd > 0) {
#pragma unroll
      for (int j = 0; j < kNd; ++j) q[j] = z[j];
    }
    return;
  }
  // The DE step s + gamma (c[j] - c[i]).
  int pi, pj;
  if (a.i_in != nullptr) {
    pi = a.i_in[w];
  } else {
    pi = static_cast<int>(
        __fmul_rn(philox_uniform(u.y), static_cast<float>(nc)));
    pi = min(pi, nc - 1);
  }
  if (a.j_in != nullptr) {
    pj = a.j_in[w];
  } else {
    pj = static_cast<int>(
        __fmul_rn(philox_uniform(u.z), static_cast<float>(nc - 1)));
    pj = min(pj, nc - 2);
  }
  pj = pj >= pi ? pj + 1 : pj;
  const float gamma =
      __fmul_rn(a.gamma0, __fadd_rn(1.0f, __fmul_rn(a.sigma, zg)));
  const float* ci = x + static_cast<int64_t>(pi >= row0 ? pi + a.ng : pi) * nd;
  const float* cj = x + static_cast<int64_t>(pj >= row0 ? pj + a.ng : pj) * nd;
  for (int j = 0; j < nd; ++j)
    q[j] = __fadd_rn(s[j], __fmul_rn(gamma, __fsub_rn(cj[j], ci[j])));
}

template <int kNd>
int launch_propose(const DimeProposeArgs& a, cudaStream_t stream) {
  const dim3 grid((a.ng + a.threads - 1) / a.threads, a.ntemps);
  if (a.ntemps > 1)
    dime_propose_kernel<kNd, true><<<grid, a.threads, 0, stream>>>(a);
  else
    dime_propose_kernel<kNd, false><<<grid, a.threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/dime_kernel.py): the
// arguments by pointer to a host struct; x (ntemps, nw, nd) the rows,
// table (ntemps, K (nd + 2 nd^2 + 3)) K8b's, q (ntemps, ng, nd) and factor
// (ntemps, ng) out; keys null for one key (seed), else rung r's key
// keys[r].  Returns cudaGetLastError() after the launch.
extern "C" int emcee_dime_propose(const DimeProposeArgs* args, void* stream) {
  const DimeProposeArgs a = *args;
  if (a.threads < 32 || a.threads > 256 || a.ng < 1 || a.nd < 1 || a.K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (a.nd) {
#define EMCEE_DIME_ND(N) \
  case N:                \
    return launch_propose<N>(a, st);
    EMCEE_DIME_ND(1)
    EMCEE_DIME_ND(2)
    EMCEE_DIME_ND(3)
    EMCEE_DIME_ND(4)
    EMCEE_DIME_ND(5)
    EMCEE_DIME_ND(6)
    EMCEE_DIME_ND(7)
    EMCEE_DIME_ND(8)
#undef EMCEE_DIME_ND
    default:
      return launch_propose<0>(a, st);
  }
}

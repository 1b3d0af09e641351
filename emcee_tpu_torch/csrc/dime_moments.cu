// K8a and K8b: DIME's moments, their pooling with the decayed history, the
// t-shape's Cholesky factor, its inverse and the mixture's weights.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/dime.py:38-47 and
// :133-276 (_centered_moments, _pooled, _t_shape_chol, _assign_means,
// _masked_moments, _pooled_k, _mixture_quantities) and the moments of
// update_carry (:433-468).  The JAX package has no Pallas kernel here;
// the port ran it as plain torch with cuBLAS products (xc^T xc) and a
// cuSOLVER factor.  The plain versions are ops/dime_kernel.py
// dime_moments_plain and dime_finish_plain; both kernels equal them bit
// for bit (every sum from +0.0 in a fixed order, every operation rounded
// once by the _rn intrinsics, logf / expf / sqrt as torch's).
//
// K8a, dime_moments_kernel: the rows of a set are the buffer's rows
// outside [skip_lo, skip_lo + skip_n) (a split's complement, read in
// place) or all of them (update_carry).  Block b of rung r takes set rows
// [b R, min((b + 1) R, n)) and writes, per component k, the partial
//   count_k, mean_k = x_f + (sum over members in row order of x - x_f) /
//     count_k, x_f the block's first member (0 for none; the summands
//     stay of the spread's size where |mean| >> the spread),
//   M2_k[a][b] = sum over members in row order of (x_a - m_a)(x_b - m_b)
// (1 + nd + nd^2 floats).  With K > 1 a row's component is its nearest
// assignment mean by |x - mu|^2 summed in column order (the first of
// equals); the means are the carry's, or at the cold start (sum_k w_k == 0)
// the set's rows (k * max(1, n / K)) % n.  The run's rows are read from
// global memory by every thread of an entry (L1 keeps them); only the
// assignment lives in shared memory, so any ndim fits.
//
// K8b, dime_finish_kernel: one block a rung.  A pairwise tree merges the
// partials in place (level s: node p takes node p + s, p = 0, 2s, ...) by
// Chan's combine
//   n = na + nb, d = mb - ma, mean = ma + d (nb / n),
//   M2 = (M2a + M2b) + ((na nb) / n) (d_a d_b)
// (node a kept where nb == 0, node b copied where na == 0).  Node 0 then
// pools with the carry (wh = rho w, total = wh + n, safe = max(total,
// 1e-12)): mean = mh + d (n / safe), cov = (wh ch + n cb) / safe + ((wh n)
// / safe^2) (d_a d_b) with cb = M2 / max(n, 1).  In update mode the block
// writes mean, cov and total into the carry.  Otherwise it writes rung r's
// table for K8c (ops/dime_kernel.py unpack_table): the pooled means; the
// factor of S = cov * scale + eps I (eps = 1e-6 tr / nd + 1e-12) column by
// column, every entry NaN where a pivot is not > 0 (cholesky_ex with
// info != 0); its inverse row by row (X_ij = (I_ij - sum_{k<i} L_ik X_kj)
// / L_ii, a thread a column); sum log L_jj; and, over the components,
// logw_k = log(w_k + 1e-6 sum w + 1e-30) - log(sum of those) and the
// running sum of exp(logw).  The work sits in the partials' and the
// table's global memory (L1 and L2 hold it), so any ndim fits.
//
// K8b's walk mode (emcee_tpu/moves/walk.py:29-33 and :73-79, the walk
// move's shared covariance and its Cholesky factor): K = 1, the set a
// split's complement (K8a as it is).  After the tree the block forms
// S = M2 / (n - 1) (ddof 1, a division by the count) and writes rung r's
// factor L (nd x nd) column by column, every entry NaN where a pivot is
// not > 0, the upper triangle 0; no pooling, t-shape or weights.  The
// tree merges 128-row runs by Chan's combine where the JAX package's _cov
// takes two passes over all rows: the same covariance to float32 rounding.
//
// What bounds them on an H100: bytes, the rows once (1 MB of a split's
// complement at 1e5 x 5).  K8a's blocks each run a serial chain of R rows
// for each entry; K8b is one block of log2(blocks) tree levels and an nd-step
// factor, a few microseconds.
//
// The rung axis (emcee_tpu/parallel/tempering.py:449-541 vmaps DIME over
// the ladder): kRungs takes rung blockIdx.y (K8a) or blockIdx.x (K8b),
// its rows, carry, partials and table lying one rung after the other.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// The longest run a K8a block takes (ops/dime_kernel.py DIME_ROWS_MAX),
// and the most runs a block (DIME_GROUP_MAX).
constexpr int kRowsMax = 1024;
constexpr int kGroupMax = 8;
// The dynamic shared memory a block may take (ops/dime_kernel.py
// DIME_SMEM_MAX; above 48 KB by the kernel's opt-in).
constexpr size_t kSharedMax = 160 * 1024;

// K8b's modes (ops/dime_kernel.py FINISH_MODES).
constexpr int kTable = 0, kUpdate = 1, kWalk = 2;

__device__ __forceinline__ int set_row(int i, int skip_lo, int skip_n) {
  return i >= skip_lo ? i + skip_n : i;
}

// The lower Cholesky factor of the nd x nd matrix in L, in place, column
// by column (pivot j by thread 0, then the column below it a thread a
// row), every entry NaN where a pivot is not > 0, else the upper triangle
// 0 (cholesky_ex with info != 0; ops/dime_kernel.py chol_columns_plain).
// Every thread of the block calls it with L written and synchronized; it
// ends synchronized.
__device__ void factor_columns(float* L, int nd, int* fail) {
  const int tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) *fail = 0;
  __syncthreads();
  for (int j = 0; j < nd; ++j) {
    if (tid == 0) {
      float s = L[j * nd + j];
      for (int k2 = 0; k2 < j; ++k2)
        s = __fsub_rn(s, __fmul_rn(L[j * nd + k2], L[j * nd + k2]));
      if (!(s > 0.0f)) *fail = 1;
      L[j * nd + j] = __fsqrt_rn(s);
    }
    __syncthreads();
    const float ljj = L[j * nd + j];
    for (int i = j + 1 + tid; i < nd; i += bd) {
      float t = L[i * nd + j];
      for (int k2 = 0; k2 < j; ++k2)
        t = __fsub_rn(t, __fmul_rn(L[i * nd + k2], L[j * nd + k2]));
      L[i * nd + j] = __fdiv_rn(t, ljj);
    }
    __syncthreads();
  }
  const bool failed = *fail != 0;
  for (int e = tid; e < nd * nd; e += bd) {
    const int a = e / nd, b = e - a * nd;
    if (failed)
      L[e] = NAN;
    else if (b > a)
      L[e] = 0.0f;
  }
  __syncthreads();
}

// One level of the pairwise tree over `count` nodes of K partials each, in
// place at P: node p takes node p + s for p = 0, 2s, 4s, ... (those with a
// partner), by Chan's combine; node p is kept where p + s is empty and
// takes it whole where p is.  The block's threads share the work; every
// thread of the block calls it, and it ends synchronized.
__device__ __forceinline__ void tree_level(float* P, int count, int s, int K,
                                           int nd) {
  const int node = 1 + nd + nd * nd;
  const int nn = nd * nd;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int pairs = (count - s + 2 * s - 1) / (2 * s);
  // The cross-products first: they read both means before these change.
  for (int e = tid; e < pairs * K * nn; e += bd) {
    const int pk = e / nn, ab = e - pk * nn;
    const int pi = pk / K, k = pk - pi * K;
    const int a = ab / nd, b = ab - a * nd;
    float* A = P + (static_cast<int64_t>(pi) * 2 * s * K + k) * node;
    const float* B = A + static_cast<int64_t>(s) * K * node;
    const float na = A[0], nbb = B[0];
    if (nbb == 0.0f) continue;
    if (na == 0.0f) {
      A[1 + nd + ab] = B[1 + nd + ab];
      continue;
    }
    const float n = __fadd_rn(na, nbb);
    const float coef = __fdiv_rn(__fmul_rn(na, nbb), n);
    const float da = __fsub_rn(B[1 + a], A[1 + a]);
    const float db = __fsub_rn(B[1 + b], A[1 + b]);
    A[1 + nd + ab] = __fadd_rn(__fadd_rn(A[1 + nd + ab], B[1 + nd + ab]),
                               __fmul_rn(coef, __fmul_rn(da, db)));
  }
  __syncthreads();
  for (int e = tid; e < pairs * K; e += bd) {
    const int pi = e / K, k = e - pi * K;
    float* A = P + (static_cast<int64_t>(pi) * 2 * s * K + k) * node;
    const float* B = A + static_cast<int64_t>(s) * K * node;
    const float na = A[0], nbb = B[0];
    if (nbb == 0.0f) continue;
    if (na == 0.0f) {
      for (int a = 0; a < nd; ++a) A[1 + a] = B[1 + a];
      A[0] = nbb;
      continue;
    }
    const float n = __fadd_rn(na, nbb);
    const float f = __fdiv_rn(nbb, n);
    for (int a = 0; a < nd; ++a)
      A[1 + a] =
          __fadd_rn(A[1 + a], __fmul_rn(__fsub_rn(B[1 + a], A[1 + a]), f));
    A[0] = n;
  }
  __syncthreads();
}

// A block takes `group` runs of `rows` set rows (a span of group * rows),
// writes each run's partial (shared memory where group > 1, else straight
// to its place in `part`), and merges its runs by the tree's first
// log2(group) levels: the runs are the global tree's leaves in aligned
// groups, so the block's partial is the node the global tree has there.
// Dynamic shared memory: [kStaged: the span's rows] [group > 1: the runs'
// partials] [the span's assignment]; run l's rows start l rows, and its
// assignment l words, after their unpadded place, so the threads of a warp
// that read row i of different runs read different banks.
template <bool kRungs, bool kStaged>
__global__ void __launch_bounds__(256) dime_moments_kernel(
    const float* __restrict__ x, float* part,
    const float* __restrict__ mean, const float* __restrict__ w, int nw,
    int nd, int skip_lo, int skip_n, int K, int rows, int group, int nb) {
  extern __shared__ float sm[];
  const int rung = kRungs ? blockIdx.y : 0;
  const int n = nw - skip_n;
  const int node = 1 + nd + nd * nd;
  const int nn = nd * nd;
  const int span = rows * group;
  float* xs = sm;
  float* runs = sm + (kStaged ? (span + group) * nd : 0);
  int* assign = reinterpret_cast<int*>(runs + (group > 1 ? group * K * node
                                                         : 0));
  x += static_cast<int64_t>(rung) * nw * nd;
  part += (static_cast<int64_t>(rung) * nb + blockIdx.x) * K * node;
  float* lp = group > 1 ? runs : part;
  const int r0 = blockIdx.x * span;
  const int cnt = min(span, n - r0);
  const int nruns = (cnt + rows - 1) / rows;
  if constexpr (kStaged) {
    // Sixteen loads a thread in flight: a block's span is ~40 KB.
#pragma unroll 16
    for (int e = threadIdx.x; e < cnt * nd; e += blockDim.x) {
      const int i = e / nd;
      xs[e + i / rows * nd] =
          x[static_cast<int64_t>(set_row(r0 + i, skip_lo, skip_n)) * nd +
            (e - i * nd)];
    }
  }
  // Row i of the span, which lies in run l.
  auto row = [&](int l, int i) -> const float* {
    if constexpr (kStaged) {
      return xs + (i + l) * nd;
    } else {
      return x + static_cast<int64_t>(set_row(r0 + i, skip_lo, skip_n)) * nd;
    }
  };
  __syncthreads();

  if (K > 1) {
    mean += static_cast<int64_t>(rung) * K * nd;
    w += static_cast<int64_t>(rung) * K;
    float ws = 0.0f;
    for (int k = 0; k < K; ++k) ws = __fadd_rn(ws, w[k]);
    const bool cold = ws == 0.0f;
    const int stride = max(1, n / K);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const float* xi = row(i / rows, i);
      int best_k = 0;
      float best = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float* mu =
            cold ? x + static_cast<int64_t>(set_row(
                           static_cast<int>((static_cast<int64_t>(k) *
                                             stride) % n),
                           skip_lo, skip_n)) * nd
                 : mean + static_cast<int64_t>(k) * nd;
        float d2 = 0.0f;
        for (int j = 0; j < nd; ++j) {
          const float t = __fsub_rn(xi[j], mu[j]);
          d2 = __fadd_rn(d2, __fmul_rn(t, t));
        }
        if (k == 0 || d2 < best) {
          best = d2;
          best_k = k;
        }
      }
      assign[i + i / rows] = best_k;
    }
  } else {
    for (int i = threadIdx.x; i < cnt; i += blockDim.x)
      assign[i + i / rows] = 0;
  }
  __syncthreads();

  // Counts and means: a thread a (run, component, column).  Branch-free: a
  // row of another component adds +0.0, which leaves a sum from +0.0 as it
  // was, and the loop's loads can run ahead of its adds.
  for (int e = threadIdx.x; e < nruns * K * nd; e += blockDim.x) {
    const int rk = e / nd, j = e - rk * nd;
    const int l = rk / K, k = rk - l * K;
    const int end = min(cnt, (l + 1) * rows);
    float c = 0.0f, s = 0.0f, shift = 0.0f;
#pragma unroll 8
    for (int i = l * rows; i < end; ++i) {
      const bool in = assign[i + l] == k;
      const float v = row(l, i)[j];
      shift = in && c == 0.0f ? v : shift;
      c = __fadd_rn(c, in ? 1.0f : 0.0f);
      s = __fadd_rn(s, in ? __fsub_rn(v, shift) : 0.0f);
    }
    float* pk = lp + static_cast<int64_t>(rk) * node;
    if (j == 0) pk[0] = c;
    pk[1 + j] = c > 0.0f ? __fadd_rn(shift, __fdiv_rn(s, c)) : 0.0f;
  }
  __syncthreads();

  // Centered cross-products: a thread a (run, component, a, b).
  for (int e = threadIdx.x; e < nruns * K * nn; e += blockDim.x) {
    const int rk = e / nn, ab = e - rk * nn;
    const int l = rk / K;
    const int k = rk - l * K;
    const int a = ab / nd, b = ab - a * nd;
    const int end = min(cnt, (l + 1) * rows);
    float* pk = lp + static_cast<int64_t>(rk) * node;
    const float ma = pk[1 + a], mb = pk[1 + b];
    float m2 = 0.0f;
#pragma unroll 8
    for (int i = l * rows; i < end; ++i) {
      const float* xi = row(l, i);
      const float t = __fmul_rn(__fsub_rn(xi[a], ma), __fsub_rn(xi[b], mb));
      m2 = __fadd_rn(m2, assign[i + l] == k ? t : 0.0f);
    }
    pk[1 + nd + ab] = m2;
  }
  if (group > 1) {
    __syncthreads();
    for (int s = 1; s < nruns; s <<= 1) tree_level(lp, nruns, s, K, nd);
    for (int e = threadIdx.x; e < K * node; e += blockDim.x) part[e] = lp[e];
  }
}

// kShared: the partials, and the factor and its inverse while they are
// formed, live in shared memory (where they fit), else in the partials'
// and the table's global memory.
template <bool kRungs, bool kShared>
__global__ void __launch_bounds__(256) dime_finish_kernel(
    float* part_g, int nb, int nd, int K, float* cmean, float* ccov,
    float* cw, float* table, float rho, float scale, int mode) {
  extern __shared__ float sh[];  // K totals, a flag, [partials, L, X]
  float* total = sh;
  int* fail = reinterpret_cast<int*>(sh + K);
  const int rung = kRungs ? blockIdx.x : 0;
  const int node = 1 + nd + nd * nd;
  const int nn = nd * nd;
  const int tid = threadIdx.x, bd = blockDim.x;
  part_g += static_cast<int64_t>(rung) * nb * K * node;
  float* part = kShared ? sh + K + 1 : part_g;
  if constexpr (kShared) {
#pragma unroll 4
    for (int e = tid; e < nb * K * node; e += bd) part[e] = part_g[e];
    __syncthreads();
  }

  // The tree.
  for (int s = 1; s < nb; s <<= 1) tree_level(part, nb, s, K, nd);

  if (mode == kWalk) {
    // S = M2 / (n - 1) in L's place, then its factor into the table.
    float* out = table + static_cast<int64_t>(rung) * nn;
    float* L = kShared ? part + static_cast<int64_t>(nb) * node : out;
    const float nm1 = __fsub_rn(part[0], 1.0f);
    for (int e = tid; e < nn; e += bd) L[e] = __fdiv_rn(part[1 + nd + e], nm1);
    __syncthreads();
    factor_columns(L, nd, fail);
    if constexpr (kShared) {
      for (int e = tid; e < nn; e += bd) out[e] = L[e];
    }
    return;
  }
  cmean += static_cast<int64_t>(rung) * K * nd;
  ccov += static_cast<int64_t>(rung) * K * nn;
  cw += static_cast<int64_t>(rung) * K;

  // Pool node 0 with the carry: cov into the cross-products' place.
  for (int e = tid; e < K * nn; e += bd) {
    const int k = e / nn, ab = e - k * nn;
    const int a = ab / nd, b = ab - a * nd;
    float* P = part + static_cast<int64_t>(k) * node;
    const float n = P[0];
    const float wh = __fmul_rn(rho, cw[k]);
    const float tot = __fadd_rn(wh, n);
    const float safe = tot < 1e-12f ? static_cast<float>(1e-12) : tot;
    const float da = __fsub_rn(P[1 + a], cmean[k * nd + a]);
    const float db = __fsub_rn(P[1 + b], cmean[k * nd + b]);
    const float cb = __fdiv_rn(P[1 + nd + ab], n < 1.0f ? 1.0f : n);
    P[1 + nd + ab] = __fadd_rn(
        __fdiv_rn(__fadd_rn(__fmul_rn(wh, ccov[static_cast<int64_t>(k) * nn +
                                               ab]),
                            __fmul_rn(n, cb)),
                  safe),
        __fmul_rn(__fdiv_rn(__fmul_rn(wh, n), __fmul_rn(safe, safe)),
                  __fmul_rn(da, db)));
  }
  __syncthreads();
  for (int e = tid; e < K * nd; e += bd) {
    const int k = e / nd, a = e - k * nd;
    float* P = part + static_cast<int64_t>(k) * node;
    const float n = P[0];
    const float tot = __fadd_rn(__fmul_rn(rho, cw[k]), n);
    const float safe = tot < 1e-12f ? static_cast<float>(1e-12) : tot;
    const float mh = cmean[k * nd + a];
    P[1 + a] = __fadd_rn(mh, __fmul_rn(__fsub_rn(P[1 + a], mh),
                                       __fdiv_rn(n, safe)));
  }
  for (int k = tid; k < K; k += bd)
    total[k] = __fadd_rn(__fmul_rn(rho, cw[k]), part[k * node]);
  __syncthreads();

  if (mode == kUpdate) {
    for (int e = tid; e < K * nn; e += bd) {
      const int k = e / nn, ab = e - k * nn;
      ccov[e] = part[static_cast<int64_t>(k) * node + 1 + nd + ab];
    }
    for (int e = tid; e < K * nd; e += bd) {
      const int k = e / nd, a = e - k * nd;
      cmean[e] = part[static_cast<int64_t>(k) * node + 1 + a];
    }
    for (int k = tid; k < K; k += bd) cw[k] = total[k];
    return;
  }

  const int64_t tab = static_cast<int64_t>(K) * (nd + 2 * nn + 3);
  table += static_cast<int64_t>(rung) * tab;
  float* tmean = table;
  float* tl = table + K * nd;
  float* ti = tl + static_cast<int64_t>(K) * nn;
  float* tlogw = ti + static_cast<int64_t>(K) * nn;
  float* tlogdet = tlogw + K;
  float* tcdf = tlogdet + K;
  for (int e = tid; e < K * nd; e += bd) {
    const int k = e / nd, a = e - k * nd;
    tmean[e] = part[static_cast<int64_t>(k) * node + 1 + a];
  }
  for (int k = 0; k < K; ++k) {
    const float* C = part + static_cast<int64_t>(k) * node + 1 + nd;
    float* L = kShared ? part + static_cast<int64_t>(nb) * K * node
                       : tl + static_cast<int64_t>(k) * nn;
    float* X = kShared ? L + nn : ti + static_cast<int64_t>(k) * nn;
    float tr = 0.0f;
    for (int j = 0; j < nd; ++j) tr = __fadd_rn(tr, C[j * nd + j]);
    const float eps = __fadd_rn(
        __fmul_rn(static_cast<float>(1e-6),
                  __fdiv_rn(tr, static_cast<float>(nd))),
        static_cast<float>(1e-12));
    // S in L's place.
    for (int e = tid; e < nn; e += bd) {
      const int a = e / nd, b = e - a * nd;
      L[e] = __fadd_rn(__fmul_rn(C[e], scale),
                       __fmul_rn(eps, a == b ? 1.0f : 0.0f));
    }
    __syncthreads();
    factor_columns(L, nd, fail);
    // The inverse, a thread a column.
    for (int j = tid; j < nd; j += bd) {
      for (int i = 0; i < nd; ++i) {
        float t = 0.0f;
        for (int k2 = 0; k2 < i; ++k2)
          t = __fadd_rn(t, __fmul_rn(L[i * nd + k2], X[k2 * nd + j]));
        X[i * nd + j] =
            __fdiv_rn(__fsub_rn(i == j ? 1.0f : 0.0f, t), L[i * nd + i]);
      }
    }
    if (tid == 0) {
      float ld = 0.0f;
      for (int j = 0; j < nd; ++j) ld = __fadd_rn(ld, logf(L[j * nd + j]));
      tlogdet[k] = ld;
    }
    __syncthreads();
    if constexpr (kShared) {
      for (int e = tid; e < nn; e += bd) {
        tl[static_cast<int64_t>(k) * nn + e] = L[e];
        ti[static_cast<int64_t>(k) * nn + e] = X[e];
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    float sw = 0.0f;
    for (int k = 0; k < K; ++k) sw = __fadd_rn(sw, total[k]);
    const float floor1 = __fmul_rn(static_cast<float>(1e-6), sw);
    float swf = 0.0f;
    for (int k = 0; k < K; ++k)
      swf = __fadd_rn(swf, __fadd_rn(__fadd_rn(total[k], floor1),
                                     static_cast<float>(1e-30)));
    const float lswf = logf(swf);
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wf = __fadd_rn(__fadd_rn(total[k], floor1),
                                 static_cast<float>(1e-30));
      const float lw = __fsub_rn(logf(wf), lswf);
      tlogw[k] = lw;
      acc = __fadd_rn(acc, expf(lw));
      tcdf[k] = acc;
    }
  }
}

template <bool kRungs, bool kStaged>
int launch_moments(const float* x, float* part, const float* mean,
                   const float* w, int nw, int nd, int skip_lo, int skip_n,
                   int K, int rows, int group, int nb, int ntemps,
                   int threads, size_t smem, cudaStream_t st) {
  auto kernel = dime_moments_kernel<kRungs, kStaged>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(nb, ntemps), threads, smem, st>>>(
      x, part, mean, w, nw, nd, skip_lo, skip_n, K, rows, group, nb);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRungs, bool kShared>
int launch_finish(float* part, int nb, int nd, int K, float* mean,
                  float* cov, float* w, float* table, float rho, float scale,
                  int mode, int ntemps, int threads, size_t smem,
                  cudaStream_t st) {
  auto kernel = dime_finish_kernel<kRungs, kShared>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<ntemps, threads, smem, st>>>(part, nb, nd, K, mean, cov, w, table,
                                        rho, scale, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/dime_kernel.py).  Every
// pointer is a device pointer.  emcee_dime_moments: x (ntemps, nw, nd)
// rows, part (ntemps, nb, K, 1 + nd + nd^2) out, mean (ntemps, K, nd) and w
// (ntemps, K) the carry's (read for K > 1, else null); set rows skip
// [skip_lo, skip_lo + skip_n); rows a run (<= 1024), group runs a block
// (a power of two <= 8), nb = ceil(n / (rows group)) blocks a rung,
// threads a block; staged: the span's rows in shared memory (the dynamic
// shared memory, at most kSharedMax bytes: ops/dime_kernel.py
// moments_smem).
// emcee_dime_finish: part as written by emcee_dime_moments (overwritten),
// the carry mean (ntemps, K, nd), cov (ntemps, K, nd, nd) and w (ntemps,
// K), table (ntemps, K (nd + 2 nd^2 + 3)) out (null in update mode, which
// writes the carry); mode 0 the table, 1 the carry update, 2 the walk
// move's factor (K = 1; table (ntemps, nd, nd) out, the carry pointers
// null and unread); rho and the t-shape's scale; one block of threads a
// rung; shared: the partials and the factor's scratch in shared memory
// (K + 1 + nb K (1 + nd + nd^2) + 2 nd^2 floats, at most kSharedMax
// bytes).  Each returns the first CUDA error (the shared-memory attribute,
// else cudaGetLastError() after its launch).
extern "C" int emcee_dime_moments(const float* x, float* part,
                                  const float* mean, const float* w, int nw,
                                  int nd, int skip_lo, int skip_n, int K,
                                  int rows, int group, int nb, int ntemps,
                                  int threads, int staged, void* stream) {
  const size_t span = static_cast<size_t>(rows) * group;
  const size_t node = 1 + static_cast<size_t>(nd) + static_cast<size_t>(nd) * nd;
  const size_t smem =
      sizeof(float) * ((staged ? (span + group) * nd : 0) +
                       (group > 1 ? group * static_cast<size_t>(K) * node : 0)) +
      sizeof(int) * (span + group);
  if (rows < 1 || rows > kRowsMax || group < 1 || group > kGroupMax ||
      (group & (group - 1)) || threads < 32 || threads > 256 ||
      smem > kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ntemps > 1)
    return staged ? launch_moments<true, true>(x, part, mean, w, nw, nd,
                                               skip_lo, skip_n, K, rows, group,
                                               nb, ntemps, threads, smem, st)
                  : launch_moments<true, false>(x, part, mean, w, nw, nd,
                                                skip_lo, skip_n, K, rows,
                                                group, nb, ntemps, threads,
                                                smem, st);
  return staged ? launch_moments<false, true>(x, part, mean, w, nw, nd,
                                              skip_lo, skip_n, K, rows, group,
                                              nb, ntemps, threads, smem, st)
                : launch_moments<false, false>(x, part, mean, w, nw, nd,
                                               skip_lo, skip_n, K, rows, group,
                                               nb, ntemps, threads, smem, st);
}

extern "C" int emcee_dime_finish(float* part, int nb, int nd, int K,
                                 float* mean, float* cov, float* w,
                                 float* table, float rho, float scale,
                                 int mode, int ntemps, int threads,
                                 int shared, void* stream) {
  const size_t nn = static_cast<size_t>(nd) * nd;
  const size_t smem =
      sizeof(float) * (K + 1) +
      (shared ? sizeof(float) * (static_cast<size_t>(nb) * K * (1 + nd + nn) +
                                 2 * nn)
              : 0);
  if (threads < 32 || threads > 256 || smem > kSharedMax || mode < kTable ||
      mode > kWalk || (mode == kWalk && K != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ntemps > 1)
    return shared ? launch_finish<true, true>(part, nb, nd, K, mean, cov, w,
                                              table, rho, scale, mode,
                                              ntemps, threads, smem, st)
                  : launch_finish<true, false>(part, nb, nd, K, mean, cov, w,
                                               table, rho, scale, mode,
                                               ntemps, threads, smem, st);
  return shared ? launch_finish<false, true>(part, nb, nd, K, mean, cov, w,
                                             table, rho, scale, mode,
                                             ntemps, threads, smem, st)
                : launch_finish<false, false>(part, nb, nd, K, mean, cov, w,
                                              table, rho, scale, mode,
                                              ntemps, threads, smem, st);
}

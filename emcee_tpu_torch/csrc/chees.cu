// K21a and K21b: ChEES-HMC's start and its tuning gradient, for one
// ensemble or for every rung of a ladder at once.
//
// Replace XLA-fused chains of emcee_tpu/moves/gradient.py's
// ChEESHMCMove.propose, vmapped over a ladder's rungs by
// emcee_tpu/parallel/tempering.py:538.  There is no Pallas kernel behind
// either.  The port ran both as plain torch: the start as ~30 launches on
// 0-d tensors, the gradient as ~25 launches and several passes over the
// rows.  The plain versions are ops/chees_kernel.py chees_start_plain and
// chees_gradient_plain; the kernels equal them bit for bit (every operation
// rounded once by the _rn intrinsics, expf as torch's on the card, the sums
// in the order below, divisions by the row count as a float).
//
// chees_start_kernel (K21a, gradient.py:468-483 and _van_der_corput,
// :348-359): one block, a thread a rung r (rungs beyond the block's
// threads in turns), from the rung's carry log_adj[r], log_T[r], n[r]:
//   eps[r]  = step exp(log_adj[r])
//   u[r]    = bitreverse32(n[r]) 2^-32        (the base-2 van der Corput value)
//   T[r]    = exp(log_T[r])
//   more[r] = clamp(ceil(u T / eps), 1, max_leapfrog) - 1
// (clamped in float, NaN kept, before the int64 cast, as the JAX package
// clips before its int cast), then top = max over r of more[r] and
// trip = 0: the host reads top once a proposal and replays that many
// trips; K13's masked rung mode steps rung r only while trip < more[r].
//
// chees_gradient_kernel (K21b, gradient.py:514-548): the acceptance-
// weighted ChEES gradient with respect to log T of every rung,
//   qbar, xbar      the walker means of q and x (columns)
//   delta_i         sum_j (q_ij - qbar_j)^2 - sum_j (x_ij - xbar_j)^2
//   ddelta_i        (2 u) sum_j (q_ij - qbar_j) (L p_i)_j
//   alpha_i         exp(min(lnpdiff_i, 0)), 0 where not finite,
//                   lnpdiff_i = (lp_q_i - lp_i) + kinetic_i
//   num, den        means of alpha_i (0.5 delta_i) ddelta_i and of alpha_i
//   g               (T num) / (den + 1e-12), 0 where not finite
// with (L p)_j = p_j, p_j d_j, or sum_{k <= j} L[j][k] p_k from +0.0 in
// column order (as K18a forms z L^T), and every row sum from +0.0 in
// column order.  A rung's rows are cut into blocks of `rows` rows (a
// multiple of kThreads); in a block, thread t sums rows t, t + kThreads,
// ... from +0.0, then the block's kThreads partials meet in a fixed tree
// (at level s, partial t += partial t + s); the blocks' sums are added in
// block order from +0.0.  One block a rung (blocks == 1, the ladder) runs
// both passes in one launch (mode 0).  More blocks take two launches:
// mode 1 writes each block's column sums and the rung's last block (a
// done-counter) the means; mode 2 the gradient's partials and the last
// block g.  The done-counters are left at 0 for the next launch.
//
// What bounds them on an H100: K21a, the launch (a few words a rung).
// K21b, bytes: x, q and p read once and lp, lp_q and the kinetic factor
// (7.2 MB at 1e5 x 5, ~2.1 us at 3.35 TB/s); the means need a first pass
// over q and x before the second can start, so at 1e5 the rows are read
// twice by two launches, each a wave of 98 blocks a rung.
#include <cuda_runtime.h>

#include <cstdint>

// The arguments of the gradient's entry point (ops/chees_kernel.py
// _GradArgs, field for field).  Declared outside the anonymous namespace:
// the C entry point takes it.
struct CheesGradArgs {
  const float* x;        // (ntemps, n, nd): the ensemble before the accept
  const float* q;        // (ntemps, n, nd): the proposal
  const float* p;        // (ntemps, n, nd): the end point's momentum
  const float* lp;       // (ntemps, n)
  const float* lp_q;     // (ntemps, n)
  const float* kinetic;  // (ntemps, n)
  const float* u;        // (ntemps,)
  const float* traj;     // (ntemps,): T
  const float* d;        // (nd,): the diagonal metric, or null
  const float* L;        // (nd, nd): the full metric's factor, or null
  float* g;              // (ntemps,): out
  float* part;           // (ntemps, blocks, 2 nd): mode 1's column sums
  float* means;          // (ntemps, 2 nd): q's means, then x's
  float* gpart;          // (ntemps, blocks, 2): mode 2's sums
  unsigned int* done;    // (2 ntemps,): modes 1 and 2, zero between launches
  int n, nd, ntemps, rows, blocks;
};

namespace {

constexpr int kThreads = 256;
// Columns of q and of x a thread sums at once in the first pass.
constexpr int kGroup = 8;
constexpr int kStartThreads = 128;

__global__ void __launch_bounds__(kStartThreads) chees_start_kernel(
    const float* __restrict__ log_adj, const float* __restrict__ log_T,
    const int* __restrict__ count, float step, float max_leapfrog,
    int ntemps, float* __restrict__ eps, float* __restrict__ u,
    float* __restrict__ traj, long long* __restrict__ more,
    long long* __restrict__ top, long long* __restrict__ trip) {
  __shared__ long long best[kStartThreads];
  long long m = -0x7fffffffffffffffLL - 1;  // no rung of this thread
  for (int r = threadIdx.x; r < ntemps; r += kStartThreads) {
    const float e = __fmul_rn(step, expf(log_adj[r]));
    const unsigned int rev = __brev(static_cast<unsigned int>(count[r]));
    const float uu = __fmul_rn(__uint2float_rn(rev), 0x1p-32f);
    const float t = expf(log_T[r]);
    float c = ceilf(__fdiv_rn(__fmul_rn(uu, t), e));
    if (!isnan(c)) c = fminf(fmaxf(c, 1.0f), max_leapfrog);
    const long long s = static_cast<long long>(c) - 1;
    eps[r] = e;
    u[r] = uu;
    traj[r] = t;
    more[r] = s;
    if (s > m) m = s;
  }
  best[threadIdx.x] = m;
  for (int s = kStartThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s && best[threadIdx.x + s] > best[threadIdx.x])
      best[threadIdx.x] = best[threadIdx.x + s];
  }
  if (threadIdx.x == 0) {
    *top = best[0];
    *trip = 0;
  }
}

// The block's fixed tree over sm[c][0 .. kThreads) for c < cols: the sums
// land in sm[c][0], visible to every thread on return.
__device__ __forceinline__ void tree(float (*sm)[kThreads], int cols) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) {
      for (int c = 0; c < cols; ++c)
        sm[c][threadIdx.x] =
            __fadd_rn(sm[c][threadIdx.x], sm[c][threadIdx.x + s]);
    }
  }
  __syncthreads();
}

// Whether this block is the last of `blocks` to pass its done-counter
// (each block's writes before the call are visible to the last one).
__device__ __forceinline__ bool last_block(unsigned int* done, int blocks) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(done, 1u) == static_cast<unsigned int>(blocks - 1);
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) chees_gradient_kernel(
    CheesGradArgs a) {
  __shared__ float sm[2 * kGroup][kThreads];
  extern __shared__ float mean[];  // 2 nd: q's means, then x's
  const int rung = blockIdx.y, b = blockIdx.x, t = threadIdx.x, nd = a.nd;
  const long long base = static_cast<long long>(rung) * a.n * nd;
  const int row0 = b * a.rows;
  const int row1 = min(row0 + a.rows, a.n);
  const float nf = static_cast<float>(a.n);
  if (kMode != 2) {
    // The first pass: the block's column sums of q and x.
    for (int c0 = 0; c0 < nd; c0 += kGroup) {
      const int cols = min(kGroup, nd - c0);
      float sq[kGroup], sx[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) sq[k] = sx[k] = 0.0f;
      for (int i = row0 + t; i < row1; i += kThreads) {
        const float* qr = a.q + base + static_cast<long long>(i) * nd + c0;
        const float* xr = a.x + base + static_cast<long long>(i) * nd + c0;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (k < cols) {
            sq[k] = __fadd_rn(sq[k], qr[k]);
            sx[k] = __fadd_rn(sx[k], xr[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        sm[k][t] = sq[k];
        sm[kGroup + k][t] = sx[k];
      }
      tree(sm, 2 * kGroup);
      if (t < cols) {
        if (kMode == 0) {
          mean[c0 + t] = __fdiv_rn(__fadd_rn(0.0f, sm[t][0]), nf);
          mean[nd + c0 + t] = __fdiv_rn(__fadd_rn(0.0f, sm[kGroup + t][0]), nf);
        } else {
          float* part = a.part + (static_cast<long long>(rung) * a.blocks + b)
                                     * 2 * nd;
          part[c0 + t] = sm[t][0];
          part[nd + c0 + t] = sm[kGroup + t][0];
        }
      }
      __syncthreads();
    }
    if (kMode == 1) {
      if (!last_block(a.done + rung, a.blocks)) return;
      const float* part = a.part + static_cast<long long>(rung) * a.blocks
                                       * 2 * nd;
      for (int c = t; c < 2 * nd; c += kThreads) {
        float s = 0.0f;
        for (int k = 0; k < a.blocks; ++k)
          s = __fadd_rn(s, __ldcg(part + static_cast<long long>(k) * 2 * nd
                                  + c));
        a.means[static_cast<long long>(rung) * 2 * nd + c] = __fdiv_rn(s, nf);
      }
      if (t == 0) a.done[rung] = 0;
      return;
    }
  } else {
    for (int c = t; c < 2 * nd; c += kThreads)
      mean[c] = __ldcg(a.means + static_cast<long long>(rung) * 2 * nd + c);
    __syncthreads();
  }
  // The second pass: the per-walker terms and their sums.
  const float u2 = __fmul_rn(2.0f, a.u[rung]);
  float sn = 0.0f, sd = 0.0f;
  for (int i = row0 + t; i < row1; i += kThreads) {
    const long long at = base + static_cast<long long>(i) * nd;
    const float* qr = a.q + at;
    const float* xr = a.x + at;
    const float* pr = a.p + at;
    float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int j = 0; j < nd; ++j) {
      const float dq = __fsub_rn(qr[j], mean[j]);
      const float dx = __fsub_rn(xr[j], mean[nd + j]);
      float lpj;
      if (a.L != nullptr) {
        lpj = 0.0f;
        for (int k = 0; k <= j; ++k)
          lpj = __fadd_rn(lpj, __fmul_rn(pr[k], a.L[j * nd + k]));
      } else {
        lpj = a.d != nullptr ? __fmul_rn(pr[j], a.d[j]) : pr[j];
      }
      s1 = __fadd_rn(s1, __fmul_rn(dq, dq));
      s2 = __fadd_rn(s2, __fmul_rn(dx, dx));
      s3 = __fadd_rn(s3, __fmul_rn(dq, lpj));
    }
    const float pw =
        __fmul_rn(__fmul_rn(0.5f, __fsub_rn(s1, s2)), __fmul_rn(u2, s3));
    const long long w = static_cast<long long>(rung) * a.n + i;
    float l = __fadd_rn(__fsub_rn(a.lp_q[w], a.lp[w]), a.kinetic[w]);
    l = l > 0.0f ? 0.0f : l;  // NaN stays NaN, as torch.clamp keeps it
    float alpha = expf(l);
    if (!isfinite(alpha)) alpha = 0.0f;
    sn = __fadd_rn(sn, __fmul_rn(alpha, pw));
    sd = __fadd_rn(sd, alpha);
  }
  sm[0][t] = sn;
  sm[1][t] = sd;
  tree(sm, 2);
  float num, den;
  if (kMode == 0) {
    if (t != 0) return;
    num = __fadd_rn(0.0f, sm[0][0]);
    den = __fadd_rn(0.0f, sm[1][0]);
  } else {
    float* gp = a.gpart + (static_cast<long long>(rung) * a.blocks + b) * 2;
    if (t == 0) {
      gp[0] = sm[0][0];
      gp[1] = sm[1][0];
    }
    if (!last_block(a.done + a.ntemps + rung, a.blocks)) return;
    if (t != 0) return;
    const float* all = a.gpart + static_cast<long long>(rung) * a.blocks * 2;
    num = den = 0.0f;
    for (int k = 0; k < a.blocks; ++k) {
      num = __fadd_rn(num, __ldcg(all + 2 * k));
      den = __fadd_rn(den, __ldcg(all + 2 * k + 1));
    }
    a.done[a.ntemps + rung] = 0;
  }
  num = __fdiv_rn(num, nf);
  den = __fdiv_rn(den, nf);
  const float gg = __fdiv_rn(__fmul_rn(a.traj[rung], num),
                             __fadd_rn(den, 1e-12f));
  a.g[rung] = isfinite(gg) ? gg : 0.0f;
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/chees_kernel.py).  Every
// pointer is a device pointer.  Each returns cudaGetLastError() after its
// launches.
//
// K21a: ntemps rungs' carries (log_adj, log_T float32; n int32) into eps,
// u, T (float32), more (int64) and the words top and trip (int64).
extern "C" int emcee_chees_start(const float* log_adj, const float* log_T,
                                 const int* count, float step,
                                 float max_leapfrog, int ntemps, float* eps,
                                 float* u, float* traj, long long* more,
                                 long long* top, long long* trip,
                                 void* stream) {
  chees_start_kernel<<<1, kStartThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      log_adj, log_T, count, step, max_leapfrog, ntemps, eps, u, traj, more,
      top, trip);
  return static_cast<int>(cudaGetLastError());
}

// K21b: one launch (blocks == 1) or two (the column sums, then the
// gradient), a grid of (blocks, ntemps) blocks of kThreads with 2 nd floats
// of dynamic shared memory.
extern "C" int emcee_chees_gradient(const CheesGradArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a->blocks, a->ntemps);
  const size_t smem = sizeof(float) * 2 * a->nd;
  if (a->blocks == 1) {
    chees_gradient_kernel<0><<<grid, kThreads, smem, s>>>(*a);
  } else {
    chees_gradient_kernel<1><<<grid, kThreads, smem, s>>>(*a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    chees_gradient_kernel<2><<<grid, kThreads, smem, s>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

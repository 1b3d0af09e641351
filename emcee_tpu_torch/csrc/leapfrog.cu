// K13: the leapfrog step of the gradient moves.
//
// Replaces the XLA-fused velocity-Verlet updates of
// emcee_tpu/moves/gradient.py:314-324 (HMCMove's scan body), :488-495
// (ChEESHMCMove's while body) and :742-752 (EnsembleHMCMove's).  The JAX
// package has no Pallas kernel here: XLA fused each scan body around its
// gradient evaluation.
//
// Between two gradient evaluations the chain is the closing half-kick of
// step i - 1, the opening half-kick of step i (the same gradient) and the
// drift of step i.  Per element (row r, column j) of n rows of nd columns:
//   h   = 0.5 eps
//   hk  = h (g d_j)                              [d null: h g]
//   p   = p_in + hk, then p + hk again when kicks == 2  (the JAX scan adds
//         the two half-kicks one after the other, never one eps g)
//   x   = x_in + eps (p d_j)                     [drift; d null: eps p]
// kicks == 0 drifts by p_in as given: a full metric (d null) kicks with
// g = g L in one launch and drifts with p_in = p L^T in a second, the
// products by L being torch.matmul calls between them.  p_out / x_out may
// alias p_in / x_in (in place).
//
// What bounds it on an H100: bytes.  At 1e5 x 5 float32 a double kick and
// a drift read x, p and g and write x and p, 10 MB (3.0 us at 3.35 TB/s),
// with 5 flops an element.  One thread per element, consecutive threads on
// consecutive addresses.
//
// The rung axis (parallel tempering: emcee_tpu/parallel/tempering.py:538
// vmaps the chains over the ladder): kRungs steps every rung of a ladder
// in one launch, the grid's second dimension the rung; rung r's rows of
// x, p and g lie one after the other and it reads its own eps[r].  The
// one-ensemble instantiation (kRungs false) compiles to the code of the
// kernel before the axis.
//
// Arithmetic uses the _rn intrinsics (no FMA contraction), so every
// rounding matches the plain version (ops/langevin_kernel.py
// leapfrog_plain) bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <bool kRungs>
__global__ void __launch_bounds__(kThreads) leapfrog_kernel(
    const float* x_in, float* x_out, const float* p_in, float* p_out,
    const float* __restrict__ g, const float* __restrict__ d,
    const float* __restrict__ eps, int n, int nd, int kicks) {
  if constexpr (kRungs) {
    // The rung of this block: its rows and eps.
    const int rung = blockIdx.y;
    const int64_t at = static_cast<int64_t>(rung) * n * nd;
    p_in += at;
    if (kicks > 0) {
      p_out += at;
      g += at;
    }
    if (x_in != nullptr) {
      x_in += at;
      x_out += at;
    }
    eps += rung;
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(n) * nd) return;
  const int j = static_cast<int>(i % nd);
  const float e = *eps;
  const float dj = d != nullptr ? d[j] : 1.0f;
  float p = p_in[i];
  if (kicks > 0) {
    const float lt = d != nullptr ? __fmul_rn(g[i], dj) : g[i];
    const float hk = __fmul_rn(__fmul_rn(0.5f, e), lt);
    p = __fadd_rn(p, hk);
    if (kicks == 2) p = __fadd_rn(p, hk);
    p_out[i] = p;
  }
  if (x_in != nullptr) {
    const float l = d != nullptr ? __fmul_rn(p, dj) : p;
    x_out[i] = __fadd_rn(x_in[i], __fmul_rn(e, l));
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/langevin_kernel.py).  Every
// pointer is a device pointer.  kicks is 0, 1 or 2 (g, p_out unused at 0);
// x_in == nullptr skips the drift (x_out unused); d == nullptr is the
// identity metric.  ntemps rungs of n rows lie one after the other in
// every row buffer, with eps (ntemps,) (ntemps = 1: one ensemble).
// Returns cudaGetLastError() after the launch.
extern "C" int emcee_leapfrog(const float* x_in, float* x_out,
                              const float* p_in, float* p_out,
                              const float* g, const float* d,
                              const float* eps, int n, int nd, int kicks,
                              int ntemps, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * nd;
  const dim3 grid(static_cast<int>((total + kThreads - 1) / kThreads),
                  ntemps);
  auto kernel = ntemps > 1 ? leapfrog_kernel<true> : leapfrog_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x_in, x_out, p_in, p_out, g, d, eps, n, nd, kicks);
  return static_cast<int>(cudaGetLastError());
}

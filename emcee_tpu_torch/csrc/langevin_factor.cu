// K12: the Hastings / kinetic row reduction of the gradient moves.
//
// Replaces the XLA-fused reductions of emcee_tpu/moves/gradient.py:233-237
// (MALAMove's Hastings factor), :331-338 and :502-509 (the kinetic-energy
// difference of HMCMove and ChEESHMCMove), :657-661 (EnsembleMALAMove's
// factor) and :759-761 (EnsembleHMCMove's).  The JAX package has no Pallas
// kernel here: XLA fused each into the step's program.
//
// Per row r of n rows of nd columns:
//   kinetic (eps null):  out = 0.5 (sum_j a_j a_j - sum_j b_j b_j)
//   MALA (eps given):    w_j = (b_j + c_j) d_j   [c null: b_j; d null: 1]
//                        t_j = (-eps) a_j - (0.5 (eps eps)) w_j
//                        out = (sum_j a_j a_j - (sum_j t_j t_j) / (eps eps))
//                              / 2
// with a = p0, b = pL (kinetic) or a = z, b = the gradient at x, c the
// gradient at q (MALA; the full preconditioners pass w = (g_x + g_q) L as
// b, computed by torch.matmul).  Each sum runs over j = 0 .. nd - 1 in
// order from +0.0; the plain version (ops/langevin_kernel.py
// langevin_factor_plain) adds its columns in the same order, so the two
// agree bit for bit.
//
// What bounds it on an H100: bytes.  At 1e5 x 5 float32 it reads three
// (n, nd) inputs and writes n factors, 6 MB (1.8 us at 3.35 TB/s), with
// ~8 flops an element.  One thread per row: a warp's 32 rows are one
// contiguous span of each input, so its loads are coalesced within L1
// lines; at ndim 100 (the ensemble moves) a thread walks 100 columns.
//
// The rung axis (parallel tempering: emcee_tpu/parallel/tempering.py:538
// vmaps the chains over the ladder): kRungs reduces every rung of a
// ladder in one launch, the grid's second dimension the rung; rung r's
// rows of a, b, c and out lie one after the other and it reads its own
// eps[r].  The one-ensemble instantiation (kRungs false) compiles to the
// code of the kernel before the axis.
//
// Arithmetic uses the _rn intrinsics (no FMA contraction), so every
// rounding matches the plain version.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <bool kRungs>
__global__ void __launch_bounds__(kThreads) langevin_factor_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ d,
    const float* __restrict__ eps, float* __restrict__ out, int n, int nd) {
  if constexpr (kRungs) {
    // The rung of this block: its rows, factors and eps.
    const int rung = blockIdx.y;
    const int64_t at = static_cast<int64_t>(rung) * n * nd;
    a += at;
    b += at;
    if (c != nullptr) c += at;
    if (eps != nullptr) eps += rung;
    out += static_cast<int64_t>(rung) * n;
  }
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t base = static_cast<int64_t>(r) * nd;
  float s1 = 0.0f, s2 = 0.0f;
  if (eps == nullptr) {
    for (int j = 0; j < nd; ++j) {
      const float u = a[base + j];
      const float v = b[base + j];
      s1 = __fadd_rn(s1, __fmul_rn(u, u));
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
    out[r] = __fmul_rn(0.5f, __fsub_rn(s1, s2));
    return;
  }
  const float e = *eps;
  const float ee = __fmul_rn(e, e);
  const float half = __fmul_rn(0.5f, ee);
  const float ne = -e;
  for (int j = 0; j < nd; ++j) {
    const float z = a[base + j];
    float w = b[base + j];
    if (c != nullptr) w = __fadd_rn(w, c[base + j]);
    if (d != nullptr) w = __fmul_rn(w, d[j]);
    const float t = __fsub_rn(__fmul_rn(ne, z), __fmul_rn(half, w));
    s1 = __fadd_rn(s1, __fmul_rn(z, z));
    s2 = __fadd_rn(s2, __fmul_rn(t, t));
  }
  out[r] = __fdiv_rn(__fsub_rn(s1, __fdiv_rn(s2, ee)), 2.0f);
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/langevin_kernel.py).  Every
// pointer is a device pointer; eps == nullptr selects the kinetic mode (c
// and d unused).  ntemps rungs of n rows lie one after the other in a, b,
// c and out, with eps (ntemps,) (ntemps = 1: one ensemble).  Returns
// cudaGetLastError() after the launch.
extern "C" int emcee_langevin_factor(const float* a, const float* b,
                                     const float* c, const float* d,
                                     const float* eps, float* out, int n,
                                     int nd, int ntemps, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, ntemps);
  auto kernel = ntemps > 1 ? langevin_factor_kernel<true>
                           : langevin_factor_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, d, eps, out, n, nd);
  return static_cast<int>(cudaGetLastError());
}

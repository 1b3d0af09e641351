// K11: the Langevin step / momentum draw of the gradient moves.
//
// Replaces the XLA-fused chains of emcee_tpu/moves/gradient.py:218-225
// (MALAMove.propose: the normal draw and the preconditioned Langevin
// proposal), :301-312 (HMCMove's step-size jitter and momenta), :483
// (ChEESHMCMove's momenta), :652 (EnsembleMALAMove's noise) and :727-740
// (EnsembleHMCMove's jitter and momenta).  The
// JAX package has no Pallas kernel here: XLA fused the chain into the
// step's program; eager PyTorch would run the Philox normals alone as ~100
// launches (ops/philox.py normals).
//
// Per row r (rows row0 .. row0 + n - 1 of the stream) and column pair k
// (columns 2k, 2k + 1):
//   w        = Philox words at (row0 + r, NORMAL_BLOCK | k, offset)
//   z[2k]    = Box-Muller of words 0 and 2, z[2k + 1] of words 1 and 3
//                                               [or read from z_in]
//   MALA mode (x given), per column j:
//     c      = 0.5 (eps eps)
//     gd     = (g d_j) d_j,   zd = z d_j        [d null: g, z]
//     q      = (x + c gd) + eps zd
//   with v_out given, once (thread 0):
//     v      = 2 u - 1, u the uniform of word 0 at (ROLL_LANE, v_block,
//              offset): the HMC moves' step-size jitter of the proposal
//              (ops/philox.py grad_uniform), drawn beside its momenta
// The ops/philox.py normals words and Box-Muller, so the plain version
// (ops/langevin_kernel.py) draws with normals() itself.  With z_in given
// nothing is drawn: the parity mode, and the full preconditioners' second
// pass (g = (g L) L^T, z_in = z L^T, d null), whose products by L are
// torch.matmul calls between two launches.
//
// What bounds it on an H100: bytes.  In MALA mode at 1e5 x 5 float32 it
// reads x and g and writes z and q, 8 MB (2.4 us at 3.35 TB/s); per pair
// of columns it does one Philox block (~100 integer operations), two logf,
// two cosf and ~10 flops, far below the card's rates.  One thread per
// (row, pair): consecutive threads take consecutive pairs of a row, then
// the next row, so loads and stores of a warp touch one contiguous span.
//
// Arithmetic uses the _rn intrinsics so that nvcc cannot contract a
// multiply and an add into an FMA: every rounding matches the plain
// version bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

#define EMCEE_NORMAL_BLOCK 0x40000000u

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mala_elem(float x, float g, float z,
                                           const float* __restrict__ d,
                                           int j, float e, float c) {
  if (d != nullptr) {
    const float dj = d[j];
    g = __fmul_rn(__fmul_rn(g, dj), dj);
    z = __fmul_rn(z, dj);
  }
  return __fadd_rn(__fadd_rn(x, __fmul_rn(c, g)), __fmul_rn(e, z));
}

__global__ void __launch_bounds__(kThreads) langevin_step_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ d, const float* __restrict__ eps,
    const float* __restrict__ z_in, float* __restrict__ z_out,
    float* __restrict__ q, float* __restrict__ v_out, uint32_t v_block,
    int n, int nd, uint32_t row0, uint32_t k0, uint32_t k1,
    const long long* __restrict__ offset_dev,
    unsigned long long offset_inc) {
  const int npairs = (nd + 1) >> 1;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (v_out != nullptr && t == 0) {
    const uint4 w = philox_at(EMCEE_ROLL_LANE, v_block,
                              philox_offset(offset_dev, offset_inc), k0, k1);
    *v_out = __fsub_rn(__fmul_rn(philox_uniform(w.x), 2.0f), 1.0f);
  }
  if (t >= static_cast<int64_t>(n) * npairs) return;
  const int r = static_cast<int>(t / npairs);
  const int k = static_cast<int>(t - static_cast<int64_t>(r) * npairs);
  const int j0 = 2 * k;
  const bool two = j0 + 1 < nd;
  const int64_t at = static_cast<int64_t>(r) * nd + j0;
  float z0, z1 = 0.0f;
  if (z_in != nullptr) {
    z0 = z_in[at];
    if (two) z1 = z_in[at + 1];
  } else {
    const uint64_t off = philox_offset(offset_dev, offset_inc);
    const uint4 w = philox_at(row0 + static_cast<uint32_t>(r),
                              EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(k),
                              off, k0, k1);
    z0 = philox_normal(w.x, w.z);
    z_out[at] = z0;
    if (two) {
      z1 = philox_normal(w.y, w.w);
      z_out[at + 1] = z1;
    }
  }
  if (x == nullptr) return;
  const float e = *eps;
  const float c = __fmul_rn(0.5f, __fmul_rn(e, e));
  q[at] = mala_elem(x[at], g[at], z0, d, j0, e, c);
  if (two) q[at + 1] = mala_elem(x[at + 1], g[at + 1], z1, d, j0 + 1, e, c);
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/langevin_kernel.py).  Every
// pointer is a device pointer.  x == nullptr selects draw-only mode (z_out
// written, g, eps and q unused); z_in != nullptr reads z instead of
// drawing (z_out unused); d == nullptr is the identity preconditioner;
// v_out != nullptr also writes the jitter's v of block v_block (n may then
// be 0).  The Philox offset is *offset_dev + offset (offset alone when
// offset_dev is null).  Returns cudaGetLastError() after the launch.
extern "C" int emcee_langevin_step(
    const float* x, const float* g, const float* d, const float* eps,
    const float* z_in, float* z_out, float* q, float* v_out,
    unsigned int v_block, int n, int nd, int row0, unsigned long long seed,
    const long long* offset_dev, unsigned long long offset, void* stream) {
  const int64_t threads = static_cast<int64_t>(n) * ((nd + 1) / 2);
  const int grid =
      threads > 0 ? static_cast<int>((threads + kThreads - 1) / kThreads) : 1;
  langevin_step_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, g, d, eps, z_in, z_out, q, v_out, v_block, n, nd,
      static_cast<uint32_t>(row0),
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32),
      offset_dev, offset);
  return static_cast<int>(cudaGetLastError());
}

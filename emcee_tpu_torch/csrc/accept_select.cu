// K2: the fused accept/select write-back.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/red_blue.py:196-204
// (RedBlueMove._inner: Metropolis compare and select) and :323-344 (the
// _propose_blocked dynamic_update_slice write-back).  As for K1, there is
// no Pallas kernel behind it: XLA fused the chain; eager PyTorch would
// run it as separate launches.
//
// Per walker i of split group `split` (ensemble rows lo = split*ng .. +ng):
//   log_u   = log(Philox word 1 at (i, split, offset))   [or injected]
//   lnpdiff = factor[i] + lp_q[i] - log_prob[lo+i]       (this order, :197)
//   acc     = log_u < lnpdiff                            (NaN lp_q rejects)
//   if acc: coords[lo+i, :] = q[i, :]; log_prob[lo+i] = lp_q[i];
//           count[lo+i] += 1                             (count optional)
//   accepted[lo+i] = acc
//
// What bounds it on an H100: bytes, and launch latency at the main path's
// size.  Per walker it reads 3 floats and writes one bool; an accepted
// walker also reads its ndim floats of q, writes ndim + 1 floats and
// updates one int: about 2 MB in all for ng = 50000, ndim = 5 at an
// acceptance of one half.  The design writes the selected rows in place
// into the ensemble buffer, so no selected copy is made and rejected rows
// and their counts are not touched at all; the accept uniform is
// recomputed from the counter in
// registers (never stored), and the per-walker acceptance count is
// accumulated here on the device so the sampler's loop needs no extra
// launch and no host sync for it.  One thread owns one walker, so the
// count needs no atomics.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void accept_select_kernel(
    const float* __restrict__ q, const float* __restrict__ factor,
    const float* __restrict__ lp_q, float* __restrict__ coords,
    float* __restrict__ log_prob, bool* __restrict__ accepted,
    int32_t* __restrict__ count, const float* __restrict__ log_u, int ng,
    int nd, int split, uint32_t k0, uint32_t k1,
    const long long* __restrict__ offset_dev, unsigned long long offset_inc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ng) return;

  float lu;
  if (log_u != nullptr) {
    lu = log_u[i];
  } else {
    const uint4 w = philox_at(static_cast<uint32_t>(i),
                              static_cast<uint32_t>(split),
                              philox_offset(offset_dev, offset_inc), k0, k1);
    lu = logf(philox_uniform(w.y));
  }
  const int64_t row = static_cast<int64_t>(split) * ng + i;
  const float lpq = lp_q[i];
  const float lnpdiff = __fsub_rn(__fadd_rn(factor[i], lpq), log_prob[row]);
  const bool acc = lu < lnpdiff;
  if (acc) {
    const float* src = q + static_cast<int64_t>(i) * nd;
    float* dst = coords + row * nd;
    for (int d = 0; d < nd; ++d) dst[d] = src[d];
    log_prob[row] = lpq;
    if (count != nullptr) count[row] += 1;
  }
  accepted[row] = acc;
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/accept_kernel.py).  Every
// pointer is a device pointer; log_u == nullptr selects the in-kernel
// Philox stream, at offset *offset_dev + offset (offset alone when
// offset_dev is null); count == nullptr skips the acceptance count.
// Returns cudaGetLastError() after the launch.
extern "C" int emcee_accept_select(
    const float* q, const float* factor, const float* lp_q, float* coords,
    float* log_prob, bool* accepted, int* count, const float* log_u, int ng,
    int nd, int split, unsigned long long seed, const long long* offset_dev,
    unsigned long long offset, void* stream) {
  const int blocks = (ng + kThreads - 1) / kThreads;
  accept_select_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      q, factor, lp_q, coords, log_prob, accepted,
      reinterpret_cast<int32_t*>(count), log_u, ng, nd, split,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32),
      offset_dev, offset);
  return static_cast<int>(cudaGetLastError());
}

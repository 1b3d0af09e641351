// K1: the fused stretch proposal.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/stretch.py:59-84
// (StretchMove.get_proposal, both pair modes) together with the fused
// uniform draw of emcee_tpu/moves/red_blue.py:138-148.  There is no Pallas
// kernel behind it: the JAX package left this chain to XLA, which fused it
// into one program per step.  Eager PyTorch does not fuse, so the port
// writes the chain by hand.
//
// Per walker i of split group `split` (ng walkers, rows split*ng .. +ng of
// the contiguous ensemble buffer), against the complement c (the other
// nc = nw - ng rows, in row order):
//   u_z, u_pair  = Philox words 0 and 2 at (i, split, offset)   [or injected]
//   u_s          = Philox word 0 at (ROLL_LANE, split, offset)  [or injected]
//   a_eff        = 1 + (a - 1) * scale                          [scale tuned]
//   z            = ((a_eff - 1) u_z + 1)^2 / a_eff
//   partner      = c[(i + int(u_s nc)) % nc]                    (roll)
//                | c[min(int(u_pair nc), nc - 1)]               (random)
//   q            = c_r - (c_r - s) z
//   factor       = (ndim_global - 1) log z
//
// What bounds it on an H100: bytes.  Per walker it reads 2 ndim floats and
// writes ndim + 1; the arithmetic (ten Philox rounds, one logf) is far
// below the card's integer and float32 rates.  At the main path's shape
// (ng = 50000, ndim = 5) the whole call moves ~3 MB, so a single launch is
// bound by launch latency more than by the 3.35 TB/s of HBM.  The design
// answers the bytes: the uniforms are computed in registers from the
// counter and never written to or read from memory, which is the point
// the JAX package's fused draw made; the complement is addressed in place
// (no torch.cat of the other groups); one thread per walker loops over
// ndim.  Partner rows are read at random offsets in random-pair mode; at
// ndim = 5 a row is 20 bytes, so each read is one or two sectors.
//
// Arithmetic uses the _rn intrinsics so that nvcc cannot contract a
// multiply and an add into an FMA: every rounding then matches the plain
// PyTorch version (ops/stretch_kernel.py), which evaluates the same
// expression one operation at a time.  logf is the accurate libdevice
// function (no --use_fast_math).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void stretch_propose_kernel(
    const float* __restrict__ coords, float* __restrict__ q,
    float* __restrict__ factor, int ng, int nd, int split, int nc,
    int pair_mode, float a, float am1, const float* __restrict__ scale,
    float ndim_m1, const float* __restrict__ u_z,
    const float* __restrict__ u_pair, const float* __restrict__ u_shift,
    uint32_t k0, uint32_t k1, const long long* __restrict__ offset_dev,
    unsigned long long offset_inc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ng) return;

  float uz, up, us = 0.0f;
  if (u_z != nullptr) {
    uz = u_z[i];
    up = pair_mode ? u_pair[i] : 0.0f;
    if (!pair_mode) us = *u_shift;
  } else {
    const uint64_t off = philox_offset(offset_dev, offset_inc);
    const uint4 w = philox_at(static_cast<uint32_t>(i),
                              static_cast<uint32_t>(split), off, k0, k1);
    uz = philox_uniform(w.x);
    up = philox_uniform(w.z);
    if (!pair_mode) {
      const uint4 ws = philox_at(EMCEE_ROLL_LANE,
                                 static_cast<uint32_t>(split), off, k0, k1);
      us = philox_uniform(ws.x);
    }
  }

  int r;
  const float ncf = static_cast<float>(nc);
  if (!pair_mode) {
    const int shift = static_cast<int>(__fmul_rn(us, ncf));
    r = (i + shift) % nc;
  } else {
    r = min(static_cast<int>(__fmul_rn(up, ncf)), nc - 1);
  }
  // Complement index -> ensemble row: the split's own rows are skipped.
  const int64_t row = r + (r >= split * ng ? ng : 0);

  float a_eff = a;
  float a_m1 = am1;
  if (scale != nullptr) {
    a_eff = __fadd_rn(1.0f, __fmul_rn(am1, *scale));
    a_m1 = __fsub_rn(a_eff, 1.0f);
  }
  const float t = __fadd_rn(__fmul_rn(a_m1, uz), 1.0f);
  const float z = __fdiv_rn(__fmul_rn(t, t), a_eff);
  factor[i] = __fmul_rn(ndim_m1, logf(z));

  const float* s_row = coords + (static_cast<int64_t>(split) * ng + i) * nd;
  const float* c_row = coords + row * nd;
  float* q_row = q + static_cast<int64_t>(i) * nd;
  for (int d = 0; d < nd; ++d) {
    const float c = c_row[d];
    q_row[d] = __fsub_rn(c, __fmul_rn(__fsub_rn(c, s_row[d]), z));
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/stretch_kernel.py).  Every
// pointer is a device pointer; u_z == nullptr selects the in-kernel
// Philox stream, otherwise u_z (and u_pair for random mode, u_shift for
// roll mode) are injected.  scale == nullptr means untuned.  The Philox
// offset is *offset_dev + offset (offset alone when offset_dev is null).
// Returns cudaGetLastError() after the launch.
extern "C" int emcee_stretch_propose(
    const float* coords, float* q, float* factor, int ng, int nd, int split,
    int nsplits, int pair_mode, float a, float am1, const float* scale,
    float ndim_m1, const float* u_z, const float* u_pair,
    const float* u_shift, unsigned long long seed,
    const long long* offset_dev, unsigned long long offset, void* stream) {
  const int nc = (nsplits - 1) * ng;
  const int blocks = (ng + kThreads - 1) / kThreads;
  stretch_propose_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      coords, q, factor, ng, nd, split, nc, pair_mode, a, am1, scale,
      ndim_m1, u_z, u_pair, u_shift, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset_dev, offset);
  return static_cast<int>(cudaGetLastError());
}

// K5a: the fused differential-evolution proposal.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/de.py:45-85
// (DEMove.get_proposal, roll branch :56-71 and random branch :72-83).  As
// for K1, there is no Pallas kernel behind it: the JAX package left the
// chain to XLA, which fused it into the step's program; eager PyTorch
// would run it as a dozen launches.
//
// Per walker i of split group `split` (ng walkers, rows split*ng .. +ng of
// the contiguous ensemble buffer), against the complement c (the other
// nc = nw - ng rows, in row order):
//   z        = Box-Muller of Philox words 0 and 2 at (i, split, offset)
//                                                          [or injected]
//   roll:    u1, u2 = Philox words 0, 1 at (ROLL_LANE, split, offset)
//                     (every thread draws the same block; or injected as
//                      two uniforms)
//            s1 = int(u1 nc) % nc, d = 1 + int(u2 (nc - 1)),
//            s2 = (s1 + d) % nc
//            a  = (i + s1) % nc, b = (i + s2) % nc
//   random:  a = min(int(u0 nc), nc - 1), b = min(int(u1 (nc - 1)), nc - 2)
//            from Philox words 0, 1 at (i, PAIR_BLOCK | split, offset)
//            [or injected a, b]; b += (b >= a)
//   g        = gamma0 * scale                              [scale tuned]
//   gamma    = g * (1 + sigma z)
//   q        = s + gamma (c[b] - c[a])
//   factor   = 0                                           (symmetric)
//
// What bounds it on an H100: bytes.  Per walker it reads s and two
// complement rows and writes q: at the workload-3 shape (ng = 5000,
// ndim = 100) about 6 MB, ~1.8 us at 3.35 TB/s; the arithmetic (one
// Philox, one logf, one cosf per walker, three flops per element) is far
// below the float32 rate.  The design answers the bytes: one warp owns one
// walker, so the lanes read and write a row together (coalesced, 16-byte
// float4 accesses when ndim % 4 == 0 and the rows are aligned), the
// walker's normal is computed in registers from the counter (every lane of
// the warp computes the same value in lock step, so no shuffle is needed),
// and the complement is addressed in place through K1's row map
// r + (r >= split*ng)*ng: no torch.cat of the other groups.
//
// Arithmetic uses the _rn intrinsics so that nvcc cannot contract a
// multiply and an add into an FMA: every rounding matches the plain
// PyTorch version (ops/de_kernel.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float de_elem(float s, float ca, float cb,
                                         float gamma) {
  return __fadd_rn(s, __fmul_rn(gamma, __fsub_rn(cb, ca)));
}

template <bool kVec4>
__global__ void de_propose_kernel(
    const float* __restrict__ coords, float* __restrict__ q,
    float* __restrict__ factor, int ng, int nd, int split, int nc,
    int pair_mode, float gamma0, const float* __restrict__ scale,
    float sigma, const float* __restrict__ z_in,
    const float* __restrict__ u_shift, const int* __restrict__ idx_a,
    const int* __restrict__ idx_b, uint32_t k0, uint32_t k1,
    const long long* __restrict__ offset_dev, unsigned long long offset_inc) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= ng) return;  // uniform across the warp

  const uint32_t ui = static_cast<uint32_t>(i);
  const uint32_t us = static_cast<uint32_t>(split);
  const uint64_t off = philox_offset(offset_dev, offset_inc);
  float z;
  if (z_in != nullptr) {
    z = z_in[i];
  } else {
    const uint4 w = philox_at(ui, us, off, k0, k1);
    z = philox_normal(w.x, w.z);
  }

  int a, b;
  if (pair_mode == 0) {
    float u1, u2;
    if (u_shift != nullptr) {
      u1 = u_shift[0];
      u2 = u_shift[1];
    } else {
      const uint4 w = philox_at(EMCEE_ROLL_LANE, us, off, k0, k1);
      u1 = philox_uniform(w.x);
      u2 = philox_uniform(w.y);
    }
    const int s1 =
        static_cast<int>(__fmul_rn(u1, static_cast<float>(nc))) % nc;
    const int d =
        1 + static_cast<int>(__fmul_rn(u2, static_cast<float>(nc - 1)));
    const int s2 = (s1 + d) % nc;
    a = (i + s1) % nc;
    b = (i + s2) % nc;
  } else {
    if (idx_a != nullptr) {
      a = idx_a[i];
      b = idx_b[i];
    } else {
      const uint4 w = philox_at(ui, us | EMCEE_PAIR_BLOCK, off, k0, k1);
      a = min(static_cast<int>(
                  __fmul_rn(philox_uniform(w.x), static_cast<float>(nc))),
              nc - 1);
      b = min(static_cast<int>(__fmul_rn(philox_uniform(w.y),
                                         static_cast<float>(nc - 1))),
              nc - 2);
    }
    b += (b >= a) ? 1 : 0;
  }
  // Complement index -> ensemble row: the split's own rows are skipped.
  const int lo = split * ng;
  const int64_t row_a = a + (a >= lo ? ng : 0);
  const int64_t row_b = b + (b >= lo ? ng : 0);

  const float g = scale != nullptr ? __fmul_rn(gamma0, *scale) : gamma0;
  const float gamma = __fmul_rn(g, __fadd_rn(1.0f, __fmul_rn(sigma, z)));

  const int64_t row_s = static_cast<int64_t>(lo) + i;
  if (kVec4) {
    const int n4 = nd >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(coords + row_s * nd);
    const float4* a4 = reinterpret_cast<const float4*>(coords + row_a * nd);
    const float4* b4 = reinterpret_cast<const float4*>(coords + row_b * nd);
    float4* q4 = reinterpret_cast<float4*>(q + static_cast<int64_t>(i) * nd);
    for (int d = lane; d < n4; d += 32) {
      const float4 s = s4[d], ca = a4[d], cb = b4[d];
      q4[d] = make_float4(de_elem(s.x, ca.x, cb.x, gamma),
                          de_elem(s.y, ca.y, cb.y, gamma),
                          de_elem(s.z, ca.z, cb.z, gamma),
                          de_elem(s.w, ca.w, cb.w, gamma));
    }
  } else {
    const float* s_row = coords + row_s * nd;
    const float* a_row = coords + row_a * nd;
    const float* b_row = coords + row_b * nd;
    float* q_row = q + static_cast<int64_t>(i) * nd;
    for (int d = lane; d < nd; d += 32) {
      q_row[d] = de_elem(s_row[d], a_row[d], b_row[d], gamma);
    }
  }
  if (lane == 0) factor[i] = 0.0f;
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/de_kernel.py).  Every pointer
// is a device pointer.  z == nullptr selects the in-kernel Philox normal;
// in roll mode u_shift (two uniforms) overrides the in-kernel shift draw;
// in random mode idx_a/idx_b (the raw picks, before b is moved past a)
// override the in-kernel partner draw.  scale == nullptr means untuned.
// The Philox offset is *offset_dev + offset (offset alone when offset_dev
// is null).
// vec4 != 0 promises ndim % 4 == 0 and 16-byte aligned coords and q.
// Returns cudaGetLastError() after the launch.
extern "C" int emcee_de_propose(
    const float* coords, float* q, float* factor, int ng, int nd, int split,
    int nsplits, int pair_mode, float gamma0, const float* scale,
    float sigma, const float* z, const float* u_shift, const int* idx_a,
    const int* idx_b, int vec4, unsigned long long seed,
    const long long* offset_dev, unsigned long long offset, void* stream) {
  const int nc = (nsplits - 1) * ng;
  const int blocks = (ng + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto kernel = vec4 ? de_propose_kernel<true> : de_propose_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, q, factor, ng, nd, split, nc, pair_mode, gamma0, scale, sigma,
      z, u_shift, idx_a, idx_b, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset_dev, offset);
  return static_cast<int>(cudaGetLastError());
}

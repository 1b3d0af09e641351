// K5b: the fused DE-snooker proposal.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/de_snooker.py:78-139
// (DESnookerMove._draw_roll, _draw_random and get_proposal).  As for K1,
// there is no Pallas kernel behind it: XLA fused the chain into the step's
// program.
//
// Per walker i of split group `split` (ng walkers per group, groups the
// contiguous row blocks of the ensemble buffer), three picks from the
// other groups take the roles (z, z1, z2):
//   roll:    four uniforms at (ROLL_LANE, split, offset), one Philox block
//            that every thread draws (or injected): u0 picks the role
//            permutation (nsplits = 4
//            only; with nsplits = 2 the three picks come from shifts of the
//            one complement and keep their order), u1..u3 the shifts
//            sh_k = int(u_k ng) of pick k, which lies in group
//            g_k = (k % (nsplits-1)) skipping `split`, row g_k ng +
//            (i + sh_k) % ng.
//   random:  (nsplits = 4) Philox words 0..2 at (i, PAIR_BLOCK | split,
//            offset) give idx_k = min(int(u_k ng), ng - 1) in group g_k,
//            word 3 the walker's permutation min(int(u3 6), 5) [or
//            injected idx (3, ng), perm (ng,)].
// Then, with two row reductions:
//   delta  = s - z;  norm = sqrt(sum delta^2);  u = delta / norm
//   proj   = sum u (z1 - z2);  gp = gammas * scale * proj
//   q      = s + u gp
//   factor = (ndim_global - 1) (log|norm + gp| - log norm)
//
// What bounds it on an H100: bytes.  Per walker it reads s and three rows
// and writes q and factor: at the workload-3 shape (ng = 5000,
// ndim = 100) the function must move about 6 MB (each input byte once),
// ~1.8 us at 3.35 TB/s; about ten flops per element are far below the
// float32 rate.  The design: one warp owns one walker, so the lanes read a
// row together (coalesced, 16-byte float4 accesses when ndim % 4 == 0 and
// the rows are aligned); the two sums are warp shuffles (no shared memory,
// no second launch); the three passes over a row (norm, projection,
// update) read it again from L1, not from HBM; the complement is read in
// place, with no gather of the picks into a (3, ng, ndim) stack.
//
// The sums run in another order than torch.sum, so q and factor match the
// plain version (ops/snooker_kernel.py) to rounding, not bit for bit; each
// element's own arithmetic uses the _rn intrinsics (no FMA contraction),
// and logf is the accurate libdevice function.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// The 3! role permutations, in itertools.permutations order (_PERMS3).
__constant__ int kPerms3[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                  {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  return v;
}

// The group of pick k (0..2): part k % (nsplits - 1) of the complement,
// skipping block `split`.
__device__ __forceinline__ int pick_group(int k, int split, int nsplits) {
  const int g = k % (nsplits - 1);
  return g + (g >= split ? 1 : 0);
}

// The element type of a row, and its count, in the float4 or the scalar
// view.
template <bool kVec4>
struct Row;

template <>
struct Row<true> {
  using T = float4;
  static __device__ __forceinline__ int n(int nd) { return nd >> 2; }
};

template <>
struct Row<false> {
  using T = float;
  static __device__ __forceinline__ int n(int nd) { return nd; }
};

__device__ __forceinline__ float sq_diff(float s, float z) {
  const float d = __fsub_rn(s, z);
  return __fmul_rn(d, d);
}
__device__ __forceinline__ float sq_diff(float4 s, float4 z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(sq_diff(s.x, z.x), sq_diff(s.y, z.y)),
                             sq_diff(s.z, z.z)),
                   sq_diff(s.w, z.w));
}
__device__ __forceinline__ float proj_term(float s, float z, float z1,
                                           float z2, float norm) {
  return __fmul_rn(__fdiv_rn(__fsub_rn(s, z), norm), __fsub_rn(z1, z2));
}
__device__ __forceinline__ float proj_term(float4 s, float4 z, float4 z1,
                                           float4 z2, float norm) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(proj_term(s.x, z.x, z1.x, z2.x, norm),
                          proj_term(s.y, z.y, z1.y, z2.y, norm)),
                proj_term(s.z, z.z, z1.z, z2.z, norm)),
      proj_term(s.w, z.w, z1.w, z2.w, norm));
}
__device__ __forceinline__ float update(float s, float z, float norm,
                                        float gp) {
  return __fadd_rn(s, __fmul_rn(__fdiv_rn(__fsub_rn(s, z), norm), gp));
}
__device__ __forceinline__ float4 update(float4 s, float4 z, float norm,
                                         float gp) {
  return make_float4(update(s.x, z.x, norm, gp), update(s.y, z.y, norm, gp),
                     update(s.z, z.z, norm, gp), update(s.w, z.w, norm, gp));
}

template <bool kVec4>
__global__ void snooker_propose_kernel(
    const float* __restrict__ coords, float* __restrict__ q,
    float* __restrict__ factor, int ng, int nd, int split, int nsplits,
    int pair_mode, float gammas, const float* __restrict__ scale,
    float ndim_m1, const float* __restrict__ u4,
    const int* __restrict__ idx, const int* __restrict__ perm, uint32_t k0,
    uint32_t k1, const long long* __restrict__ offset_dev,
    unsigned long long offset_inc) {
  using T = typename Row<kVec4>::T;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= ng) return;  // uniform across the warp

  // Ensemble rows of the roles z, z1, z2.
  const uint64_t off = philox_offset(offset_dev, offset_inc);
  int64_t rows[3];
  if (pair_mode == 0) {
    float u[4];
    if (u4 != nullptr) {
      for (int k = 0; k < 4; ++k) u[k] = u4[k];
    } else {
      const uint4 w = philox_at(EMCEE_ROLL_LANE, static_cast<uint32_t>(split),
                                off, k0, k1);
      u[0] = philox_uniform(w.x);
      u[1] = philox_uniform(w.y);
      u[2] = philox_uniform(w.z);
      u[3] = philox_uniform(w.w);
    }
    int order[3] = {0, 1, 2};
    if (nsplits > 2) {
      const int p = min(static_cast<int>(__fmul_rn(u[0], 6.0f)), 5);
      for (int r = 0; r < 3; ++r) order[r] = kPerms3[p][r];
    }
    for (int r = 0; r < 3; ++r) {
      const int k = order[r];
      const int sh =
          static_cast<int>(__fmul_rn(u[1 + k], static_cast<float>(ng)));
      rows[r] = static_cast<int64_t>(pick_group(k, split, nsplits)) * ng +
                (i + sh) % ng;
    }
  } else {
    int pick[3], p;
    if (idx != nullptr) {
      for (int k = 0; k < 3; ++k) pick[k] = idx[k * ng + i];
      p = perm[i];
    } else {
      const uint4 w =
          philox_at(static_cast<uint32_t>(i),
                    static_cast<uint32_t>(split) | EMCEE_PAIR_BLOCK, off, k0,
                    k1);
      const uint32_t wk[3] = {w.x, w.y, w.z};
      for (int k = 0; k < 3; ++k) {
        pick[k] = min(static_cast<int>(__fmul_rn(philox_uniform(wk[k]),
                                                 static_cast<float>(ng))),
                      ng - 1);
      }
      p = min(static_cast<int>(__fmul_rn(philox_uniform(w.w), 6.0f)), 5);
    }
    for (int r = 0; r < 3; ++r) {
      const int k = kPerms3[p][r];
      rows[r] = static_cast<int64_t>(pick_group(k, split, nsplits)) * ng +
                pick[k];
    }
  }

  const int n = Row<kVec4>::n(nd);
  const int64_t row_s = static_cast<int64_t>(split) * ng + i;
  const T* s_row = reinterpret_cast<const T*>(coords + row_s * nd);
  const T* z_row = reinterpret_cast<const T*>(coords + rows[0] * nd);
  const T* z1_row = reinterpret_cast<const T*>(coords + rows[1] * nd);
  const T* z2_row = reinterpret_cast<const T*>(coords + rows[2] * nd);
  T* q_row = reinterpret_cast<T*>(q + static_cast<int64_t>(i) * nd);

  float acc = 0.0f;
  for (int d = lane; d < n; d += 32) {
    acc = __fadd_rn(acc, sq_diff(s_row[d], z_row[d]));
  }
  const float norm = __fsqrt_rn(warp_sum(acc));

  acc = 0.0f;
  for (int d = lane; d < n; d += 32) {
    acc = __fadd_rn(acc, proj_term(s_row[d], z_row[d], z1_row[d], z2_row[d],
                                   norm));
  }
  const float proj = warp_sum(acc);
  const float gam = scale != nullptr ? __fmul_rn(gammas, *scale) : gammas;
  const float gp = __fmul_rn(gam, proj);

  for (int d = lane; d < n; d += 32) {
    q_row[d] = update(s_row[d], z_row[d], norm, gp);
  }
  if (lane == 0) {
    factor[i] = __fmul_rn(
        ndim_m1, __fsub_rn(logf(fabsf(__fadd_rn(norm, gp))), logf(norm)));
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/snooker_kernel.py).  Every
// pointer is a device pointer.  Roll mode: u4 (four uniforms) overrides
// the in-kernel draw of the role permutation and shifts.  Random mode: idx
// (3, ng) and perm (ng,) override the in-kernel Philox picks.  The Philox
// offset is *offset_dev + offset (offset alone when offset_dev is null).
// scale == nullptr means untuned.  vec4 != 0 promises
// ndim % 4 == 0 and 16-byte aligned coords and q.  Returns
// cudaGetLastError() after the launch.
extern "C" int emcee_snooker_propose(
    const float* coords, float* q, float* factor, int ng, int nd, int split,
    int nsplits, int pair_mode, float gammas, const float* scale,
    float ndim_m1, const float* u4, const int* idx, const int* perm,
    int vec4, unsigned long long seed, const long long* offset_dev,
    unsigned long long offset, void* stream) {
  const int blocks = (ng + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto kernel =
      vec4 ? snooker_propose_kernel<true> : snooker_propose_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, q, factor, ng, nd, split, nsplits, pair_mode, gammas, scale,
      ndim_m1, u4, idx, perm, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset_dev, offset);
  return static_cast<int>(cudaGetLastError());
}

// K5a: the fused differential-evolution proposal, tiled.
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
//                     [or injected as two uniforms]
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
// The side mode (kSide, a template parameter, so the DE instantiations
// keep the code they had) is the side move's proposal (emcee_tpu/moves/
// side.py:57-85, q = s + (sigma / sqrt 2) z (c_j - c_i)): the same pairs,
// the same walker normal and the same zero factor, but no jitter:
//   gamma    = (g / sqrt 2) z,  g = gamma0 [* scale]
// with gamma0 the side move's sigma.  Untuned, g / sqrt 2 is the float32
// quotient the JAX package computes once on the host (sigma / sqrt(2));
// tuned, (sigma * scale) / sqrt 2, two float32 operations, as
// moves/side.py rounds them.
//
// What bounds it on an H100: bytes.  Per walker it reads s and two
// complement rows and writes q: at the workload-3 shape (ng = 5000,
// ndim = 100) the function must move 6 MB (each input byte once), ~1.8 us
// at 3.35 TB/s.  The arithmetic (one or two Philox blocks, one logf and
// one cosf per walker, three flops per element) is far below the float32
// rate, and there is no matrix product, so no tensor-core (wgmma) work
// exists.
//
// The first design gave one warp a walker: every lane of the warp repeated
// the walker's scalar work in lock step (the offset word, its Philox block
// and Box-Muller, a second Philox block for the split's roll draw -- the
// same value in all 5000 warps -- four runtime integer modulos), some 400
// warp instructions before the first row load, and at ndim 100 only 25 of
// the 32 lanes had a float4 to move.  The tiled design (K1's):
//   * A block owns a tile of `tile` consecutive walkers (ops/_wrap.py
//     de_plan: four blocks or more for every SM; 8 at workload 3's shape,
//     the fastest tile of a sweep over 4-64) and has `threads` threads,
//     at least one warp more than the tile.
//   * Phase A, one thread per walker: the offset word, the walker's Philox
//     block, Box-Muller and gamma (into shared memory), the zero factor,
//     and in random mode its own Philox block for the two partner rows
//     (into shared memory).  The first lane of the last warp, which holds
//     no walker, makes the split's roll draw once per block beside them
//     and puts s1 and s2 in shared memory.
//   * Phase B, after one __syncthreads: a flat loop over the tile's
//     tile*ndim elements.  The own rows s and the output q are contiguous
//     spans.  In roll mode consecutive walkers take consecutive complement
//     rows for both partners, so each partner span is contiguous except at
//     the wrap at nc and the jump over the split's own block; the wrap is
//     one compare and subtract ((i + s1) < 2 nc), equal to the modulo for
//     every shift.  In random mode each element reads its walker's partner
//     rows from shared memory.  Where ndim % 4 == 0 and both bases are
//     16-byte aligned (kVec, from the plan) every row -- partner rows
//     included, which start at arbitrary rows -- is 16-byte aligned, so all
//     four streams are float4; otherwise every access is a scalar,
//     coalesced one.
//   * kStage: at block start the spare lane issues the tile's s span (its
//     16-byte multiple) as one TMA bulk copy (cp.async.bulk) into shared
//     memory, completed on an mbarrier, so the load runs while phase A
//     draws; phase B reads s from shared memory and has only the two
//     partner rows to fetch from device memory.  The variant kept is the
//     staged one, wherever it can be (a 16-byte aligned span that fits in
//     shared memory): at workload 3's shape on the H100 it beat reading s
//     directly in phase B in every turn (chip_smoke.py phase 6, PERF.md).
//     The direct variant serves the rest.
//
// The rung axis (parallel tempering, emcee_tpu/parallel/tempering.py:
// 532-541, which vmaps the move over the ladder's rungs), as K1 has it
// (csrc/stretch_propose.cu): with T rungs the ensemble buffer is (T, nw,
// nd), q (T, ng, nd) and factor (T, ng); the grid's second dimension is
// the rung, so one launch serves every rung, a block works on one rung's
// tile, and rung r's complement is rung r's other rows only.  Rung r
// draws under its own key, keys[r] (a device table of T 64-bit keys,
// ops/philox.py rung_seed), at the counters of the one-ensemble kernel,
// so each rung equals the same rung proposed alone; it reads its own
// tuned scale[r] and, injected, its own z / idx_a / idx_b rows and its
// two u_shift uniforms.  The axis is a template parameter (kRungs): a
// single-ensemble launch runs the instantiation without it, whose code is
// the kernel of before (its parameters come last, so the others keep
// their offsets).  Staging on the rung axis takes every rung's own rows
// 16-byte aligned (ops/_wrap.py de_plan).
//
// Arithmetic uses the _rn intrinsics so that nvcc cannot contract a
// multiply and an add into an FMA: every rounding matches the plain
// PyTorch version (ops/de_kernel.py), bit for bit; logf and cosf are the
// accurate libdevice functions (no --use_fast_math).
#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"
#include "philox.cuh"

namespace {

constexpr int kTileMax = 256;         // TILE_MAX in ops/_wrap.py
constexpr int kThreadsMax = kTileMax + 32;
// sqrt(2) rounded to float32, the side mode's divisor (jnp.sqrt(2.0)).
constexpr float kRoot2 = 1.41421356237309505f;

__device__ __forceinline__ float de_elem(float s, float ca, float cb,
                                         float gamma) {
  return __fadd_rn(s, __fmul_rn(gamma, __fsub_rn(cb, ca)));
}

// Complement index r -> ensemble row: the split's own rows are skipped.
__device__ __forceinline__ int complement_row(int r, int lo, int ng) {
  return r + (r >= lo ? ng : 0);
}

// The partner rows (ra, rb) of tile walker w: random mode from shared
// memory; roll mode (t0 + w + shift) % nc, where t0 + w < ng <= nc and
// shift < nc, so the modulo is one compare and subtract.
__device__ __forceinline__ void partner_rows(int w, int pair_mode,
                                             const int* s_ra,
                                             const int* s_rb, int t0, int s1,
                                             int s2, int nc, int lo, int ng,
                                             int& ra, int& rb) {
  if (pair_mode) {
    ra = s_ra[w];
    rb = s_rb[w];
    return;
  }
  int a = t0 + w + s1;
  int b = t0 + w + s2;
  a -= (a >= nc) ? nc : 0;
  b -= (b >= nc) ? nc : 0;
  ra = complement_row(a, lo, ng);
  rb = complement_row(b, lo, ng);
}

template <bool kVec, bool kStage, bool kRungs, bool kSide>
__global__ void __launch_bounds__(kThreadsMax) de_propose_kernel(
    const float* __restrict__ coords, float* __restrict__ q,
    float* __restrict__ factor, int ng, int nd, int split, int nc, int tile,
    int pair_mode, float gamma0, const float* __restrict__ scale,
    float sigma, const float* __restrict__ z_in,
    const float* __restrict__ u_shift, const int* __restrict__ idx_a,
    const int* __restrict__ idx_b, uint32_t k0, uint32_t k1,
    const long long* __restrict__ offset_dev, unsigned long long offset_inc,
    const long long* __restrict__ keys) {
  __shared__ float s_gamma[kTileMax];
  __shared__ int s_ra[kTileMax];  // random mode: the partner rows
  __shared__ int s_rb[kTileMax];
  __shared__ int s_shift[2];      // roll mode: s1, s2
  __shared__ uint64_t s_bar;
  extern __shared__ float4 s_own4[];  // kStage: the tile's s span

  if constexpr (kRungs) {
    // The rung of this block: its rows, outputs, draws, scale and key.
    const int rung = blockIdx.y;
    coords += static_cast<int64_t>(rung) * (nc + ng) * nd;
    q += static_cast<int64_t>(rung) * ng * nd;
    factor += static_cast<int64_t>(rung) * ng;
    if (z_in != nullptr) z_in += static_cast<int64_t>(rung) * ng;
    if (u_shift != nullptr) u_shift += 2 * rung;
    if (idx_a != nullptr) {
      idx_a += static_cast<int64_t>(rung) * ng;
      idx_b += static_cast<int64_t>(rung) * ng;
    }
    if (scale != nullptr) scale += rung;
    if (keys != nullptr) {
      const auto key = static_cast<unsigned long long>(keys[rung]);
      k0 = static_cast<uint32_t>(key);
      k1 = static_cast<uint32_t>(key >> 32);
    }
  }

  const int t = threadIdx.x;
  const int spare = blockDim.x - 32;  // first lane of the last warp
  const int t0 = blockIdx.x * tile;
  const int cnt = min(tile, ng - t0);
  const int n = cnt * nd;
  const int lo = split * ng;
  const float* own = coords + static_cast<int64_t>(lo + t0) * nd;
  float* out = q + static_cast<int64_t>(t0) * nd;
  // The staged prefix: a multiple of 16 bytes from a 16-byte aligned span.
  const int n_staged = kStage ? (n & ~3) : 0;

  if (kStage && t == spare && n_staged > 0) {
    bulk_copy_to_shared(s_own4, own, static_cast<uint32_t>(n_staged) * 4u,
                        &s_bar);
  }

  // -- phase A: one thread per walker; the spare lane's roll draw -------
  if (t < cnt) {
    const int i = t0 + t;
    const uint64_t off = philox_offset(offset_dev, offset_inc);
    float z;
    if (z_in != nullptr) {
      z = z_in[i];
    } else {
      const uint4 w = philox_at(static_cast<uint32_t>(i),
                                static_cast<uint32_t>(split), off, k0, k1);
      z = philox_normal(w.x, w.z);
    }
    const float g = scale != nullptr ? __fmul_rn(gamma0, *scale) : gamma0;
    if constexpr (kSide) {
      s_gamma[t] = __fmul_rn(__fdiv_rn(g, kRoot2), z);
    } else {
      s_gamma[t] = __fmul_rn(g, __fadd_rn(1.0f, __fmul_rn(sigma, z)));
    }
    factor[i] = 0.0f;
    if (pair_mode) {
      int a, b;
      if (idx_a != nullptr) {
        a = idx_a[i];
        b = idx_b[i];
      } else {
        const uint4 w = philox_at(
            static_cast<uint32_t>(i),
            static_cast<uint32_t>(split) | EMCEE_PAIR_BLOCK, off, k0, k1);
        a = min(static_cast<int>(
                    __fmul_rn(philox_uniform(w.x), static_cast<float>(nc))),
                nc - 1);
        b = min(static_cast<int>(__fmul_rn(philox_uniform(w.y),
                                           static_cast<float>(nc - 1))),
                nc - 2);
      }
      b += (b >= a) ? 1 : 0;
      s_ra[t] = complement_row(a, lo, ng);
      s_rb[t] = complement_row(b, lo, ng);
    }
  } else if (t == spare && !pair_mode) {
    float u1, u2;
    if (u_shift != nullptr) {
      u1 = u_shift[0];
      u2 = u_shift[1];
    } else {
      const uint4 w =
          philox_at(EMCEE_ROLL_LANE, static_cast<uint32_t>(split),
                    philox_offset(offset_dev, offset_inc), k0, k1);
      u1 = philox_uniform(w.x);
      u2 = philox_uniform(w.y);
    }
    const int s1 =
        static_cast<int>(__fmul_rn(u1, static_cast<float>(nc))) % nc;
    const int d =
        1 + static_cast<int>(__fmul_rn(u2, static_cast<float>(nc - 1)));
    s_shift[0] = s1;
    s_shift[1] = (s1 + d) % nc;
  }
  __syncthreads();
  if (kStage && n_staged > 0) bulk_copy_wait(&s_bar);

  // -- phase B: the tile's elements as one flat stream ----------------------
  const int s1 = pair_mode ? 0 : s_shift[0];
  const int s2 = pair_mode ? 0 : s_shift[1];
  if (kVec) {
    // ndim % 4 == 0: a float4 never straddles two rows, and n % 4 == 0.
    const float4* own4 = reinterpret_cast<const float4*>(own);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int k = t; k < (n >> 2); k += blockDim.x) {
      const int e = 4 * k;
      const int w = e / nd;
      const int d = e - w * nd;
      int ra, rb;
      partner_rows(w, pair_mode, s_ra, s_rb, t0, s1, s2, nc, lo, ng, ra, rb);
      const float4 s = kStage ? s_own4[k] : own4[k];
      const float4 ca = *reinterpret_cast<const float4*>(
          coords + static_cast<int64_t>(ra) * nd + d);
      const float4 cb = *reinterpret_cast<const float4*>(
          coords + static_cast<int64_t>(rb) * nd + d);
      const float gamma = s_gamma[w];
      out4[k] = make_float4(de_elem(s.x, ca.x, cb.x, gamma),
                            de_elem(s.y, ca.y, cb.y, gamma),
                            de_elem(s.z, ca.z, cb.z, gamma),
                            de_elem(s.w, ca.w, cb.w, gamma));
    }
  } else {
    const float* s_own = reinterpret_cast<const float*>(s_own4);
    for (int e = t; e < n; e += blockDim.x) {
      const int w = e / nd;
      const int d = e - w * nd;
      int ra, rb;
      partner_rows(w, pair_mode, s_ra, s_rb, t0, s1, s2, nc, lo, ng, ra, rb);
      const float s = (kStage && e < n_staged) ? s_own[e] : own[e];
      out[e] = de_elem(s, coords[static_cast<int64_t>(ra) * nd + d],
                       coords[static_cast<int64_t>(rb) * nd + d],
                       s_gamma[w]);
    }
  }
}

// The instantiation of a launch plan and mode.
template <bool kSide>
auto de_instance(int vec, int stage, bool rungs) {
  return vec ? (stage ? (rungs ? de_propose_kernel<true, true, true, kSide>
                               : de_propose_kernel<true, true, false, kSide>)
                      : (rungs ? de_propose_kernel<true, false, true, kSide>
                               : de_propose_kernel<true, false, false, kSide>))
             : (stage ? (rungs ? de_propose_kernel<false, true, true, kSide>
                               : de_propose_kernel<false, true, false, kSide>)
                      : (rungs ? de_propose_kernel<false, false, true, kSide>
                               : de_propose_kernel<false, false, false,
                                                   kSide>));
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/de_kernel.py).  Every pointer
// is a device pointer.  side != 0 selects the side mode (gamma0 the side
// move's sigma; sigma unused).  z == nullptr selects the in-kernel Philox
// normal; in roll mode u_shift (two uniforms) overrides the in-kernel shift
// draw;
// in random mode idx_a/idx_b (the raw picks, before b is moved past a)
// override the in-kernel partner draw.  scale == nullptr means untuned.
// The Philox offset is *offset_dev + offset (offset alone when offset_dev
// is null).  tile, grid, threads, vec, stage and smem are the launch plan
// of ops/_wrap.py de_plan: threads >= 32 * ceil(tile / 32) + 32; vec != 0
// promises ndim % 4 == 0 and 16-byte aligned coords and q; stage != 0
// that every tile's span of own rows is 16-byte aligned, in every rung,
// and smem is its dynamic shared memory (4 * tile * nd when staged, else
// 0).  ntemps rungs of nsplits * ng walkers lie one after the other in
// coords (ntemps = 1: one ensemble), with z, idx_a and idx_b (ntemps, ng)
// and u_shift (ntemps, 2); keys == nullptr draws every rung under seed,
// else rung r under keys[r] (a device table of ntemps keys).
// Returns cudaGetLastError() after the launch.
extern "C" int emcee_de_propose(
    const float* coords, float* q, float* factor, int ng, int nd, int split,
    int nsplits, int pair_mode, int side, float gamma0, const float* scale,
    float sigma, const float* z, const float* u_shift, const int* idx_a,
    const int* idx_b, int tile, int grid, int threads, int vec, int stage,
    int smem, int ntemps, const long long* keys, unsigned long long seed,
    const long long* offset_dev, unsigned long long offset, void* stream) {
  const int nc = (nsplits - 1) * ng;
  const bool rungs = ntemps > 1 || keys != nullptr;
  auto kernel = side ? de_instance<true>(vec, stage, rungs)
                     : de_instance<false>(vec, stage, rungs);
  kernel<<<dim3(grid, ntemps), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      coords, q, factor, ng, nd, split, nc, tile, pair_mode, gamma0, scale,
      sigma, z, u_shift, idx_a, idx_b, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset_dev, offset, keys);
  return static_cast<int>(cudaGetLastError());
}

// K5b: the fused DE-snooker proposal, tiled.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/de_snooker.py:78-139
// (DESnookerMove._draw_roll, _draw_random and get_proposal).  As for K1,
// there is no Pallas kernel behind it: XLA fused the chain into the step's
// program.
//
// Per walker i of split group `split` (ng walkers per group, groups the
// contiguous row blocks of the ensemble buffer), three picks from the
// other groups take the roles (z, z1, z2):
//   roll:    four uniforms at (ROLL_LANE, split, offset) [or injected]:
//            u0 picks the role permutation (nsplits = 4 only; with
//            nsplits = 2 the three picks come from shifts of the one
//            complement and keep their order), u1..u3 the shifts
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
// ndim = 100) the function must move 6 MB (each input byte once), ~1.8 us
// at 3.35 TB/s; about ten flops per element are far below the float32
// rate, and there is no matrix product, so no tensor-core (wgmma) work
// exists.  What keeps it from that bound is latency: each walker's row
// passes through two reductions, behind a trip to memory, and each
// element through a correctly rounded division and two logs.
//
// The first design gave one warp a walker and repeated the walker's
// scalar work in every lane (a Philox block for the split's roll draw,
// the role permutation, six runtime modulos), then made three passes
// over the rows: pass 2 loaded z1 and z2 only after the first reduction,
// a second serial trip to memory, and passes 2 and 3 each divided
// (s - z) by the norm again.  The tiled design:
//   * A block owns a tile of `tile` consecutive walkers (ops/_wrap.py
//     de_plan: four blocks or more for every SM; 8 at workload 3's shape,
//     the fastest tile of a sweep over 4-16) and has `threads` threads
//     (the plan gives one warp per walker).
//   * Phase A: in random mode one thread per walker draws its Philox
//     block and puts its three role rows in shared memory; in roll mode
//     thread 0 makes the split's roll draw once per block and puts the
//     three roles' group bases and shifts there.  The modulos become
//     compare and subtract.
//   * Phase B, after one __syncthreads: each warp takes walkers of the
//     tile in turn.  For a walker, a lane first issues the loads of its
//     first chunk of all four rows (s, z, z1, z2: one float4 each, or four
//     scalars), kept in registers, and only then reduces.  A row of at
//     most 128 floats is that one chunk (kOneChunk: no loops, 35-40
//     registers, so every warp of workload 3 is resident at once; the
//     general kernel needs ~60); longer rows read their further chunks
//     again (from L1) in each pass.  u = (s - z) / norm is computed once
//     per element and reused in the projection and in the update.  Lane 0
//     writes the factor.
//   * The division: __fdiv_rn per element took a quarter of the kernel's
//     time on the H100.  The divisor is the row's norm, so its reciprocal
//     is taken once, in double, and each quotient is x * (1 / norm) in
//     double rounded to float, which is exactly __fdiv_rn's value (see
//     div_by).
//   * kVec (ndim % 4 == 0 and both bases 16-byte aligned, from the plan):
//     every row is 16-byte aligned and a chunk is one float4; otherwise a
//     chunk is four scalar loads, the last one padded.
//
// The rung axis (parallel tempering, emcee_tpu/parallel/tempering.py:
// 532-541, which vmaps the move over the ladder's rungs), as K1 and K5a
// have it: with T rungs the ensemble buffer is (T, nw, nd), q (T, ng, nd)
// and factor (T, ng); the grid's second dimension is the rung, a block
// works on one rung's tile, and rung r's groups are rung r's rows only.
// Rung r draws under its own key, keys[r] (a device table of T 64-bit
// keys, ops/philox.py rung_seed), at the counters of the one-ensemble
// kernel, so each rung equals the same rung proposed alone; it reads its
// own tuned scale[r] and, injected, its own four roll uniforms or its
// own idx (3, ng) and perm (ng,) rows.  The axis is a template parameter
// (kRungs): a single-ensemble launch runs the instantiation without it,
// whose code is the kernel of before (its parameters come last).
//
// The sum order is fixed and depends on ndim alone: lane l owns the
// 4-float chunks l, l+32, l+64, ... of the row (the last may be partial,
// its missing terms +0.0); a chunk sums as ((a+b)+c)+d; a lane adds its
// chunks in order to +0.0; the lanes combine by the __shfl_xor_sync
// butterfly 16, 8, 4, 2, 1.  Nothing in it depends on the tile, the grid,
// the SM count or alignment.  The plain version (ops/snooker_kernel.py
// row_sum) sums in the same order, so q and factor match it bit for bit.
// Each element's own arithmetic uses the _rn intrinsics (no FMA
// contraction), and logf is the accurate libdevice function.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kTileMax = 16;  // SNOOKER_TILE_MAX in ops/_wrap.py
constexpr int kThreadsMax = 32 * kTileMax;

// The 3! role permutations in itertools.permutations order (PERMS3),
// packed: role r of permutation p is bits 6p + 2r .. +1.
constexpr uint64_t kPerms3 =
    (0ull | 1ull << 2 | 2ull << 4) << 0 |   // (0, 1, 2)
    (0ull | 2ull << 2 | 1ull << 4) << 6 |   // (0, 2, 1)
    (1ull | 0ull << 2 | 2ull << 4) << 12 |  // (1, 0, 2)
    (1ull | 2ull << 2 | 0ull << 4) << 18 |  // (1, 2, 0)
    (2ull | 0ull << 2 | 1ull << 4) << 24 |  // (2, 0, 1)
    (2ull | 1ull << 2 | 0ull << 4) << 30;   // (2, 1, 0)

__device__ __forceinline__ int perm_role(int p, int r) {
  return static_cast<int>((kPerms3 >> (6 * p + 2 * r)) & 3u);
}

__device__ __forceinline__ int sel3(int k, int a, int b, int c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// The group base of pick k (0..2): part k % (nsplits - 1) of the
// complement, skipping block `split`, times ng.
__device__ __forceinline__ int pick_base(int k, int split, int nsplits,
                                         int ng) {
  int g = k;
  while (g >= nsplits - 1) g -= nsplits - 1;
  return (g + (g >= split ? 1 : 0)) * ng;
}

// Sum over the 32 lanes of a warp, butterfly 16, 8, 4, 2, 1; every lane
// gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  return v;
}

// Chunk c of a row: floats 4c .. 4c+3, the ones past nd read as 0.
template <bool kVec>
__device__ __forceinline__ float4 load_chunk(const float* row, int c,
                                             int nd) {
  if (kVec) return reinterpret_cast<const float4*>(row)[c];
  const int e = 4 * c;
  return make_float4(row[e], e + 1 < nd ? row[e + 1] : 0.0f,
                     e + 2 < nd ? row[e + 2] : 0.0f,
                     e + 3 < nd ? row[e + 3] : 0.0f);
}

template <bool kVec>
__device__ __forceinline__ void store_chunk(float* row, int c, int nd,
                                            float4 v) {
  if (kVec) {
    reinterpret_cast<float4*>(row)[c] = v;
    return;
  }
  const int e = 4 * c;
  row[e] = v.x;
  if (e + 1 < nd) row[e + 1] = v.y;
  if (e + 2 < nd) row[e + 2] = v.z;
  if (e + 3 < nd) row[e + 3] = v.w;
}

// A chunk's sum ((a+b)+c)+d of its terms, the terms of floats past nd
// (nv valid) +0.0.
__device__ __forceinline__ float chunk_sum(float a, float b, float c,
                                           float d, int nv) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a, nv > 1 ? b : 0.0f),
                             nv > 2 ? c : 0.0f),
                   nv > 3 ? d : 0.0f);
}

__device__ __forceinline__ float sq_diff(float s, float z) {
  const float d = __fsub_rn(s, z);
  return __fmul_rn(d, d);
}

__device__ __forceinline__ float norm_terms(float4 s, float4 z, int nv) {
  return chunk_sum(sq_diff(s.x, z.x), sq_diff(s.y, z.y), sq_diff(s.z, z.z),
                   sq_diff(s.w, z.w), nv);
}

// x / y rounded to the nearest float, __fdiv_rn's value, from r = 1 / y
// in double, computed once for a row.  x r in double is within 2^-52
// (relative) of x / y, and a quotient of two floats lies at least 2^-50
// (relative) from every midpoint of two floats (it is never one), so
// rounding x r to float gives the correctly rounded quotient wherever that
// is a normal float or x is zero; elsewhere (y zero, infinite or NaN, a
// result out of the normal range) __fdiv_rn itself.
__device__ __forceinline__ float div_by(float x, float y, double r) {
  const float f = __double2float_rn(__dmul_rn(static_cast<double>(x), r));
  const float a = fabsf(f);
  return (a >= 0x1p-125f && a < 0x1p127f) || x == 0.0f ? f
                                                       : __fdiv_rn(x, y);
}

// u = (s - z) / norm, element by element; r = 1 / norm in double.
__device__ __forceinline__ float4 unit(float4 s, float4 z, float norm,
                                       double r) {
  return make_float4(div_by(__fsub_rn(s.x, z.x), norm, r),
                     div_by(__fsub_rn(s.y, z.y), norm, r),
                     div_by(__fsub_rn(s.z, z.z), norm, r),
                     div_by(__fsub_rn(s.w, z.w), norm, r));
}

__device__ __forceinline__ float proj_terms(float4 u, float4 z1, float4 z2,
                                            int nv) {
  return chunk_sum(__fmul_rn(u.x, __fsub_rn(z1.x, z2.x)),
                   __fmul_rn(u.y, __fsub_rn(z1.y, z2.y)),
                   __fmul_rn(u.z, __fsub_rn(z1.z, z2.z)),
                   __fmul_rn(u.w, __fsub_rn(z1.w, z2.w)), nv);
}

__device__ __forceinline__ float4 update(float4 s, float4 u, float gp) {
  return make_float4(__fadd_rn(s.x, __fmul_rn(u.x, gp)),
                     __fadd_rn(s.y, __fmul_rn(u.y, gp)),
                     __fadd_rn(s.z, __fmul_rn(u.z, gp)),
                     __fadd_rn(s.w, __fmul_rn(u.w, gp)));
}

template <bool kVec, bool kOneChunk, bool kRungs>
__global__ void __launch_bounds__(kThreadsMax) snooker_propose_kernel(
    const float* __restrict__ coords, float* __restrict__ q,
    float* __restrict__ factor, int ng, int nd, int split, int nsplits,
    int tile, int pair_mode, float gammas, const float* __restrict__ scale,
    float ndim_m1, const float* __restrict__ u4,
    const int* __restrict__ idx, const int* __restrict__ perm, uint32_t k0,
    uint32_t k1, const long long* __restrict__ offset_dev,
    unsigned long long offset_inc, const long long* __restrict__ keys) {
  __shared__ int s_rows[3][kTileMax];  // random mode: rows of z, z1, z2
  __shared__ int s_base[3];            // roll mode: the roles' group bases
  __shared__ int s_sh[3];              //   and shifts

  if constexpr (kRungs) {
    // The rung of this block: its rows, outputs, draws, scale and key.
    const int rung = blockIdx.y;
    coords += static_cast<int64_t>(rung) * nsplits * ng * nd;
    q += static_cast<int64_t>(rung) * ng * nd;
    factor += static_cast<int64_t>(rung) * ng;
    if (u4 != nullptr) u4 += 4 * rung;
    if (idx != nullptr) {
      idx += static_cast<int64_t>(rung) * 3 * ng;
      perm += static_cast<int64_t>(rung) * ng;
    }
    if (scale != nullptr) scale += rung;
    if (keys != nullptr) {
      const auto key = static_cast<unsigned long long>(keys[rung]);
      k0 = static_cast<uint32_t>(key);
      k1 = static_cast<uint32_t>(key >> 32);
    }
  }

  const int t = threadIdx.x;
  const int t0 = blockIdx.x * tile;
  const int cnt = min(tile, ng - t0);

  // -- phase A ------------------------------------------------------------
  if (pair_mode) {
    if (t < cnt) {
      const int i = t0 + t;
      int p0, p1, p2, p;
      if (idx != nullptr) {
        p0 = idx[i];
        p1 = idx[ng + i];
        p2 = idx[2 * ng + i];
        p = perm[i];
      } else {
        const uint4 w = philox_at(
            static_cast<uint32_t>(i),
            static_cast<uint32_t>(split) | EMCEE_PAIR_BLOCK,
            philox_offset(offset_dev, offset_inc), k0, k1);
        const float ngf = static_cast<float>(ng);
        p0 = min(static_cast<int>(__fmul_rn(philox_uniform(w.x), ngf)),
                 ng - 1);
        p1 = min(static_cast<int>(__fmul_rn(philox_uniform(w.y), ngf)),
                 ng - 1);
        p2 = min(static_cast<int>(__fmul_rn(philox_uniform(w.z), ngf)),
                 ng - 1);
        p = min(static_cast<int>(__fmul_rn(philox_uniform(w.w), 6.0f)), 5);
      }
      const int r0 = pick_base(0, split, nsplits, ng) + p0;
      const int r1 = pick_base(1, split, nsplits, ng) + p1;
      const int r2 = pick_base(2, split, nsplits, ng) + p2;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        s_rows[r][t] = sel3(perm_role(p, r), r0, r1, r2);
      }
    }
  } else if (t == 0) {
    float u[4];
    if (u4 != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) u[k] = u4[k];
    } else {
      const uint4 w =
          philox_at(EMCEE_ROLL_LANE, static_cast<uint32_t>(split),
                    philox_offset(offset_dev, offset_inc), k0, k1);
      u[0] = philox_uniform(w.x);
      u[1] = philox_uniform(w.y);
      u[2] = philox_uniform(w.z);
      u[3] = philox_uniform(w.w);
    }
    const int p =
        nsplits > 2 ? min(static_cast<int>(__fmul_rn(u[0], 6.0f)), 5) : 0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int k = perm_role(p, r);
      s_base[r] = pick_base(k, split, nsplits, ng);
      // int(u ng) <= ng, so (i + sh) % ng is one compare and subtract.
      s_sh[r] = static_cast<int>(
          __fmul_rn(sel3(k, u[1], u[2], u[3]), static_cast<float>(ng)));
    }
  }
  __syncthreads();

  // -- phase B: each warp takes walkers of the tile in turn ---------------
  const int lane = t & 31;
  const int n_warps = blockDim.x >> 5;
  const int n_ch = (nd + 3) >> 2;  // 4-float chunks of a row
  const float gam = scale != nullptr ? __fmul_rn(gammas, *scale) : gammas;
  auto n_valid = [&](int c) { return kVec ? 4 : min(4, nd - 4 * c); };
  for (int w = t >> 5; w < cnt; w += n_warps) {  // uniform across the warp
    const int i = t0 + w;
    int rz, r1, r2;
    if (pair_mode) {
      rz = s_rows[0][w];
      r1 = s_rows[1][w];
      r2 = s_rows[2][w];
    } else {
      auto roll_row = [&](int r) {
        int x = i + s_sh[r];
        x -= (x >= ng) ? ng : 0;
        return s_base[r] + x;
      };
      rz = roll_row(0);
      r1 = roll_row(1);
      r2 = roll_row(2);
    }
    // nwalkers * ndim < 2**31 (the wrapper checks), so int offsets.
    const float* s_row = coords + (split * ng + i) * nd;
    const float* z_row = coords + rz * nd;
    const float* z1_row = coords + r1 * nd;
    const float* z2_row = coords + r2 * nd;
    float* q_row = q + i * nd;

    // The lane's first chunk of all four rows, loaded before any sum.
    const bool has0 = lane < n_ch;
    float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), z0 = s0, a0 = s0,
           b0 = s0;
    if (has0) {
      s0 = load_chunk<kVec>(s_row, lane, nd);
      z0 = load_chunk<kVec>(z_row, lane, nd);
      a0 = load_chunk<kVec>(z1_row, lane, nd);
      b0 = load_chunk<kVec>(z2_row, lane, nd);
    }

    float acc = 0.0f;
    if (has0) acc = __fadd_rn(acc, norm_terms(s0, z0, n_valid(lane)));
    for (int c = lane + 32; !kOneChunk && c < n_ch; c += 32) {
      acc = __fadd_rn(acc, norm_terms(load_chunk<kVec>(s_row, c, nd),
                                      load_chunk<kVec>(z_row, c, nd),
                                      n_valid(c)));
    }
    const float norm = __fsqrt_rn(warp_sum(acc));
    const double r_norm = 1.0 / static_cast<double>(norm);

    const float4 u0 = unit(s0, z0, norm, r_norm);
    acc = 0.0f;
    if (has0) acc = __fadd_rn(acc, proj_terms(u0, a0, b0, n_valid(lane)));
    for (int c = lane + 32; !kOneChunk && c < n_ch; c += 32) {
      const float4 u = unit(load_chunk<kVec>(s_row, c, nd),
                            load_chunk<kVec>(z_row, c, nd), norm, r_norm);
      acc = __fadd_rn(acc, proj_terms(u, load_chunk<kVec>(z1_row, c, nd),
                                      load_chunk<kVec>(z2_row, c, nd),
                                      n_valid(c)));
    }
    const float gp = __fmul_rn(gam, warp_sum(acc));

    if (has0) store_chunk<kVec>(q_row, lane, nd, update(s0, u0, gp));
    for (int c = lane + 32; !kOneChunk && c < n_ch; c += 32) {
      const float4 s = load_chunk<kVec>(s_row, c, nd);
      store_chunk<kVec>(q_row, c, nd,
                        update(s, unit(s, load_chunk<kVec>(z_row, c, nd),
                                       norm, r_norm),
                               gp));
    }
    if (lane == 0) {
      factor[i] = __fmul_rn(
          ndim_m1, __fsub_rn(logf(fabsf(__fadd_rn(norm, gp))), logf(norm)));
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/snooker_kernel.py).  Every
// pointer is a device pointer.  Roll mode: u4 (four uniforms) overrides
// the in-kernel draw of the role permutation and shifts.  Random mode: idx
// (3, ng) and perm (ng,) override the in-kernel Philox picks.  The Philox
// offset is *offset_dev + offset (offset alone when offset_dev is null).
// scale == nullptr means untuned.  tile, grid, threads and vec are the
// launch plan of ops/_wrap.py de_plan (threads a multiple of 32, tile <=
// 16); vec != 0 promises ndim % 4 == 0 and 16-byte aligned coords and q.
// ntemps rungs of nsplits * ng walkers lie one after the other in coords
// (ntemps = 1: one ensemble), with u4 (ntemps, 4), idx (ntemps, 3, ng)
// and perm (ntemps, ng); keys == nullptr draws every rung under seed,
// else rung r under keys[r] (a device table of ntemps keys).
// Returns cudaGetLastError() after the launch.
extern "C" int emcee_snooker_propose(
    const float* coords, float* q, float* factor, int ng, int nd, int split,
    int nsplits, int pair_mode, float gammas, const float* scale,
    float ndim_m1, const float* u4, const int* idx, const int* perm,
    int tile, int grid, int threads, int vec, int ntemps,
    const long long* keys, unsigned long long seed,
    const long long* offset_dev, unsigned long long offset, void* stream) {
  // A row of at most 128 floats is one chunk per lane, held in registers.
  const bool one = nd <= 128;
  const bool rungs = ntemps > 1 || keys != nullptr;
  auto kernel =
      vec ? (one ? (rungs ? snooker_propose_kernel<true, true, true>
                          : snooker_propose_kernel<true, true, false>)
                 : (rungs ? snooker_propose_kernel<true, false, true>
                          : snooker_propose_kernel<true, false, false>))
          : (one ? (rungs ? snooker_propose_kernel<false, true, true>
                          : snooker_propose_kernel<false, true, false>)
                 : (rungs ? snooker_propose_kernel<false, false, true>
                          : snooker_propose_kernel<false, false, false>));
  kernel<<<dim3(grid, ntemps), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      coords, q, factor, ng, nd, split, nsplits, tile, pair_mode, gammas,
      scale, ndim_m1, u4, idx, perm, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset_dev, offset, keys);
  return static_cast<int>(cudaGetLastError());
}

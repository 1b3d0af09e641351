// K1: the fused stretch proposal, tiled.
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
// What bounds it on an H100: bytes, and latency.  Per walker it reads 2
// ndim floats and writes ndim + 1; the arithmetic (ten Philox rounds, one
// logf) is far below the card's integer and float32 rates, and there is no
// matrix product, so no tensor-core (wgmma) work exists.  At the main
// path's shape (ng = 50000, ndim = 5) the call moves 3.2 MB, ~1 us at
// 3.35 TB/s, so a launch is bound by latency as much as by HBM.
//
// The first design gave one thread a walker: a runtime-ndim loop over
// 20-byte-strided rows, and in every thread a second Philox block for the
// split's roll draw, the same value in all 50000 threads.  The tiled
// design:
//   * A block owns a tile of `tile` consecutive walkers (ops/_wrap.py
//     tile_plan: two blocks or more for every SM; 128 at the main path's
//     shape) and has one warp more than the tile.
//   * Phase A: each tile thread draws its walker's words, computes z and
//     the factor (written at once) and, in random mode, its partner row,
//     into shared memory.  The spare warp's first lane makes the split's
//     roll draw, once per block, beside them (the tile's warps do not wait
//     for it before their own Philox).
//   * Phase B, after one __syncthreads: a flat loop over the tile's
//     tile*ndim elements.  The own rows s and the output q are contiguous
//     spans: float4 loads and stores where both are 16-byte aligned (kVec,
//     from the plan), scalar coalesced accesses otherwise and for the
//     tail.  Partner rows: in roll mode consecutive walkers take
//     consecutive complement rows (contiguous but for the wrap at nc and
//     the jump over the split's own block), so neighbouring threads read
//     neighbouring addresses; in random mode each element is gathered from
//     its walker's partner row in shared memory.  The partner span is in
//     general not 16-byte aligned (ndim 5, any shift), so it is read by
//     scalar coalesced loads.
//
// The complement map row = r + (r >= split*ng ? ng : 0) is unchanged.
// Arithmetic uses the _rn intrinsics so that nvcc cannot contract a
// multiply and an add into an FMA: every rounding then matches the plain
// PyTorch version (ops/stretch_kernel.py), which evaluates the same
// expression one operation at a time.  logf is the accurate libdevice
// function (no --use_fast_math).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kTileMax = 256;  // TILE_MAX in ops/_wrap.py

template <bool kVec>
__global__ void __launch_bounds__(kTileMax + 32) stretch_propose_kernel(
    const float* __restrict__ coords, float* __restrict__ q,
    float* __restrict__ factor, int ng, int nd, int split, int nc, int tile,
    int pair_mode, float a, float am1, const float* __restrict__ scale,
    float ndim_m1, const float* __restrict__ u_z,
    const float* __restrict__ u_pair, const float* __restrict__ u_shift,
    uint32_t k0, uint32_t k1, const long long* __restrict__ offset_dev,
    unsigned long long offset_inc) {
  __shared__ float s_z[kTileMax];
  __shared__ int s_row[kTileMax];  // random mode: the partner rows
  __shared__ int s_shift;          // roll mode: int(u_s nc) % nc

  const int t = threadIdx.x;
  const int t0 = blockIdx.x * tile;
  const int cnt = min(tile, ng - t0);
  const int lo = split * ng;
  const float ncf = static_cast<float>(nc);

  // -- phase A ------------------------------------------------------------
  if (t < cnt) {
    const int i = t0 + t;
    float uz, up = 0.0f;
    if (u_z != nullptr) {
      uz = u_z[i];
      if (pair_mode) up = u_pair[i];
    } else {
      const uint4 w = philox_at(static_cast<uint32_t>(i),
                                static_cast<uint32_t>(split),
                                philox_offset(offset_dev, offset_inc), k0, k1);
      uz = philox_uniform(w.x);
      up = philox_uniform(w.z);
    }
    float a_eff = a;
    float a_m1 = am1;
    if (scale != nullptr) {
      a_eff = __fadd_rn(1.0f, __fmul_rn(am1, *scale));
      a_m1 = __fsub_rn(a_eff, 1.0f);
    }
    const float tt = __fadd_rn(__fmul_rn(a_m1, uz), 1.0f);
    const float z = __fdiv_rn(__fmul_rn(tt, tt), a_eff);
    factor[i] = __fmul_rn(ndim_m1, logf(z));
    s_z[t] = z;
    if (pair_mode) {
      const int r = min(static_cast<int>(__fmul_rn(up, ncf)), nc - 1);
      s_row[t] = r + (r >= lo ? ng : 0);
    }
  } else if (t == tile && !pair_mode) {
    const float us =
        u_z != nullptr
            ? *u_shift
            : philox_uniform(philox_at(EMCEE_ROLL_LANE,
                                       static_cast<uint32_t>(split),
                                       philox_offset(offset_dev, offset_inc),
                                       k0, k1)
                                 .x);
    s_shift = static_cast<int>(__fmul_rn(us, ncf)) % nc;
  }
  __syncthreads();

  // -- phase B: the tile's elements as one flat stream ----------------------
  const int shift = pair_mode ? 0 : s_shift;
  // Partner row of tile walker w; roll: (t0 + w + shift) % nc, where
  // t0 + w < ng <= nc and shift < nc, then the complement map.
  auto partner = [&](int w) -> int64_t {
    if (pair_mode) return s_row[w];
    int r = t0 + w + shift;
    r -= (r >= nc) ? nc : 0;
    return r + (r >= lo ? ng : 0);
  };
  auto elem = [&](float c, float s, float z) {
    return __fsub_rn(c, __fmul_rn(__fsub_rn(c, s), z));
  };
  const int n = cnt * nd;
  const float* own = coords + static_cast<int64_t>(lo + t0) * nd;
  float* out = q + static_cast<int64_t>(t0) * nd;
  const int n_body = kVec ? (n & ~3) : 0;
  if (kVec) {
    const float4* own4 = reinterpret_cast<const float4*>(own);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int k = t; k < (n_body >> 2); k += blockDim.x) {
      const int e = 4 * k;
      int w = e / nd;
      int d = e - w * nd;
      const float4 s4 = own4[k];
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = elem(coords[partner(w) * nd + d], s[j], s_z[w]);
        if (++d == nd) {
          d = 0;
          ++w;
        }
      }
      out4[k] = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
  for (int e = n_body + t; e < n; e += blockDim.x) {
    const int w = e / nd;
    const int d = e - w * nd;
    out[e] = elem(coords[partner(w) * nd + d], own[e], s_z[w]);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/stretch_kernel.py).  Every
// pointer is a device pointer; u_z == nullptr selects the in-kernel
// Philox stream, otherwise u_z (and u_pair for random mode, u_shift for
// roll mode) are injected.  scale == nullptr means untuned.  The Philox
// offset is *offset_dev + offset (offset alone when offset_dev is null).
// tile, grid and vec are the launch plan of ops/_wrap.py tile_plan (a
// block is tile + 32 threads); vec != 0 promises that every tile's spans
// of coords and q are 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int emcee_stretch_propose(
    const float* coords, float* q, float* factor, int ng, int nd, int split,
    int nsplits, int pair_mode, float a, float am1, const float* scale,
    float ndim_m1, const float* u_z, const float* u_pair,
    const float* u_shift, int tile, int grid, int vec,
    unsigned long long seed, const long long* offset_dev,
    unsigned long long offset, void* stream) {
  const int nc = (nsplits - 1) * ng;
  auto kernel =
      vec ? stretch_propose_kernel<true> : stretch_propose_kernel<false>;
  kernel<<<grid, tile + 32, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, q, factor, ng, nd, split, nc, tile, pair_mode, a, am1, scale,
      ndim_m1, u_z, u_pair, u_shift, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset_dev, offset);
  return static_cast<int>(cudaGetLastError());
}

// K15: the even/odd swap of adjacent rungs of a tempered ladder.
//
// Replaces the XLA-fused chain of emcee_tpu/parallel/tempering.py:543-580
// (PTSampler._swap_step) together with the lax.cond on the step's parity
// and swap_every (:752-796) and the recomputation of the tempered log-prob
// from logL and logP that the next move makes (:480-482).  There is no
// Pallas kernel behind it: XLA fused the chain.  Eager PyTorch would run
// it as some hundred small kernels a proposal (the Philox draw alone is a
// hundred), more than the whole tempered proposal, so it is written by
// hand.
//
// The proposal's step is the chain's proposal counter, *offset_dev +
// offset (a CUDA graph advances the word, so one recording serves every
// replay, whatever parity a replay starts at).  Nothing happens unless
// step % swap_every == swap_every - 1.  The step's parity p pairs rungs
// (lo, lo + 1) for lo = p, p + 2, ... < T - 1.  Per pair and walker w:
//   u      = Philox word 0 at (w, SWAP_BLOCK | lo, step), the chain's key
//                                                         [or injected]
//   acc    = log u < (beta[lo] - beta[lo+1]) (logL[lo+1][w] - logL[lo][w])
//   if acc: exchange the two rungs' coords row, logL and logP of walker w,
//           and set each rung's tempered log-prob to
//           beta logL + logP (-inf where logP is -inf or NaN),
//           each operation rounded once, as the tempered model forms it
//   counts[lo] += the pair's accepted walkers
//
// What bounds it on an H100: latency.  At the tempered workload's shape
// (16 rungs x 256 walkers x 5-D) a swap reads two rungs' logL of every
// pair (8 or 7 pairs) and moves the accepted walkers' rows of 5 floats
// and 3 scalars: some 50 KB, 15 ns at 3.35 TB/s, against a launch floor
// of ~2 us.  So the design is the simple one: one thread a walker of one
// pair (the grid's second dimension is the pair), each thread's own
// walker's rows read and written by that thread only (the pairs of a
// parity are disjoint, so no two threads touch one row), and one
// __syncthreads_count and one 64-bit atomicAdd a block for the count.
// Arithmetic uses the _rn intrinsics and the accurate logf, so the kernel
// equals its plain version (ops/swap_kernel.py) bit for bit.
//
// User blob leaves (emcee_tpu/parallel/tempering.py:573-580 exchanges
// every leaf of (coords, logL, logP, blobs) as one unit): a leaf is any
// dtype of any row shape, (ntemps, nw, ...) in memory, so to the kernel a
// byte row per walker.  Each leaf reaches the kernel as a descriptor in a
// struct passed by value (the buffer's base, the row's bytes and an access
// unit, the largest of 16, 8, 4, 2, 1 bytes that divides both the base and
// the row: ops/swap_kernel.py swap_leaves), so a graph records it with the
// launch.  An accepted walker's thread exchanges its two rows of every
// leaf, unit by unit, beside its coords row.  The leaves' bytes are few
// (workload 4's two leaves: 24 bytes a walker), so the simple design
// holds: no staging, no cooperation between threads.  Without leaves the
// entry point launches the instantiation whose Leaves is NoLeaves, an
// empty struct as the last parameter, and the leaf code is compiled out.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "philox.cuh"

#define EMCEE_SWAP_BLOCK 0x08700000u  // SWAP_BLOCK in ops/philox.py

namespace {

constexpr int kThreads = 128;  // SWAP_THREADS in ops/swap_kernel.py
constexpr int kMaxLeaves = 16;  // SWAP_LEAVES in ops/swap_kernel.py

}  // namespace

// One user blob leaf (the layout of ops/swap_kernel.py _SwapLeaf): the
// buffer (ntemps, nw, *shape), the bytes of one walker's row and the
// access unit in bytes.
struct SwapLeaf {
  unsigned char* base;
  int row_bytes;
  int unit;
};

namespace {

struct SwapLeaves {
  int n;
  SwapLeaf leaf[kMaxLeaves];
};

// The blob-free kernel's Leaves: none.
struct NoLeaves {};

// Exchange rows a and b of a leaf at base with rows of row_bytes, unit by
// unit.
template <typename U>
__device__ __forceinline__ void swap_rows(unsigned char* base, int row_bytes,
                                          int64_t a, int64_t b) {
  const int n = row_bytes / static_cast<int>(sizeof(U));
  U* ra = reinterpret_cast<U*>(base) + a * n;
  U* rb = reinterpret_cast<U*>(base) + b * n;
  for (int i = 0; i < n; ++i) {
    const U x = ra[i];
    ra[i] = rb[i];
    rb[i] = x;
  }
}

// The tempered log-prob beta logL + logP, -inf where logP is not > -inf.
__device__ __forceinline__ float tempered(float beta, float ll, float lpr) {
  return lpr > -CUDART_INF_F ? __fadd_rn(__fmul_rn(beta, ll), lpr)
                             : -CUDART_INF_F;
}

template <typename Leaves>
__global__ void __launch_bounds__(kThreads) pt_swap_kernel(
    float* __restrict__ coords, float* __restrict__ log_like,
    float* __restrict__ log_prior, float* __restrict__ log_prob,
    const float* __restrict__ betas, unsigned long long* __restrict__ counts,
    const float* __restrict__ u, int ntemps, int nw, int nd, int swap_every,
    uint32_t k0, uint32_t k1, const long long* __restrict__ offset_dev,
    unsigned long long offset_inc, const __grid_constant__ Leaves leaves) {
  const uint64_t step = philox_offset(offset_dev, offset_inc);
  if (step % static_cast<uint64_t>(swap_every) !=
      static_cast<uint64_t>(swap_every - 1)) {
    return;  // no swap at this step (the same for every thread)
  }
  const int k = blockIdx.y;  // the pair's place among the parity's pairs
  const int lo = static_cast<int>(step & 1u) + 2 * k;
  if (lo >= ntemps - 1) return;  // the other parity has one pair more
  const int w = blockIdx.x * kThreads + threadIdx.x;
  bool acc = false;
  if (w < nw) {
    const int64_t a = static_cast<int64_t>(lo) * nw + w;
    const int64_t b = a + nw;
    const float ll_lo = log_like[a];
    const float ll_hi = log_like[b];
    const float uu =
        u != nullptr
            ? u[static_cast<int64_t>(k) * nw + w]
            : philox_uniform(philox_at(static_cast<uint32_t>(w),
                                       EMCEE_SWAP_BLOCK |
                                           static_cast<uint32_t>(lo),
                                       step, k0, k1)
                                 .x);
    const float b_lo = betas[lo];
    const float b_hi = betas[lo + 1];
    acc = logf(uu) < __fmul_rn(__fsub_rn(b_lo, b_hi), __fsub_rn(ll_hi, ll_lo));
    if (acc) {
      const float p_lo = log_prior[a];
      const float p_hi = log_prior[b];
      log_like[a] = ll_hi;
      log_like[b] = ll_lo;
      log_prior[a] = p_hi;
      log_prior[b] = p_lo;
      log_prob[a] = tempered(b_lo, ll_hi, p_hi);
      log_prob[b] = tempered(b_hi, ll_lo, p_lo);
      float* ra = coords + a * nd;
      float* rb = coords + b * nd;
      for (int d = 0; d < nd; ++d) {
        const float x = ra[d];
        ra[d] = rb[d];
        rb[d] = x;
      }
      if constexpr (std::is_same_v<Leaves, SwapLeaves>) {
        for (int l = 0; l < leaves.n; ++l) {
          // The fields by value: the descriptor stays in parameter space.
          unsigned char* base = leaves.leaf[l].base;
          const int rb = leaves.leaf[l].row_bytes;
          switch (leaves.leaf[l].unit) {
            case 16: swap_rows<uint4>(base, rb, a, b); break;
            case 8: swap_rows<uint2>(base, rb, a, b); break;
            case 4: swap_rows<uint32_t>(base, rb, a, b); break;
            case 2: swap_rows<uint16_t>(base, rb, a, b); break;
            default: swap_rows<uint8_t>(base, rb, a, b); break;
          }
        }
      }
    }
  }
  const int n = __syncthreads_count(acc);
  if (threadIdx.x == 0 && n > 0) {
    atomicAdd(counts + lo, static_cast<unsigned long long>(n));
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/swap_kernel.py).  Every
// pointer but `leaves` is a device pointer: coords (ntemps, nw, nd),
// log_like, log_prior and log_prob (ntemps, nw), betas (ntemps,) float32,
// counts (ntemps - 1,) int64; u == nullptr draws the uniforms in the
// kernel, otherwise u is (ntemps / 2, nw) with row k the uniforms of the
// parity's k-th pair.  The step is *offset_dev + offset (offset alone when
// offset_dev is null); swap_every >= 1.  `leaves` is a host array of
// `nleaves` (at most kMaxLeaves) user blob leaf descriptors, each with
// row_bytes > 0; it is copied into the launch's parameters.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, and no
// launch, for more than kMaxLeaves leaves).
extern "C" int emcee_pt_swap(float* coords, float* log_like,
                             float* log_prior, float* log_prob,
                             const float* betas, long long* counts,
                             const float* u, int ntemps, int nw, int nd,
                             int swap_every, unsigned long long seed,
                             const long long* offset_dev,
                             unsigned long long offset,
                             const SwapLeaf* leaves, int nleaves,
                             void* stream) {
  if (nleaves < 0 || nleaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nw + kThreads - 1) / kThreads, ntemps / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* cnt = reinterpret_cast<unsigned long long*>(counts);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  if (nleaves == 0) {
    pt_swap_kernel<NoLeaves><<<grid, kThreads, 0, st>>>(
        coords, log_like, log_prior, log_prob, betas, cnt, u, ntemps, nw, nd,
        swap_every, k0, k1, offset_dev, offset, NoLeaves{});
  } else {
    SwapLeaves table{};
    table.n = nleaves;
    for (int l = 0; l < nleaves; ++l) table.leaf[l] = leaves[l];
    pt_swap_kernel<SwapLeaves><<<grid, kThreads, 0, st>>>(
        coords, log_like, log_prior, log_prob, betas, cnt, u, ntemps, nw, nd,
        swap_every, k0, k1, offset_dev, offset, table);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// and 3 scalars: some 200 KB, 0.06 us at 3.35 TB/s, against a launch
// floor of ~1.3-1.5 us.  What a launch waits for is its chain of trips to
// memory, so the design cuts the chain to one trip before the stores:
//   * Block (x, k) of the grid handles walkers of pair k of either parity,
//     so it touches only rungs 2k, 2k + 1 and 2k + 2.  Each thread loads
//     its walker's logL, logP, beta and coords row (up to kRowRegs floats)
//     of all three and the register leaves' rows before the offset word
//     returns: none of it depends on the parity.
//   * The Philox block is computed as soon as the step is known; after the
//     decision only the stores remain, from registers (the parity picks
//     the pair among the three rungs by selects, never by a run-time
//     index, so nothing goes to local memory).
//   * User blob leaves: up to kRegLeaves leaves whose rows are one 4- or
//     8-byte unit U (Leaves<U>'s `reg`) load with the rest, their bases
//     read at static offsets of the launch's parameters.  The other leaves
//     (`table`) are copied to shared memory once a block, then an
//     accepted walker's thread exchanges their rows unit by unit after the
//     decision (the largest of 16, 8, 4, 2, 1 bytes dividing the base and
//     the row, ops/swap_kernel.py swap_leaves).  No descriptor is read
//     with a run-time index into the launch's parameters.
//   * Small blocks (ops/swap_kernel.py swap_plan): at workload 4's shape a
//     block of 32 threads, so 64 SMs each carry one and issue their loads
//     at once, and a warp vote (no block barrier) counts the accepted.
//   * No local memory: with __launch_bounds__(kMaxThreads) alone ptxas
//     held the register-leaf kernels to 56 and 64 registers and spilled
//     12 and 16 bytes; a minimum of one block an SM lets them take the
//     70 and 80 they need (a block is at most 128 threads, so occupancy
//     is not what limits this kernel).
// Arithmetic uses the _rn intrinsics and the accurate logf, so the kernel
// equals its plain version (ops/swap_kernel.py) bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "philox.cuh"

#define EMCEE_SWAP_BLOCK 0x08700000u  // SWAP_BLOCK in ops/philox.py

namespace {

constexpr int kMaxThreads = 128;  // SWAP_THREADS_MAX in ops/swap_kernel.py
constexpr int kMaxLeaves = 16;    // SWAP_LEAVES in ops/swap_kernel.py
constexpr int kRegLeaves = 4;     // SWAP_REG_LEAVES in ops/swap_kernel.py
constexpr int kRowRegs = 8;       // SWAP_ROW_REGS in ops/swap_kernel.py

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

// The leaves of a launch: `reg` leaves of one U a row through registers
// (none for U = NoRegs), `table` leaves through shared memory.
struct NoRegs {};

template <typename U>
struct Leaves {
  int n_reg;
  int n_table;
  U* reg[kRegLeaves];
  SwapLeaf table[kMaxLeaves];
};

// The blob-free kernel's leaves: none.
struct NoLeaves {};

template <typename L>
struct LeafTraits {
  using Reg = NoRegs;
  static constexpr bool kAny = false;
};

template <typename U>
struct LeafTraits<Leaves<U>> {
  using Reg = U;
  static constexpr bool kAny = true;
};

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

template <typename L>
__global__ void __launch_bounds__(kMaxThreads, 1) pt_swap_kernel(
    float* __restrict__ coords, float* __restrict__ log_like,
    float* __restrict__ log_prior, float* __restrict__ log_prob,
    const float* __restrict__ betas, unsigned long long* __restrict__ counts,
    const float* __restrict__ u, int ntemps, int nw, int nd, int swap_every,
    uint32_t k0, uint32_t k1, const long long* __restrict__ offset_dev,
    unsigned long long offset_inc, const __grid_constant__ L leaves) {
  using Reg = typename LeafTraits<L>::Reg;
  constexpr bool kRegs = !std::is_same_v<Reg, NoRegs>;
  // The table leaves' descriptors, copied from static parameter offsets.
  __shared__ SwapLeaf table[LeafTraits<L>::kAny ? kMaxLeaves : 1];
  if constexpr (LeafTraits<L>::kAny) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < kMaxLeaves; ++i) {
        if (i < leaves.n_table) table[i] = leaves.table[i];
      }
    }
    __syncthreads();
  }
  // Issued first; everything below up to its use does not depend on it.
  const uint64_t step = philox_offset(offset_dev, offset_inc);
  const int k = blockIdx.y;  // the pair's place among the parity's pairs
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < nw;
  const bool has2 = 2 * k + 2 < ntemps;  // rung 2k + 2 exists
  const int64_t i0 = static_cast<int64_t>(2 * k) * nw + w;
  const int64_t rung[3] = {i0, i0 + nw, i0 + 2 * static_cast<int64_t>(nw)};
  float ll[3] = {0.0f, 0.0f, 0.0f}, lpr[3] = {0.0f, 0.0f, 0.0f};
  float beta[3] = {0.0f, 0.0f, 0.0f}, x[3][kRowRegs];
  using RegWord = std::conditional_t<kRegs, Reg, uint32_t>;
  RegWord rv[3][kRegs ? kRegLeaves : 1];
  const bool row_regs = nd <= kRowRegs;
  if (live) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (r < 2 || has2) {
        ll[r] = log_like[rung[r]];
        lpr[r] = log_prior[rung[r]];
        beta[r] = betas[2 * k + r];
        if (row_regs) {
          const float* row = coords + rung[r] * nd;
#pragma unroll
          for (int d = 0; d < kRowRegs; ++d) {
            if (d < nd) x[r][d] = row[d];
          }
        }
        if constexpr (kRegs) {
#pragma unroll
          for (int l = 0; l < kRegLeaves; ++l) {
            if (l < leaves.n_reg) rv[r][l] = leaves.reg[l][rung[r]];
          }
        }
      }
    }
  }
  if (step % static_cast<uint64_t>(swap_every) !=
      static_cast<uint64_t>(swap_every - 1)) {
    return;  // no swap at this step (the same for every thread)
  }
  const int p = static_cast<int>(step & 1u);
  const int lo = p + 2 * k;
  if (lo >= ntemps - 1) return;  // the other parity has one pair more
  bool acc = false;
  if (live) {
    float uu;
    if (u != nullptr) {
      uu = u[static_cast<int64_t>(k) * nw + w];  // rows: the parity's pairs
    } else {
      uu = philox_uniform(philox_at(static_cast<uint32_t>(w),
                                    EMCEE_SWAP_BLOCK | static_cast<uint32_t>(lo),
                                    step, k0, k1)
                              .x);
    }
    // The pair is rungs (0, 1) or (1, 2) of the three: selects, no index.
    const float ll_lo = p ? ll[1] : ll[0], ll_hi = p ? ll[2] : ll[1];
    const float b_lo = p ? beta[1] : beta[0], b_hi = p ? beta[2] : beta[1];
    acc = logf(uu) < __fmul_rn(__fsub_rn(b_lo, b_hi), __fsub_rn(ll_hi, ll_lo));
    if (acc) {
      const int64_t a = p ? rung[1] : rung[0];
      const int64_t b = a + nw;
      const float p_lo = p ? lpr[1] : lpr[0], p_hi = p ? lpr[2] : lpr[1];
      log_like[a] = ll_hi;
      log_like[b] = ll_lo;
      log_prior[a] = p_hi;
      log_prior[b] = p_lo;
      log_prob[a] = tempered(b_lo, ll_hi, p_hi);
      log_prob[b] = tempered(b_hi, ll_lo, p_lo);
      float* ra = coords + a * nd;
      float* rb = coords + b * nd;
      if (row_regs) {
#pragma unroll
        for (int d = 0; d < kRowRegs; ++d) {
          if (d < nd) {
            ra[d] = p ? x[2][d] : x[1][d];
            rb[d] = p ? x[1][d] : x[0][d];
          }
        }
      } else {
        for (int d = 0; d < nd; ++d) {
          const float v = ra[d];
          ra[d] = rb[d];
          rb[d] = v;
        }
      }
      if constexpr (kRegs) {
#pragma unroll
        for (int l = 0; l < kRegLeaves; ++l) {
          if (l < leaves.n_reg) {
            leaves.reg[l][a] = p ? rv[2][l] : rv[1][l];
            leaves.reg[l][b] = p ? rv[1][l] : rv[0][l];
          }
        }
      }
      if constexpr (LeafTraits<L>::kAny) {
        for (int l = 0; l < leaves.n_table; ++l) {
          unsigned char* base = table[l].base;
          const int rbytes = table[l].row_bytes;
          switch (table[l].unit) {
            case 16: swap_rows<uint4>(base, rbytes, a, b); break;
            case 8: swap_rows<uint2>(base, rbytes, a, b); break;
            case 4: swap_rows<uint32_t>(base, rbytes, a, b); break;
            case 2: swap_rows<uint16_t>(base, rbytes, a, b); break;
            default: swap_rows<uint8_t>(base, rbytes, a, b); break;
          }
        }
      }
    }
  }
  // Every warp is whole (blockDim.x a multiple of 32) and reaches the vote.
  const unsigned votes = __ballot_sync(0xffffffffu, acc);
  if ((threadIdx.x & 31) == 0 && votes != 0u) {
    atomicAdd(counts + lo, static_cast<unsigned long long>(__popc(votes)));
  }
}

template <typename L>
void launch(dim3 grid, int threads, cudaStream_t st, float* coords,
            float* log_like, float* log_prior, float* log_prob,
            const float* betas, unsigned long long* cnt, const float* u,
            int ntemps, int nw, int nd, int swap_every, uint32_t k0,
            uint32_t k1, const long long* offset_dev,
            unsigned long long offset, const L& leaves) {
  pt_swap_kernel<L><<<grid, threads, 0, st>>>(
      coords, log_like, log_prior, log_prob, betas, cnt, u, ntemps, nw, nd,
      swap_every, k0, k1, offset_dev, offset, leaves);
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/swap_kernel.py).  Every
// pointer but `leaves` is a device pointer: coords (ntemps, nw, nd),
// log_like, log_prior and log_prob (ntemps, nw), betas (ntemps,) float32,
// counts (ntemps - 1,) int64; u == nullptr draws the uniforms in the
// kernel, otherwise u is (ntemps / 2, nw) with row k the uniforms of the
// parity's k-th pair.  The step is *offset_dev + offset (offset alone when
// offset_dev is null); swap_every >= 1.  `threads` (a multiple of 32 up to
// kMaxThreads) is the block's size.  `leaves` is a host array of
// `nleaves` (at most kMaxLeaves) user blob leaf descriptors, each with
// row_bytes > 0, the first `n_reg` of which (at most kRegLeaves) have rows
// of one `reg_unit` (4 or 8) bytes at a base aligned to it and go through
// registers; they are copied into the launch's parameters.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, and no
// launch, for arguments out of range).
extern "C" int emcee_pt_swap(float* coords, float* log_like,
                             float* log_prior, float* log_prob,
                             const float* betas, long long* counts,
                             const float* u, int ntemps, int nw, int nd,
                             int swap_every, int threads,
                             unsigned long long seed,
                             const long long* offset_dev,
                             unsigned long long offset,
                             const SwapLeaf* leaves, int nleaves, int n_reg,
                             int reg_unit, void* stream) {
  if (nleaves < 0 || nleaves - n_reg > kMaxLeaves || n_reg < 0 ||
      n_reg > kRegLeaves || n_reg > nleaves ||
      (n_reg > 0 && reg_unit != 4 && reg_unit != 8) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nw + threads - 1) / threads, ntemps / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* cnt = reinterpret_cast<unsigned long long*>(counts);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#define EMCEE_SWAP_ARGS                                                   \
  grid, threads, st, coords, log_like, log_prior, log_prob, betas, cnt, u, \
      ntemps, nw, nd, swap_every, k0, k1, offset_dev, offset
  if (nleaves == 0) {
    launch(EMCEE_SWAP_ARGS, NoLeaves{});
  } else if (n_reg > 0 && reg_unit == 8) {
    Leaves<unsigned long long> l{};
    l.n_reg = n_reg;
    l.n_table = nleaves - n_reg;
    for (int i = 0; i < n_reg; ++i) {
      l.reg[i] = reinterpret_cast<unsigned long long*>(leaves[i].base);
    }
    for (int i = n_reg; i < nleaves; ++i) l.table[i - n_reg] = leaves[i];
    launch(EMCEE_SWAP_ARGS, l);
  } else if (n_reg > 0) {
    Leaves<uint32_t> l{};
    l.n_reg = n_reg;
    l.n_table = nleaves - n_reg;
    for (int i = 0; i < n_reg; ++i) {
      l.reg[i] = reinterpret_cast<uint32_t*>(leaves[i].base);
    }
    for (int i = n_reg; i < nleaves; ++i) l.table[i - n_reg] = leaves[i];
    launch(EMCEE_SWAP_ARGS, l);
  } else {
    Leaves<NoRegs> l{};
    l.n_reg = 0;
    l.n_table = nleaves;
    for (int i = 0; i < nleaves; ++i) l.table[i] = leaves[i];
    launch(EMCEE_SWAP_ARGS, l);
  }
#undef EMCEE_SWAP_ARGS
  return static_cast<int>(cudaGetLastError());
}

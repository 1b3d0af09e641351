// K20: the blended move's choice and select, for one ensemble or for
// every rung of a ladder at once.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/blended.py:87-120
// (jax.random.choice over the weights, then jnp.stack(qs)[idx] and
// jnp.stack(fs)[idx]), vmapped over a ladder's rungs by
// emcee_tpu/parallel/tempering.py:538.  There is no Pallas kernel behind
// it.  The port ran it as plain torch: a K14 launch for every split's
// choice, a compare-and-add a CDF point, and a torch.where pair a
// sub-move.  The plain version is ops/blend_kernel.py blend_select_plain;
// the kernel equals it bit for bit (the choice compares the same float32
// CDF points, and the select copies bytes).
//
// blend_select_kernel: the grid's second dimension is the rung r.  Thread
// 0 of a block draws the split's uniform u, word 0 at (ROLL_LANE,
// BLEND_BLOCK | split, offset) under the rung's key (or reads the injected
// choice), and counts the CDF points c_j <= u: the chosen sub-move k.  An
// injected choice outside [0, n) selects sub-move 0, as the plain
// version's where chain leaves it.  Then every thread of the block copies
// elements of sub-move k's q rows (ng * nd floats of the rung) and its
// factor (ng floats, or one value broadcast) into the outputs, a grid
// stride apart.
//
// What bounds it on an H100: the bytes, the chosen q and factor read once
// and written once (4.4 MB at 1e5 x 5, ~1.3 us at 3.35 TB/s).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

#define EMCEE_BLEND_BLOCK 0x08000000u

// The sub-moves one launch chooses among, at most (ops/blend_kernel.py
// MAX_MOVES).
#define EMCEE_BLEND_MAX 16

// The arguments of the entry point (ops/blend_kernel.py _Args, field for
// field).  Declared outside the anonymous namespace: the C entry point
// takes it.
struct BlendArgs {
  const float* q[EMCEE_BLEND_MAX];  // each (ntemps, ng, nd)
  const float* f[EMCEE_BLEND_MAX];  // each (ntemps, ng), or one value
  float cdf[EMCEE_BLEND_MAX - 1];   // the CDF points, float32
  float* q_out;                     // (ntemps, ng, nd)
  float* f_out;                     // (ntemps, ng)
  const long long* choice_in;       // (ntemps,), or null
  const long long* offset_dev;
  const long long* keys;            // the rungs' key table, or null
  unsigned long long offset_inc, seed;
  int f_scalar;                     // bit k: sub-move k's factor is one value
  int k, ng, nd, ntemps, split;
  int choice;                       // an injected choice, or -1
  int threads, blocks;
};

namespace {

__global__ void __launch_bounds__(256) blend_select_kernel(BlendArgs a) {
  __shared__ int pick;
  const int rung = blockIdx.y;
  if (threadIdx.x == 0) {
    int c;
    if (a.choice_in != nullptr) {
      const long long v = a.choice_in[rung];
      c = v < 0 || v >= a.k ? 0 : static_cast<int>(v);
    } else if (a.choice >= 0) {
      c = a.choice < a.k ? a.choice : 0;
    } else {
      unsigned long long key = a.seed;
      if (a.keys != nullptr)
        key = static_cast<unsigned long long>(a.keys[rung]);
      const uint4 w = philox_at(
          EMCEE_ROLL_LANE, EMCEE_BLEND_BLOCK | static_cast<uint32_t>(a.split),
          philox_offset(a.offset_dev, a.offset_inc),
          static_cast<uint32_t>(key), static_cast<uint32_t>(key >> 32));
      const float u = philox_uniform(w.x);
      c = 0;
      for (int j = 0; j < a.k - 1; ++j) c += u >= a.cdf[j] ? 1 : 0;
    }
    pick = c;
  }
  __syncthreads();
  const int c = pick;
  const int64_t n = static_cast<int64_t>(a.ng) * a.nd;
  const float* __restrict__ src = a.q[c] + rung * n;
  float* __restrict__ dst = a.q_out + rung * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (int64_t e = first; e < n; e += stride) dst[e] = src[e];
  const bool scalar = (a.f_scalar >> c) & 1;
  const float* fs = a.f[c] + (scalar ? 0 : static_cast<int64_t>(rung) * a.ng);
  float* fd = a.f_out + static_cast<int64_t>(rung) * a.ng;
  for (int64_t e = first; e < a.ng; e += stride) fd[e] = fs[scalar ? 0 : e];
}

}  // namespace

extern "C" int emcee_blend_select(const BlendArgs* a, void* stream) {
  if (a->threads < 32 || a->threads > 256 || a->blocks < 1 || a->k < 2 ||
      a->k > EMCEE_BLEND_MAX || a->ng < 1 || a->nd < 1 || a->ntemps < 1 ||
      a->ntemps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  blend_select_kernel<<<dim3(a->blocks, a->ntemps), a->threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

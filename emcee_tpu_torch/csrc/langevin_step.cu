// K11: the Langevin step / momentum draw of the gradient moves.
//
// Replaces the XLA-fused chains of emcee_tpu/moves/gradient.py:218-225
// (MALAMove.propose: the normal draw and the preconditioned Langevin
// proposal), :301-312 (HMCMove's step-size jitter and momenta), :483
// (ChEESHMCMove's momenta), :652 (EnsembleMALAMove's noise) and :727-740
// (EnsembleHMCMove's jitter and momenta).  The
// JAX package has no Pallas kernel here: XLA fused the chain into the
// step's program; eager PyTorch would run the Philox normals alone as ~100
// launches (ops/philox.py normals).
//
// Per row r (rows row0 .. row0 + n - 1 of the stream) and column pair k
// (columns 2k, 2k + 1):
//   w        = Philox words at (row0 + r, NORMAL_BLOCK | k, offset)
//   z[2k]    = Box-Muller of words 0 and 2, z[2k + 1] of words 1 and 3
//                                               [or read from z_in]
//   MALA mode (x given), per column j:
//     c      = 0.5 (eps eps)
//     gd     = (g d_j) d_j,   zd = z d_j        [d null: g, z]
//     q      = (x + c gd) + eps zd
//   with v_out given, once (block 0, thread 0):
//     v      = 2 u - 1, u the uniform of word 0 at (ROLL_LANE, v_block,
//              offset): the HMC moves' step-size jitter of the proposal
//              (ops/philox.py grad_uniform), drawn beside its momenta
// The ops/philox.py normals words and Box-Muller, so the plain version
// (ops/langevin_kernel.py) draws with normals() itself.  With z_in given
// nothing is drawn: the parity mode, and the full preconditioners' second
// pass (g = (g L) L^T, z_in = z L^T, d null), whose products by L are
// torch.matmul calls between two launches.
//
// What bounds it on an H100: bytes.  In MALA mode at 1e5 x 5 float32 it
// reads x and g and writes z and q, 8 MB (2.39 us at 3.35 TB/s).  The
// function needs few instructions: a Philox block a column pair (ten
// rounds of two 32 x 32 -> 64-bit multiplies and two xors) and a
// Box-Muller normal a column (a log, a sqrt and a cos as special
// functions, and a few multiplies), about 0.6 us at the card's issue
// rate for the 3e5 items (chip_smoke.py counts them).  The compiled loop
// issues about four times as many: the accurate logf and cosf and the
// IEEE sqrt that the stream's bit-for-bit parity requires expand to many
// instructions each (about 250 an item, some 2.2 us; PERF.md).  None of
// it is float32 FMA work, so the float32 rate is not the yardstick.
//
// The first design gave each (row, pair) a thread of its own: 1172
// blocks of 256 at 1e5 x 5, about 1.1 waves of the card, so the last
// blocks ran alone; each thread divided a 64-bit index, read eps and the
// offset, ran the ten rounds' key schedule, and drew its second normal
// in a branch after the first.  This one:
//   * A block owns `tile` consecutive rows, and the grid is one wave: the
//     launch plan (ops/langevin_kernel.py langevin_plan) spreads the rows
//     evenly over kMinBlocks blocks an SM (__launch_bounds__ holds the
//     registers to that), the fastest of a sweep of 2-8.
//   * A thread walks the tile's (row, pair) items in steps of the block's
//     width with 32-bit indices: the step's rows and pairs are computed
//     once, so no item needs a division.
//   * eps, c, the Philox offset and the ten rounds' keys are made once a
//     thread, before its loop (the keys held in registers); an item issues
//     its loads of x, g (and z_in, d) before its Philox block, so they are
//     in flight while it draws.
//   * Both normals of a pair are drawn without a branch, so their two
//     chains interleave; the last pair of an odd row draws one it does not
//     store.  Drawing that row's last column in a loop of its own saves
//     those instructions but reads and writes the column at a stride of a
//     row, which was slower in MALA mode.
//   * The mode is a template argument, so each item's code is straight.
// The accesses stay 4-byte: a warp's items are consecutive pairs, so its
// two loads of x (columns 2k and 2k + 1) touch the same sectors, and at
// odd ndim no pair can be read as one 8-byte access anyway.  Device
// memory moves whole sectors either way; vector accesses would save
// only a few of the instructions an item.  What holds it above its bound
// is the instructions it issues: the draw alone, with 2 MB of stores,
// takes nearly as long as the MALA step, and the instruction and byte
// times overlap only in part.
//
// The rung axis (parallel tempering: emcee_tpu/parallel/tempering.py:538
// vmaps these chains over the ladder): kRungs launches every rung of a
// ladder at once, the grid's second dimension the rung.  Rung r's rows
// of x, g, z and q lie one after the other (n * nd floats a rung), it
// reads its own eps[r] and writes its own jitter v_out[r], and draws
// under its own key keys[r] (the device table of ops/philox.py RungKeys)
// at the one-ensemble counters (its rows row0 .. row0 + n - 1), so each
// rung equals the one-ensemble launch under its key.  The launch plan
// spreads every rung's rows over one wave (langevin_plan with rungs).
// The one-ensemble instantiations (kRungs false) compile to the same
// code as before the axis: the new kernel parameter comes last and every
// use of it is under kRungs.
//
// Arithmetic uses the _rn intrinsics so that nvcc cannot contract a
// multiply and an add into an FMA: every rounding matches the plain
// version bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

#define EMCEE_NORMAL_BLOCK 0x40000000u

namespace {

constexpr int kThreads = 256;  // LANGEVIN_THREADS in ops/langevin_kernel.py
constexpr int kMinBlocks = 3;  // LANGEVIN_BLOCKS_PER_SM, likewise

template <bool kDiag>
__device__ __forceinline__ float mala_elem(float x, float g, float z,
                                           float dj, float e, float c) {
  if (kDiag) {
    g = __fmul_rn(__fmul_rn(g, dj), dj);
    z = __fmul_rn(z, dj);
  }
  return __fadd_rn(__fadd_rn(x, __fmul_rn(c, g)), __fmul_rn(e, z));
}

// kDraw: z drawn (and written to z_out), else read from z_in; kMala: q
// made from x and g; kDiag: d applied (MALA mode only); kRungs: the rung
// axis, rung blockIdx.y.
template <bool kDraw, bool kMala, bool kDiag, bool kRungs>
__global__ void __launch_bounds__(kThreads, kMinBlocks) langevin_step_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ d, const float* __restrict__ eps,
    const float* __restrict__ z_in, float* __restrict__ z_out,
    float* __restrict__ q, float* __restrict__ v_out, uint32_t v_block,
    int n, int nd, int tile, uint32_t row0, uint32_t k0, uint32_t k1,
    const long long* __restrict__ offset_dev,
    unsigned long long offset_inc, const long long* __restrict__ keys) {
  if constexpr (kRungs) {
    // The rung of this block: its rows, eps, jitter and key.
    const int rung = blockIdx.y;
    const int64_t at = static_cast<int64_t>(rung) * n * nd;
    if constexpr (kMala) {
      x += at;
      g += at;
      q += at;
      eps += rung;
    }
    if constexpr (kDraw) {
      z_out += at;
    } else {
      z_in += at;
    }
    if (v_out != nullptr) v_out += rung;
    if (keys != nullptr) {
      const auto key = static_cast<unsigned long long>(keys[rung]);
      k0 = static_cast<uint32_t>(key);
      k1 = static_cast<uint32_t>(key >> 32);
    }
  }
  const int t = threadIdx.x;
  if (v_out != nullptr && blockIdx.x == 0 && t == 0) {
    const uint4 w = philox_at(EMCEE_ROLL_LANE, v_block,
                              philox_offset(offset_dev, offset_inc), k0, k1);
    *v_out = __fsub_rn(__fmul_rn(philox_uniform(w.x), 2.0f), 1.0f);
  }
  if constexpr (kDraw || kMala) {
    // Rows [r_lo, r_lo + rows) of the launch, a span of rows * nd floats
    // from element r_lo * nd; items are (row, pair) in row-major order.
    const int r_lo = blockIdx.x * tile;
    const int rows = min(tile, n - r_lo);
    const int npairs = (nd + 1) >> 1;
    const int items = rows * npairs;
    const int64_t base = static_cast<int64_t>(r_lo) * nd;
    uint64_t off = 0;
    PhiloxKeys keys;
    if constexpr (kDraw) {
      off = philox_offset(offset_dev, offset_inc);
      keys = philox_keys(k0, k1);
      // Keep the keys in registers: without this nvcc recomputes them on
      // the uniform datapath in every trip, 26 more instructions an item.
#pragma unroll
      for (int rr = 0; rr < 10; ++rr) {
        asm volatile("" : "+r"(keys.k0[rr]), "+r"(keys.k1[rr]));
      }
      z_out += base;
    } else {
      z_in += base;
    }
    float e = 0.0f, c = 0.0f;
    if constexpr (kMala) {
      x += base;
      g += base;
      q += base;
      e = *eps;
      c = __fmul_rn(0.5f, __fmul_rn(e, e));
    }
    // Item i = t + s * kThreads is pair k of the tile's row r; a step
    // moves (r, k) by (dr, dk).
    int r = t / npairs;
    int k = t - r * npairs;
    const int dr = kThreads / npairs;
    const int dk = kThreads - dr * npairs;
    for (int i = t; i < items; i += kThreads) {
      const int j = 2 * k;
      const int at = r * nd + j;
      const bool two = j + 1 < nd;
      float x0 = 0.0f, x1 = 0.0f, g0 = 0.0f, g1 = 0.0f;
      float d0 = 1.0f, d1 = 1.0f, z0, z1 = 0.0f;
      if constexpr (kMala) {
        x0 = x[at];
        g0 = g[at];
        if (two) {
          x1 = x[at + 1];
          g1 = g[at + 1];
        }
        if constexpr (kDiag) {
          d0 = d[j];
          if (two) d1 = d[j + 1];
        }
      }
      if constexpr (kDraw) {
        const uint4 w = philox4x32_10(
            make_uint4(row0 + static_cast<uint32_t>(r_lo + r),
                       EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(k),
                       static_cast<uint32_t>(off),
                       static_cast<uint32_t>(off >> 32)),
            keys);
        // Both normals, unconditionally: the two chains interleave (the
        // last pair of an odd row draws one it does not store).
        z0 = philox_normal(w.x, w.z);
        z1 = philox_normal(w.y, w.w);
        z_out[at] = z0;
        if (two) z_out[at + 1] = z1;
      } else {
        z0 = z_in[at];
        if (two) z1 = z_in[at + 1];
      }
      if constexpr (kMala) {
        q[at] = mala_elem<kDiag>(x0, g0, z0, d0, e, c);
        if (two) q[at + 1] = mala_elem<kDiag>(x1, g1, z1, d1, e, c);
      }
      k += dk;
      r += dr;
      if (k >= npairs) {
        k -= npairs;
        ++r;
      }
    }
  }
}

using LangevinKernel = void (*)(const float*, const float*, const float*,
                                const float*, const float*, float*, float*,
                                float*, uint32_t, int, int, int, uint32_t,
                                uint32_t, uint32_t, const long long*,
                                unsigned long long, const long long*);

// The instantiation of a mode.
template <bool kRungs>
LangevinKernel langevin_step_mode(bool draw, bool mala, bool diag) {
  return !mala ? (draw ? langevin_step_kernel<true, false, false, kRungs>
                       : langevin_step_kernel<false, false, false, kRungs>)
         : draw ? (diag ? langevin_step_kernel<true, true, true, kRungs>
                        : langevin_step_kernel<true, true, false, kRungs>)
                : (diag ? langevin_step_kernel<false, true, true, kRungs>
                        : langevin_step_kernel<false, true, false, kRungs>);
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/langevin_kernel.py).  Every
// pointer is a device pointer.  x == nullptr selects draw-only mode (z_out
// written, g, d, eps and q unused); z_in != nullptr reads z instead of
// drawing (z_out unused); d == nullptr is the identity preconditioner;
// v_out != nullptr also writes the jitter's v of block v_block (n may then
// be 0).  tile and grid are the launch plan of ops/langevin_kernel.py
// langevin_plan: block b takes rows [b * tile, min((b + 1) * tile, n))
// of every rung.  ntemps rungs of n rows lie one after the other in x, g,
// z and q, with eps and v_out (ntemps,) (ntemps = 1: one ensemble, eps
// and v_out one float each); keys == nullptr draws every rung under
// seed, else rung r under keys[r] (a device table of ntemps keys).  The
// Philox offset is *offset_dev + offset (offset alone when offset_dev is
// null).  Returns cudaGetLastError() after the launch.
extern "C" int emcee_langevin_step(
    const float* x, const float* g, const float* d, const float* eps,
    const float* z_in, float* z_out, float* q, float* v_out,
    unsigned int v_block, int n, int nd, int row0, int tile, int grid,
    int ntemps, const long long* keys, unsigned long long seed,
    const long long* offset_dev, unsigned long long offset, void* stream) {
  const bool draw = z_in == nullptr;
  const bool mala = x != nullptr;
  const bool diag = d != nullptr;
  const bool rungs = ntemps > 1 || keys != nullptr;
  auto kernel = rungs ? langevin_step_mode<true>(draw, mala, diag)
                      : langevin_step_mode<false>(draw, mala, diag);
  kernel<<<dim3(grid, ntemps), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      x, g, d, eps, z_in, z_out, q, v_out, v_block, n, nd, tile,
      static_cast<uint32_t>(row0), static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), offset_dev, offset, keys);
  return static_cast<int>(cudaGetLastError());
}

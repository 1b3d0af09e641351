// K7: the KDE log-density of KDEMove, with no distance matrix.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/kde.py:89-106
// (KDEMove._logpdf): two triangular solves whiten the rows and the
// kernels, one matmul forms the ns x nc cross term of the squared
// distances, and a logsumexp reduces every row over the kernels.  The JAX
// package has no Pallas kernel here: XLA fused the chain around the MXU
// product, writing the ns x nc matrix.  The whitening stays a
// torch.linalg.solve_triangular before this kernel (both routes consume
// the same whitened rows); the kernel is everything after it.
//
// Per row x'_i (whitened) of rung r, over the whitened kernels c'_j of the
// same rung, j = 0 .. nc - 1:
//   x2   = sum_k x'_ik x'_ik,  c2_j = sum_k c'_jk c'_jk,
//   dot  = sum_k x'_ik c'_jk                  (each sum from +0.0, k in order)
//   a_ij = -0.5 ((x2 + c2_j) - 2 dot)          (the JAX formula's order)
//   out  = (m_i + log s_i) - lognorm[r],  (m_i, s_i) = logsumexp_j a_ij
// lognorm = log nc + (nd / 2) log(2 pi) + sum log diag L is a device
// scalar a rung, read through its pointer (the proposal is recorded into
// a CUDA graph, so nothing is read on the host).
//
// The logsumexp runs without the matrix.  A warp owns `rows` rows (up to
// kRowsMax); lane l takes the kernels j = l (mod 32) in increasing j and
// keeps a running (max, sum) pair per row, m from -FLT_MAX and s from 0:
//   d = a - m; big = d > 0; e = expf(big ? -d : d)
//   s = big ? s e + 1 : s + e;  m = big ? a : m
// A lane with no kernel adds nothing; a NaN a makes s NaN.  The 32 lanes
// then merge by a fixed butterfly (xor 16, 8, 4, 2, 1), each lane merging
// the partner's pair into its own:
//   m' = mb > m ? mb : m;  s = s expf(m - m') + sb expf(mb - m')
// and lane 0 writes the row.  The plain version (ops/kde_kernel.py
// kde_logpdf_plain) runs the same steps over ceil(nc / 32) column groups,
// vectorised over rows and lanes, and the same butterfly, so the two agree
// bit for bit: every operation rounds once (the _rn intrinsics, no FMA
// contraction) and expf / logf are libdevice's, as torch.exp / torch.log
// are on the card.
//
// What bounds it on an H100: operations.  At KDEMove's shape (ns = nc =
// 5e4, nd 5, s and q of a split in one launch: 5e9 pairs) the inputs are
// 2 MB, but every pair costs the cross term (2 nd), the distance (4), the
// running logsumexp (~8) and one expf: ~1.3 ms at the float32 and
// special-function rates, ~4 ms by the instructions issued.  The design
// keeps the pairs' work in registers: the complement is staged through
// shared memory in tiles of `tile` kernels (an odd row stride, nd | 1, so
// the lanes' strided reads hit 32 banks), each block computes the tile's
// c2 once, and each kernel's row is read once per lane and reused for the
// warp's rows.  For nd <= 8 (kNd, a template parameter) a warp's rows and
// a kernel's row live in registers; above it both are read from shared
// memory (the block's rows staged there too), with more than 48 KB of
// dynamic shared memory where the plan asks for it.  Tensor cores stay
// out: TF32 changes the results and the cross term's depth is nd.
//
// The rung axis (parallel tempering: emcee_tpu/parallel/tempering.py:538
// vmaps KDEMove over the ladder): kRungs evaluates every rung of a ladder
// in one launch, the grid's second dimension the rung; rung r's rows,
// kernels, out and lognorm[r] lie one after the other.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

// Rows a warp at most (the register arrays' length).
constexpr int kRowsMax = 8;
// Threads a block at most.
constexpr int kThreadsMax = 256;

__device__ __forceinline__ void lse_add(float& m, float& s, float a) {
  const float d = __fsub_rn(a, m);
  const bool big = d > 0.0f;
  const float e = expf(big ? -d : d);
  s = big ? __fadd_rn(__fmul_rn(s, e), 1.0f) : __fadd_rn(s, e);
  m = big ? a : m;
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float mb,
                                          float sb) {
  const float mm = mb > m ? mb : m;
  s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, mm))),
                __fmul_rn(sb, expf(__fsub_rn(mb, mm))));
  m = mm;
}

// kNd > 0: nd == kNd, rows and kernels in registers; kNd == 0: any nd,
// both read from shared memory.
template <int kNd, bool kRungs>
__global__ void __launch_bounds__(kThreadsMax) kde_logpdf_kernel(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ lognorm, float* __restrict__ out, int n,
    int nc, int nd_arg, int rows, int tile) {
  extern __shared__ float smem[];
  const int nd = kNd > 0 ? kNd : nd_arg;
  if constexpr (kRungs) {
    // The rung of this block: its rows, kernels, output and normaliser.
    const int rung = blockIdx.y;
    x += static_cast<int64_t>(rung) * n * nd;
    c += static_cast<int64_t>(rung) * nc * nd;
    out += static_cast<int64_t>(rung) * n;
    lognorm += rung;
  }
  const int cs = nd | 1;  // odd: lane l's row starts at bank l * cs % 32
  float* cw = smem;       // tile x cs
  float* c2 = cw + tile * cs;
  float* xs = c2 + tile;  // kNd == 0: the block's rows x nd
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int brow = blockIdx.x * warps * rows;
  const int row0 = brow + warp * rows;
  // This warp's rows (warp-uniform; a warp past the end has none but
  // still takes part in the block's barriers).
  const int mine = max(0, min(rows, n - row0));

  if constexpr (kNd == 0) {
    const int total = max(0, min(warps * rows, n - brow)) * nd;
    const float* src = x + static_cast<int64_t>(brow) * nd;
    for (int i = threadIdx.x; i < total; i += blockDim.x) xs[i] = src[i];
    __syncthreads();
  }
  float xr[kRowsMax][kNd > 0 ? kNd : 1];
  float x2[kRowsMax], m[kRowsMax], s[kRowsMax];
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) {
    x2[r] = 0.0f;
    m[r] = -FLT_MAX;
    s[r] = 0.0f;
    if (r < mine) {
      if constexpr (kNd > 0) {
        const float* xi = x + static_cast<int64_t>(row0 + r) * kNd;
#pragma unroll
        for (int k = 0; k < kNd; ++k) {
          xr[r][k] = xi[k];
          x2[r] = __fadd_rn(x2[r], __fmul_rn(xr[r][k], xr[r][k]));
        }
      } else {
        const float* xi = xs + (warp * rows + r) * nd;
        for (int k = 0; k < nd; ++k)
          x2[r] = __fadd_rn(x2[r], __fmul_rn(xi[k], xi[k]));
      }
    }
  }

  for (int j0 = 0; j0 < nc; j0 += tile) {
    const int tn = min(tile, nc - j0);
    __syncthreads();  // the last tile is consumed
    const float* src = c + static_cast<int64_t>(j0) * nd;
    for (int i = threadIdx.x; i < tn * nd; i += blockDim.x) {
      const int j = i / nd;
      cw[j * cs + (i - j * nd)] = src[i];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += blockDim.x) {
      const float* cj = cw + j * cs;
      float t = 0.0f;
      for (int k = 0; k < nd; ++k) t = __fadd_rn(t, __fmul_rn(cj[k], cj[k]));
      c2[j] = t;
    }
    __syncthreads();
    if (mine == 0) continue;
    for (int j = lane; j < tn; j += 32) {
      const float* cj = cw + j * cs;
      const float cc = c2[j];
      float dot[kRowsMax];
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r) dot[r] = 0.0f;
      if constexpr (kNd > 0) {
        float cv[kNd];
#pragma unroll
        for (int k = 0; k < kNd; ++k) cv[k] = cj[k];
#pragma unroll
        for (int r = 0; r < kRowsMax; ++r) {
          if (r < mine) {
#pragma unroll
            for (int k = 0; k < kNd; ++k)
              dot[r] = __fadd_rn(dot[r], __fmul_rn(xr[r][k], cv[k]));
          }
        }
      } else {
        const float* xw = xs + warp * rows * nd;
        for (int k = 0; k < nd; ++k) {
          const float cv = cj[k];
#pragma unroll
          for (int r = 0; r < kRowsMax; ++r) {
            if (r < mine)
              dot[r] = __fadd_rn(dot[r], __fmul_rn(xw[r * nd + k], cv));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r) {
        if (r < mine) {
          const float a = __fmul_rn(
              -0.5f, __fsub_rn(__fadd_rn(x2[r], cc), __fmul_rn(2.0f, dot[r])));
          lse_add(m[r], s[r], a);
        }
      }
    }
  }

  const float norm = *lognorm;
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) {
    if (r < mine) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float mb = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float sb = __shfl_xor_sync(0xffffffffu, s[r], o);
        lse_merge(m[r], s[r], mb, sb);
      }
      if (lane == 0)
        out[row0 + r] = __fsub_rn(__fadd_rn(m[r], logf(s[r])), norm);
    }
  }
}

template <int kNd>
int launch_kde(const float* x, const float* c, const float* lognorm,
               float* out, int n, int nc, int nd, int ntemps, int rows,
               int warps, int tile, int smem, cudaStream_t stream) {
  auto kernel = ntemps > 1 ? kde_logpdf_kernel<kNd, true>
                           : kde_logpdf_kernel<kNd, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = warps * rows;
  const dim3 grid((n + per_block - 1) / per_block, ntemps);
  kernel<<<grid, 32 * warps, smem, stream>>>(x, c, lognorm, out, n, nc, nd,
                                             rows, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/kde_kernel.py).  Every
// pointer is a device pointer: x (ntemps, n, nd) whitened rows, c (ntemps,
// nc, nd) whitened kernels, lognorm (ntemps,) and out (ntemps, n), each
// rung's after the last (ntemps = 1: one ensemble).  rows, warps, tile and
// smem are the launch plan of ops/kde_kernel.py kde_plan: 1 <= rows <= 8
// rows a warp, warps a block (32 * warps <= 256 threads), tile a multiple
// of 32 kernels staged at a time, smem the dynamic shared memory (tile *
// ((nd | 1) + 1) floats, and the block's rows for nd > 8).  Returns the
// first CUDA error (the shared-memory attribute, else cudaGetLastError()
// after the launch).
extern "C" int emcee_kde_logpdf(const float* x, const float* c,
                                const float* lognorm, float* out, int n,
                                int nc, int nd, int ntemps, int rows,
                                int warps, int tile, int smem,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (nd) {
#define EMCEE_KDE_ND(K)                                                    \
  case K:                                                                  \
    return launch_kde<K>(x, c, lognorm, out, n, nc, nd, ntemps, rows,   \
                         warps, tile, smem, st);
    EMCEE_KDE_ND(1)
    EMCEE_KDE_ND(2)
    EMCEE_KDE_ND(3)
    EMCEE_KDE_ND(4)
    EMCEE_KDE_ND(5)
    EMCEE_KDE_ND(6)
    EMCEE_KDE_ND(7)
    EMCEE_KDE_ND(8)
#undef EMCEE_KDE_ND
    default:
      return launch_kde<0>(x, c, lognorm, out, n, nc, nd, ntemps, rows,
                           warps, tile, smem, st);
  }
}

// K19: the Gaussian Metropolis proposal, for one ensemble or for every
// rung of a ladder at once.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/gaussian.py:118-150 (the
// factor's uniform, the normals, z * scale or z @ chol^T, x0 + f step and
// the random / sequential mask), vmapped over a ladder's rungs by
// emcee_tpu/parallel/tempering.py:538.  There is no Pallas kernel behind
// it.  The port ran it as plain torch: K14's normals (and again for the
// random mode's dimensions), a roll_uniforms draw for the factor, a
// torch.matmul for a full covariance and a chain of elementwise ops.  The
// plain version is ops/gaussian_kernel.py gaussian_propose_plain; the
// kernel equals it bit for bit (every operation rounded once by the _rn
// intrinsics, the full covariance's sum from +0.0 in column order as K18a
// sums it, expf / logf / cosf as torch's on the card).
//
// gaussian_propose_kernel: one thread a walker w of rung r = blockIdx.y
// (gaussian_pairs_kernel, the vector mode with a scalar or diagonal scale:
// one thread a walker's pair of columns 2j, 2j + 1, a Philox block each).
// Thread 0 of a block first forms the rung's step factor
//   f = exp(-lf + u 2lf) exp(log_adj[r])
// (u word 0 at (ROLL_LANE, 0, offset) under the rung's key, or injected;
// either factor left out where the move has none), and in the sequential
// mode the rung's dimension index[r] mod nd, into shared memory.  Then
// each thread writes its row:
//   vector, scalar or diagonal scale:  q_d = x_d + f (z_d scale_d)
//   vector, full covariance:           q_d = x_d + f sum_{k <= d} z_k L[d][k]
//   random / sequential:               q = x, but q_j = x_j + f (z_j scale_j)
// with z_k the walker's normals at (w, NORMAL_BLOCK | k/2) (normal 2j from
// words 0 and 2, 2j + 1 from words 1 and 3), or injected, and the random
// mode's j = min(int(u_w nd), nd - 1), u_w word 0 at (w, 0, offset) (or
// injected).  The full covariance writes its normals into the walker's q
// row first and forms q from the last column down (q_d reads z_0 .. z_d,
// which no later column has overwritten), as K18a does.  The factor row
// is written 0.
//
// gaussian_advance_kernel: the sequential mode's index[r] = (index[r] + 1)
// mod nd, a launch of its own after K19 on the same stream, so no block of
// K19 can read an index that another has already advanced.
//
// What bounds it on an H100: the bytes, x read, q and the factor written
// (4.4 MB at 1e5 x 5, ~1.3 us at 3.35 TB/s); the normals are a Philox
// block and two Box-Muller normals a pair of columns.  A thread a walker
// draws its pairs one after the other, a chain of Philox rounds and
// Box-Muller's log and cos that few warps hide at 1e5 walkers; a thread a
// pair runs the pairs side by side.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

#define EMCEE_NORMAL_BLOCK 0x40000000u

// The arguments of the entry points (ops/gaussian_kernel.py _Args, field
// for field).  Declared outside the anonymous namespace: the C entry
// points take it.
struct GaussArgs {
  const float* x;              // (ntemps, nw, nd)
  float* q;                    // (ntemps, nw, nd)
  float* factor;               // (ntemps, nw)
  const float* scale;          // (1,) or (nd,); null with L
  const float* L;              // (nd, nd) lower triangle, or null
  const float* log_adj;        // (ntemps,) or null
  int* index;                  // sequential: (ntemps,)
  const float* z_in;           // (ntemps, nw, nd) or null
  const float* u_in;           // the factor's uniform (ntemps,), or null
  const long long* dims_in;    // random: (ntemps, nw), or null
  const long long* offset_dev;
  const long long* keys;       // the rungs' key table, or null
  unsigned long long offset_inc, seed;
  float neg_lf, two_lf;        // -log(factor), 2 log(factor) in float32
  int nw, nd, ntemps;
  int mode;                    // 0 vector, 1 random, 2 sequential
  int diag;                    // scale has nd entries
  int has_factor;
  int threads;
};

namespace {

constexpr int kModeVector = 0;
constexpr int kModeRandom = 1;
constexpr int kModeSequential = 2;

// The walker's normal k, a Philox block a pair of columns.
__device__ __forceinline__ float normal_at(uint32_t row, int k, uint64_t off,
                                           uint32_t k0, uint32_t k1) {
  const uint4 w = philox_at(row, EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(
                                                          k >> 1),
                            off, k0, k1);
  return (k & 1) ? philox_normal(w.y, w.w) : philox_normal(w.x, w.z);
}

// Python's (and torch's) remainder of a by nd: the sign of nd.
__device__ __forceinline__ int floor_mod(int a, int nd) {
  const int m = a % nd;
  return m < 0 ? m + nd : m;
}

// The rung's key and the proposal's offset.
struct Stream {
  uint32_t k0, k1;
  uint64_t off;
};

__device__ __forceinline__ Stream stream_of(const GaussArgs& a, int rung) {
  unsigned long long key = a.seed;
  if (a.keys != nullptr) key = static_cast<unsigned long long>(a.keys[rung]);
  return {static_cast<uint32_t>(key), static_cast<uint32_t>(key >> 32),
          philox_offset(a.offset_dev, a.offset_inc)};
}

// The rung's step factor exp(-lf + u 2lf) exp(log_adj[r]) (1 without
// either), as the plain version forms it.
__device__ __forceinline__ float step_factor(const GaussArgs& a, int rung,
                                             const Stream& s) {
  float f = 1.0f;
  if (a.has_factor) {
    const float u =
        a.u_in != nullptr
            ? a.u_in[rung]
            : philox_uniform(philox_at(EMCEE_ROLL_LANE, 0u, s.off, s.k0,
                                       s.k1).x);
    f = expf(__fadd_rn(a.neg_lf, __fmul_rn(u, a.two_lf)));
  }
  if (a.log_adj != nullptr) {
    const float adj = expf(a.log_adj[rung]);
    f = a.has_factor ? __fmul_rn(f, adj) : adj;
  }
  return f;
}

__global__ void __launch_bounds__(256) gaussian_pairs_kernel(GaussArgs a) {
  __shared__ float f_sh;
  const int rung = blockIdx.y;
  const Stream st = stream_of(a, rung);
  if (threadIdx.x == 0) f_sh = step_factor(a, rung, st);
  __syncthreads();
  const int nd = a.nd, pairs = (nd + 1) >> 1;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.nw * pairs) return;
  const int w = e / pairs, j = e - w * pairs;
  const float f = f_sh;
  const int64_t f_row = static_cast<int64_t>(rung) * a.nw + w;
  const int d = 2 * j;
  const int64_t at = f_row * nd + d;
  float z0, z1 = 0.0f;
  if (a.z_in != nullptr) {
    z0 = a.z_in[at];
    if (d + 1 < nd) z1 = a.z_in[at + 1];
  } else {
    const uint4 wd = philox_at(static_cast<uint32_t>(w),
                               EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(j),
                               st.off, st.k0, st.k1);
    z0 = philox_normal(wd.x, wd.z);
    if (d + 1 < nd) z1 = philox_normal(wd.y, wd.w);
  }
  a.q[at] = __fadd_rn(a.x[at],
                      __fmul_rn(f, __fmul_rn(z0, a.scale[a.diag ? d : 0])));
  if (d + 1 < nd)
    a.q[at + 1] = __fadd_rn(
        a.x[at + 1], __fmul_rn(f, __fmul_rn(z1, a.scale[a.diag ? d + 1 : 0])));
  if (j == 0) a.factor[f_row] = 0.0f;
}

__global__ void __launch_bounds__(256) gaussian_propose_kernel(GaussArgs a) {
  __shared__ float f_sh;
  __shared__ int dim_sh;
  const int rung = blockIdx.y;
  const Stream st = stream_of(a, rung);
  const uint32_t k0 = st.k0, k1 = st.k1;
  const uint64_t off = st.off;
  const int nd = a.nd;
  if (threadIdx.x == 0) {
    f_sh = step_factor(a, rung, st);
    dim_sh = a.mode == kModeSequential ? floor_mod(a.index[rung], nd) : 0;
  }
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.nw) return;
  const float f = f_sh;
  const int64_t f_row = static_cast<int64_t>(rung) * a.nw + w;
  const float* x = a.x + f_row * nd;
  float* q = a.q + f_row * nd;
  const float* z = a.z_in != nullptr ? a.z_in + f_row * nd : nullptr;
  const uint32_t row = static_cast<uint32_t>(w);
  a.factor[f_row] = 0.0f;
  if (a.mode != kModeVector) {
    int j = dim_sh;
    if (a.mode == kModeRandom) {
      if (a.dims_in != nullptr) {
        j = static_cast<int>(a.dims_in[f_row]);
      } else {
        const float u = philox_uniform(philox_at(row, 0u, off, k0, k1).x);
        j = min(static_cast<int>(__fmul_rn(u, static_cast<float>(nd))),
                nd - 1);
      }
    }
    for (int d = 0; d < nd; ++d) q[d] = x[d];
    if (j < 0 || j >= nd) return;  // an injected dimension out of range
    const float zj = z != nullptr ? z[j] : normal_at(row, j, off, k0, k1);
    q[j] = __fadd_rn(x[j],
                     __fmul_rn(f, __fmul_rn(zj, a.scale[a.diag ? j : 0])));
    return;
  }
  // The full covariance (the vector mode's scalar and diagonal scales are
  // gaussian_pairs_kernel's): the normals into the row, then q from the
  // last column down.
  if (z != nullptr) {
    for (int k = 0; k < nd; ++k) q[k] = z[k];
  } else {
    uint4 wd = make_uint4(0u, 0u, 0u, 0u);
    for (int k = 0; k < nd; ++k) {
      if ((k & 1) == 0)
        wd = philox_at(row, EMCEE_NORMAL_BLOCK | static_cast<uint32_t>(k >> 1),
                       off, k0, k1);
      q[k] = (k & 1) ? philox_normal(wd.y, wd.w) : philox_normal(wd.x, wd.z);
    }
  }
  for (int d = nd - 1; d >= 0; --d) {
    float acc = 0.0f;
    for (int k = 0; k <= d; ++k)
      acc = __fadd_rn(acc, __fmul_rn(q[k], a.L[d * nd + k]));
    q[d] = __fadd_rn(x[d], __fmul_rn(f, acc));
  }
}

__global__ void gaussian_advance_kernel(int* __restrict__ index, int ntemps,
                                        int nd) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < ntemps) index[r] = floor_mod(index[r] + 1, nd);
}

}  // namespace

// K19 over every walker of every rung; in the sequential mode followed by
// the index's advance.  The launch plan is one thread a walker (a walker's
// pair of columns in the vector mode with a scalar or diagonal scale) in
// blocks of a->threads, the grid's second dimension the rung.
extern "C" int emcee_gaussian_propose(const GaussArgs* a, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (a->threads < 32 || a->threads > 256 || a->nw < 1 || a->nd < 1 ||
      a->ntemps < 1 || a->ntemps > 65535 || a->mode < 0 || a->mode > 2 ||
      (a->L == nullptr && a->scale == nullptr) ||
      (a->mode == kModeSequential && a->index == nullptr) ||
      (a->mode != kModeVector && a->L != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->mode == kModeVector && a->L == nullptr) {
    const int64_t n = static_cast<int64_t>(a->nw) * ((a->nd + 1) / 2);
    if (n >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((n + a->threads - 1) / a->threads),
                    a->ntemps);
    gaussian_pairs_kernel<<<grid, a->threads, 0, st>>>(*a);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((a->nw + a->threads - 1) / a->threads, a->ntemps);
  gaussian_propose_kernel<<<grid, a->threads, 0, st>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a->mode != kModeSequential)
    return static_cast<int>(err);
  gaussian_advance_kernel<<<(a->ntemps + 127) / 128, 128, 0, st>>>(
      a->index, a->ntemps, a->nd);
  return static_cast<int>(cudaGetLastError());
}

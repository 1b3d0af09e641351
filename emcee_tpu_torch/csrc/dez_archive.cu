// K10c: DE-Z's archive fold, the ring's update in one launch.
//
// Replaces the XLA-fused update_carry of emcee_tpu/moves/de_z.py:227-280:
// rows (t + a stride) % nw of the post-accept ensemble (a < nrows, stride
// = max(1, nw / nrows)) written into slots (ptr + a) % capacity of the
// archive, then filled = min(filled + nrows, capacity), ptr = (ptr +
// nrows) % capacity and t = t + 1.  The port ran it as plain torch (an
// arange, two modulos, index_select, index_copy_ and three word updates:
// eight launches).  The plain version is ops/dez_kernel.py dez_fold_plain;
// the kernel copies the same rows into the same slots, so the two agree
// bit for bit, as both do with the JAX package.
//
// One block a rung (blockIdx.x).  Every thread reads the rung's words
// before the block-wide barrier, and thread 0 writes them after it, so no
// word changes before every copy that reads it has its value; the launch
// stays one.  What bounds it on an H100: its few rows (64 a fold by
// default) are a launch's worth of work; the block's loop strides over
// every (row, column) so a large fold stays right, not fast.
//
// The rung axis (emcee_tpu/parallel/tempering.py:449-541 vmaps the update
// over the ladder): rung r's rows, archive and words one rung after the
// other.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsMax = 1024;

__global__ void __launch_bounds__(kThreadsMax) dez_fold_kernel(
    const float* __restrict__ x, float* __restrict__ archive, int* filled,
    int* ptr, int* t, int nw, int nd, int capacity, int nrows, int stride) {
  const int rung = blockIdx.x;
  const float* xr = x + static_cast<int64_t>(rung) * nw * nd;
  float* ar = archive + static_cast<int64_t>(rung) * capacity * nd;
  const int64_t t0 = t[rung];
  const int p0 = ptr[rung];
  const int f0 = filled[rung];
  const int64_t total = static_cast<int64_t>(nrows) * nd;
  for (int64_t e = threadIdx.x; e < total; e += blockDim.x) {
    const int64_t a = e / nd;
    const int64_t c = e - a * nd;
    int64_t idx = (t0 + a * stride) % nw;
    idx += idx < 0 ? nw : 0;  // a floor modulo, as torch's
    const int64_t slot = (p0 + a) % capacity;
    ar[slot * nd + c] = xr[idx * nd + c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    filled[rung] = min(f0 + nrows, capacity);
    ptr[rung] = (p0 + nrows) % capacity;
    t[rung] = static_cast<int>(static_cast<uint32_t>(t0) + 1u);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/dez_kernel.py): x (ntemps,
// nw, nd) the post-accept rows, archive (ntemps, capacity, nd), the int32
// words filled, ptr and t (ntemps,), all written in place.  Returns
// cudaGetLastError() after the launch.
extern "C" int emcee_dez_fold(const float* x, float* archive, int* filled,
                              int* ptr, int* t, int nw, int nd, int capacity,
                              int nrows, int stride, int ntemps, int threads,
                              void* stream) {
  if (threads < 32 || threads > kThreadsMax || nw < 1 || nd < 1 ||
      capacity < 1 || nrows < 1 || nrows > capacity || stride < 1 ||
      ntemps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dez_fold_kernel<<<ntemps, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, archive, filled, ptr, t, nw, nd, capacity, nrows, stride);
  return static_cast<int>(cudaGetLastError());
}

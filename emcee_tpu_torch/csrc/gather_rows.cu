// K17: every buffer's rows gathered into group order, or scattered back,
// in one launch.
//
// Replaces the row gathers and scatters that XLA fuses into the shuffled
// proposal of the JAX package (emcee_tpu/moves/red_blue.py:228-264: each
// group's coords[idx], log_prob[idx] and blob rows b[idx], and the
// .at[idx].set(...) write-backs of the coordinates, log-probs, blobs and
// acceptance), vmapped over the rungs by emcee_tpu/parallel/tempering.py:
// 538.  There is no Pallas kernel behind it.  The port's plain version
// (ops/shuffle_kernel.py gather_rows_plain / scatter_rows_plain) is one
// index_select or index_copy_ a buffer.
//
// Each buffer is a descriptor (ops/shuffle_kernel.py _RowBuf): its source
// and destination bases, its row's bytes and the unit it is copied in
// (the largest of 16, 8, 4, 2 and 1 bytes that divides both bases and the
// row, ops/accept_kernel.py blob_unit, so an unaligned base is taken by a
// smaller unit), and the first block of the launch that serves it.  With
// order (rows,) int64 flat rows K16 wrote:
//     gather:   dst row k  = src row order[k]
//     scatter:  dst row order[k] = src row k
// Bytes are copied, never converted, so the result equals index_select /
// index_copy_ byte for byte, NaN payloads included; order is a
// permutation, so no row is written twice.
//
// One thread a unit: a buffer's units are numbered row by row, unit t of
// a buffer is unit t - k upr of row k = t / upr (a multiply-high by a
// magic number the host computes, ops/_wrap.py divisor), so neighbouring
// threads copy neighbouring units of a row, and a warp's units of the
// contiguous side are one span.  Block b serves the buffer whose first
// block is the last at or below b: the blocks of every buffer are one
// grid, and no block idles.
//
// What bounds it on an H100: bytes and latency.  Workload 4's gather moves
// 16 x 256 rows of 20 + 4 + 4 + 4 + 4 bytes each way (~0.3 MB, 0.09 us at
// 3.35 TB/s), far below a launch; one ensemble of 1e5 walkers x 5-D moves
// ~2.8 MB each way (~1.7 us).  The random side reads (gather) or writes
// (scatter) whole rows of 4-byte units, so its sectors are half used at
// 20-byte rows; the other side is coalesced.
#include <cuda_runtime.h>

#include <cstdint>

// Buffers one launch takes (ROWS_CAPACITY in ops/shuffle_kernel.py); the
// entry point launches again for the rest.
constexpr int kMaxBufs = 32;
constexpr int kThreads = 256;  // ROWS_THREADS

// One buffer (the layout of ops/shuffle_kernel.py _RowBuf).  Outside the
// anonymous namespace: the C entry point takes it, and must keep external
// linkage.
struct RowBuf {
  const void* src;
  void* dst;
  int row_bytes;
  int unit;
  uint32_t upr_mul;  // row_bytes / unit units a row, as a magic divisor
  int upr_shr;
  int first_block;
  int units;  // rows * row_bytes / unit, below 2^31
};

struct RowBufs {
  int n;
  RowBuf buf[kMaxBufs];
};

namespace {

template <typename U, bool kScatter>
__device__ __forceinline__ void copy_units(const RowBuf& d,
                                           const long long* __restrict__ order,
                                           int t) {
  const int upr = d.row_bytes / static_cast<int>(sizeof(U));
  const int k = d.upr_mul == 0
                    ? t
                    : static_cast<int>(__umulhi(static_cast<uint32_t>(t),
                                                d.upr_mul) >>
                                       d.upr_shr);
  const int c = t - k * upr;
  const long long o = order[k];
  const long long from = kScatter ? k : o;
  const long long to = kScatter ? o : k;
  const U* src = static_cast<const U*>(d.src);
  U* dst = static_cast<U*>(d.dst);
  dst[to * upr + c] = src[from * upr + c];
}

template <bool kScatter>
__device__ __forceinline__ void copy_rows(const long long* __restrict__ order,
                                          const RowBufs& bufs) {
  int b = 0;
  while (b + 1 < bufs.n &&
         bufs.buf[b + 1].first_block <= static_cast<int>(blockIdx.x)) {
    ++b;
  }
  const RowBuf& d = bufs.buf[b];
  const int t = (static_cast<int>(blockIdx.x) - d.first_block) * kThreads +
                static_cast<int>(threadIdx.x);
  if (t >= d.units) return;
  switch (d.unit) {
    case 16:
      copy_units<uint4, kScatter>(d, order, t);
      break;
    case 8:
      copy_units<uint2, kScatter>(d, order, t);
      break;
    case 4:
      copy_units<uint32_t, kScatter>(d, order, t);
      break;
    case 2:
      copy_units<uint16_t, kScatter>(d, order, t);
      break;
    default:
      copy_units<uint8_t, kScatter>(d, order, t);
  }
}

// The table is a __grid_constant__ parameter: read in place (a block's
// threads all read the same descriptor, a broadcast from the constant
// cache), never copied per thread.
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const long long* __restrict__ order,
                       const __grid_constant__ RowBufs bufs) {
  copy_rows<false>(order, bufs);
}

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const long long* __restrict__ order,
                        const __grid_constant__ RowBufs bufs) {
  copy_rows<true>(order, bufs);
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/shuffle_kernel.py).  order
// (rows,) int64 is a device pointer; bufs a host array of nbufs
// descriptors, their first_block counted from 0 within each group of
// kMaxBufs, and blocks[g] the blocks of group g.  scatter selects the
// direction.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue, and no launch, for arguments out of range).
extern "C" int emcee_copy_rows(const long long* order, const RowBuf* bufs,
                               int nbufs, const int* blocks, int scatter,
                               void* stream) {
  if (nbufs < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nbufs; ++i) {
    const int u = bufs[i].unit;
    if ((u != 1 && u != 2 && u != 4 && u != 8 && u != 16) ||
        bufs[i].row_bytes < u || bufs[i].row_bytes % u != 0 ||
        bufs[i].units < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int g0 = 0, g = 0; g0 < nbufs; g0 += kMaxBufs, ++g) {
    RowBufs group;
    group.n = nbufs - g0 < kMaxBufs ? nbufs - g0 : kMaxBufs;
    for (int i = 0; i < group.n; ++i) group.buf[i] = bufs[g0 + i];
    if (blocks[g] < 1) continue;
    if (scatter) {
      scatter_rows_kernel<<<blocks[g], kThreads, 0, st>>>(order, group);
    } else {
      gather_rows_kernel<<<blocks[g], kThreads, 0, st>>>(order, group);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

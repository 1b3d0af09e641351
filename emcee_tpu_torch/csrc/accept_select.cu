// K2: the fused accept/select write-back, tiled.
//
// Replaces the XLA-fused chain of emcee_tpu/moves/red_blue.py:196-204
// (RedBlueMove._inner: Metropolis compare and select) and :323-344 (the
// _propose_blocked dynamic_update_slice write-back).  As for K1, there is
// no Pallas kernel behind it: XLA fused the chain; eager PyTorch would
// run it as separate launches.
//
// Per walker i of split group `split` (ensemble rows lo = split*ng .. +ng):
//   log_u   = log(Philox word 1 at (i, split, offset))   [or injected]
//   lnpdiff = factor[i] + lp_q[i] - log_prob[lo+i]       (this order, :197)
//   acc     = log_u < lnpdiff                            (NaN lp_q rejects)
//   if acc: coords[lo+i, :] = q[i, :]; log_prob[lo+i] = lp_q[i];
//           count[lo+i] += 1                             (count optional)
//   accepted[lo+i] = acc
//
// What bounds it on an H100: bytes, and latency.  Per walker it reads 3
// floats and writes one bool; an accepted walker also reads its ndim
// floats of q, writes ndim + 1 floats and updates one int: about 2 MB for
// ng = 50000, ndim = 5 and 1.4 MB for ng = 5000, ndim = 100 at the paths'
// acceptance, i.e. 0.6 and 0.4 us at 3.35 TB/s.  The arithmetic (one
// Philox block and one logf per walker) is far below the card's rates.
// There is no matrix product here, so no tensor-core (wgmma) work exists.
//
// The first design gave one thread a walker and its whole row: at ndim 100
// the grid had 20 blocks on 132 SMs, each warp store touched 32 rows 400
// bytes apart, and the q row was read only after the accept decision (two
// dependent trips to memory).  The tiled design:
//   * A block owns a tile of `tile` consecutive walkers (ops/_wrap.py
//     tile_plan picks it so that the grid has two blocks or more for every
//     SM: 16 at ndim 100, 128 at ndim 5, the fastest of a sweep).
//   * Phase A, one thread per walker: the accept uniform in registers
//     (never stored), lnpdiff, acc; `accepted`, and for accepted walkers
//     log_prob and count, written at once; acc kept in shared memory.
//   * Phase B, after one __syncthreads: the tile's q rows and its rows of
//     coords are two contiguous spans of tile*ndim floats.  The block
//     copies them as one flat stream, 16-byte float4 stores where the
//     destination is aligned and scalar stores for the head and tail, each
//     element masked by the acc of its walker e / ndim: a float4 whose
//     walkers are all rejected is neither read nor written, one that
//     straddles an accepted and a rejected row is stored element by
//     element.  A rejected row is never written.
//   * kVec (both spans 16-byte aligned, decided by the plan): the source is
//     read as float4 too; otherwise element by element (coalesced).
//   * kStage: at block start one thread issues the tile's q span (its
//     16-byte multiple; the rest of the last tile is read in phase B) as a
//     TMA bulk copy (cp.async.bulk) into shared memory, completed on an
//     mbarrier.  It overlaps the Philox draw and the three lp loads, so
//     phase B's source is on chip and the second dependent trip to memory
//     goes away, at the price of reading the rejected rows of q too.
//   * The variant kept: staged, wherever it can be (a 16-byte aligned q,
//     4 rows that fit in shared memory).  On the H100 it beat reading the
//     accepted rows' float4s from device memory after the decision at both
//     shapes (chip_smoke.py phase 6, PERF.md): the saved dependent trip
//     outweighs the extra bytes.  The direct variant serves the rest.
//
// One thread owns a walker's acc, log_prob and count, so nothing needs
// atomics; every element of coords is written by at most one thread.
//
// Blob leaves (emcee_tpu/moves/red_blue.py:200-202 and :323-344, the
// tree_where and write-back of every blob leaf with the coordinates'
// mask; moves/base.py:103-126 for MH and Gaussian).  A leaf is any dtype
// of any row shape: to the kernel it is a byte row per walker.  Each
// leaf reaches the kernel as a descriptor in a struct passed by value
// (the split's new rows, the ensemble buffer, the row's bytes and an
// access unit), so a graph records it with the launch.  Phase C, after
// phase B, copies each leaf's tile span (tile x row_bytes contiguous
// bytes) as a masked stream of units: the unit is the largest of 16, 8,
// 4, 2, 1 bytes that divides both bases and the row (ops/accept_kernel.py
// blob_unit), so no unit straddles two walkers' rows and unit k belongs
// to walker k / (row_bytes / unit), whose acc is in shared memory.  The
// main path's three 4-byte leaves take 4-byte units.  A launch takes up
// to kMaxLeaves leaves; the entry point launches the rest in groups of
// kMaxLeaves by a blob-only kernel that reads the split's `accepted`.
// Without blob leaves the entry point launches the blob-free
// instantiation (Blobs = NoBlobs, an empty struct): phase A and B are the
// same source, and phase C is compiled out.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bulk_copy.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;  // TILE_MAX in ops/_wrap.py
constexpr int kMaxLeaves = 16;  // BLOB_CAPACITY in ops/accept_kernel.py

}  // namespace

// One blob leaf (the layout of ops/accept_kernel.py _BlobLeaf): the
// split's new rows (ng, *shape), the ensemble buffer (nwalkers, *shape),
// the bytes of one walker's row, and the access unit in bytes.
struct BlobLeaf {
  const unsigned char* src;
  unsigned char* dst;
  int row_bytes;
  int unit;
};

namespace {

struct BlobLeaves {
  int n;
  BlobLeaf leaf[kMaxLeaves];
};

// The blob-free kernel's Blobs: no leaves.
struct NoBlobs {};

// Walkers [t0, t0 + cnt) of the split, whose acc is s_acc[0, cnt): copy
// the accepted walkers' rows of one leaf, unit by unit.
template <typename U>
__device__ __forceinline__ void select_leaf(const BlobLeaf& leaf,
                                            const bool* s_acc, int t0,
                                            int64_t lo, int cnt, int t) {
  const int upr = leaf.row_bytes / static_cast<int>(sizeof(U));
  const U* __restrict__ src = reinterpret_cast<const U*>(leaf.src) +
                              static_cast<int64_t>(t0) * upr;
  U* __restrict__ dst = reinterpret_cast<U*>(leaf.dst) + (lo + t0) * upr;
  const int n = cnt * upr;
  for (int k = t; k < n; k += kThreads) {
    if (s_acc[k / upr]) dst[k] = src[k];
  }
}

// Phase C: every leaf of `leaves`.
__device__ __forceinline__ void select_blobs(const BlobLeaves& leaves,
                                             const bool* s_acc, int t0,
                                             int64_t lo, int cnt, int t) {
  for (int l = 0; l < leaves.n; ++l) {
    const BlobLeaf& leaf = leaves.leaf[l];
    switch (leaf.unit) {
      case 16: select_leaf<uint4>(leaf, s_acc, t0, lo, cnt, t); break;
      case 8: select_leaf<uint2>(leaf, s_acc, t0, lo, cnt, t); break;
      case 4: select_leaf<uint32_t>(leaf, s_acc, t0, lo, cnt, t); break;
      case 2: select_leaf<uint16_t>(leaf, s_acc, t0, lo, cnt, t); break;
      default: select_leaf<uint8_t>(leaf, s_acc, t0, lo, cnt, t); break;
    }
  }
}

template <bool kVec, bool kStage, typename Blobs>
__global__ void __launch_bounds__(kThreads) accept_select_kernel(
    const float* __restrict__ q, const float* __restrict__ factor,
    const float* __restrict__ lp_q, float* __restrict__ coords,
    float* __restrict__ log_prob, bool* __restrict__ accepted,
    int32_t* __restrict__ count, const float* __restrict__ log_u, int ng,
    int nd, int split, int tile, uint32_t k0, uint32_t k1,
    const long long* __restrict__ offset_dev, unsigned long long offset_inc,
    const __grid_constant__ Blobs blobs) {
  __shared__ bool s_acc[kThreads];
  __shared__ uint64_t s_bar;
  extern __shared__ float4 s_q4[];  // kStage: the tile's q span

  const int t = threadIdx.x;
  const int t0 = blockIdx.x * tile;
  const int cnt = min(tile, ng - t0);
  const int n = cnt * nd;
  const int64_t lo = static_cast<int64_t>(split) * ng;
  const float* src = q + static_cast<int64_t>(t0) * nd;
  float* dst = coords + (lo + t0) * nd;
  // The staged prefix: a multiple of 16 bytes from a 16-byte aligned src.
  const int n_staged = kStage ? (n & ~3) : 0;

  if (kStage && t == 0 && n_staged > 0) {
    bulk_copy_to_shared(s_q4, src, static_cast<uint32_t>(n_staged) * 4u,
                        &s_bar);
  }

  // -- phase A: one thread per walker -------------------------------------
  if (t < cnt) {
    const int i = t0 + t;
    float lu;
    if (log_u != nullptr) {
      lu = log_u[i];
    } else {
      const uint4 w = philox_at(static_cast<uint32_t>(i),
                                static_cast<uint32_t>(split),
                                philox_offset(offset_dev, offset_inc), k0, k1);
      lu = logf(philox_uniform(w.y));
    }
    const int64_t row = lo + i;
    const float lpq = lp_q[i];
    const float lnpdiff = __fsub_rn(__fadd_rn(factor[i], lpq), log_prob[row]);
    const bool acc = lu < lnpdiff;
    if (acc) {
      log_prob[row] = lpq;
      if (count != nullptr) count[row] += 1;
    }
    accepted[row] = acc;
    s_acc[t] = acc;
  }
  __syncthreads();
  if (kStage && n_staged > 0) bulk_copy_wait(&s_bar);

  // -- phase B: the tile's rows as one flat, masked stream ----------------
  const float* s_q = reinterpret_cast<const float*>(s_q4);
  auto load = [&](int e) {
    return (kStage && e < n_staged) ? s_q[e] : src[e];
  };
  // Scalar head up to the first 16-byte aligned element of dst (none
  // when kVec), float4 body, scalar tail.
  const int head =
      kVec ? 0
           : min(n, static_cast<int>(
                        (4u - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u)) &
                        3u));
  const int n4 = (n - head) >> 2;
  for (int e = t; e < head; e += kThreads) {
    if (s_acc[e / nd]) dst[e] = load(e);
  }
  for (int e = head + 4 * n4 + t; e < n; e += kThreads) {
    if (s_acc[e / nd]) dst[e] = load(e);
  }
  for (int k = t; k < n4; k += kThreads) {
    const int e = head + 4 * k;
    int w = e / nd;
    int d = e - w * nd;
    bool m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = s_acc[w];
      if (++d == nd) {
        d = 0;
        ++w;
      }
    }
    if (!(m[0] | m[1] | m[2] | m[3])) continue;
    float4 v;
    if (kVec) {
      // head == 0, so e + 3 < 4 * n4 == n_staged when staged.
      v = kStage ? s_q4[e >> 2] : reinterpret_cast<const float4*>(src)[e >> 2];
    } else {
      v.x = m[0] ? load(e) : 0.0f;
      v.y = m[1] ? load(e + 1) : 0.0f;
      v.z = m[2] ? load(e + 2) : 0.0f;
      v.w = m[3] ? load(e + 3) : 0.0f;
    }
    if (m[0] & m[1] & m[2] & m[3]) {
      *reinterpret_cast<float4*>(dst + e) = v;
    } else {
      if (m[0]) dst[e] = v.x;
      if (m[1]) dst[e + 1] = v.y;
      if (m[2]) dst[e + 2] = v.z;
      if (m[3]) dst[e + 3] = v.w;
    }
  }

  // -- phase C: the blob leaves' rows, masked by the same acc --------------
  if constexpr (std::is_same_v<Blobs, BlobLeaves>) {
    select_blobs(blobs, s_acc, t0, lo, cnt, t);
  }
}

// Leaves beyond the first kMaxLeaves: phase C alone, the acc of each
// walker read back from `accepted` (written by the launch before it on
// the same stream).
__global__ void __launch_bounds__(kThreads) accept_blobs_only_kernel(
    const bool* __restrict__ accepted, int ng, int split, int tile,
    const __grid_constant__ BlobLeaves leaves) {
  __shared__ bool s_acc[kThreads];
  const int t = threadIdx.x;
  const int t0 = blockIdx.x * tile;
  const int cnt = min(tile, ng - t0);
  const int64_t lo = static_cast<int64_t>(split) * ng;
  if (t < cnt) s_acc[t] = accepted[lo + t0 + t];
  __syncthreads();
  select_blobs(leaves, s_acc, t0, lo, cnt, t);
}

// Leaves [l0, min(l0 + kMaxLeaves, n)) of `all` as one launch's struct.
BlobLeaves leaf_group(const BlobLeaf* all, int n, int l0) {
  BlobLeaves g{};
  g.n = n - l0 < kMaxLeaves ? n - l0 : kMaxLeaves;
  for (int l = 0; l < g.n; ++l) g.leaf[l] = all[l0 + l];
  return g;
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/accept_kernel.py).  Every
// pointer but `leaves` is a device pointer; log_u == nullptr selects the
// in-kernel Philox stream, at offset *offset_dev + offset (offset alone
// when offset_dev is null); count == nullptr skips the acceptance count.
// tile, grid, vec, stage and smem are the launch plan of ops/_wrap.py
// tile_plan: vec != 0 promises that every tile's spans of q and coords
// are 16-byte aligned, stage != 0 that every tile's q span is, and smem
// is the dynamic shared memory (4 * tile * nd when staged, else 0).
// `leaves` is a host array of `nleaves` blob-leaf descriptors (each
// with row_bytes > 0); it is copied into the launches' parameters, so
// the host array may go once this returns.  Returns cudaGetLastError()
// after the launches (1 + ceil((nleaves - kMaxLeaves) / kMaxLeaves) of
// them with more than kMaxLeaves leaves, else 1).
extern "C" int emcee_accept_select(
    const float* q, const float* factor, const float* lp_q, float* coords,
    float* log_prob, bool* accepted, int* count, const float* log_u, int ng,
    int nd, int split, int tile, int grid, int vec, int stage, int smem,
    unsigned long long seed, const long long* offset_dev,
    unsigned long long offset, const BlobLeaf* leaves, int nleaves,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* cnt = reinterpret_cast<int32_t*>(count);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  if (nleaves == 0) {
    auto kernel =
        vec ? (stage ? accept_select_kernel<true, true, NoBlobs>
                     : accept_select_kernel<true, false, NoBlobs>)
            : (stage ? accept_select_kernel<false, true, NoBlobs>
                     : accept_select_kernel<false, false, NoBlobs>);
    kernel<<<grid, kThreads, smem, st>>>(
        q, factor, lp_q, coords, log_prob, accepted, cnt, log_u, ng, nd,
        split, tile, k0, k1, offset_dev, offset, NoBlobs{});
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel =
      vec ? (stage ? accept_select_kernel<true, true, BlobLeaves>
                   : accept_select_kernel<true, false, BlobLeaves>)
          : (stage ? accept_select_kernel<false, true, BlobLeaves>
                   : accept_select_kernel<false, false, BlobLeaves>);
  kernel<<<grid, kThreads, smem, st>>>(
      q, factor, lp_q, coords, log_prob, accepted, cnt, log_u, ng, nd, split,
      tile, k0, k1, offset_dev, offset, leaf_group(leaves, nleaves, 0));
  for (int l0 = kMaxLeaves; l0 < nleaves; l0 += kMaxLeaves) {
    accept_blobs_only_kernel<<<grid, kThreads, 0, st>>>(
        accepted, ng, split, tile, leaf_group(leaves, nleaves, l0));
  }
  return static_cast<int>(cudaGetLastError());
}

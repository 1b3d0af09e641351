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
// The rung axis (parallel tempering, emcee_tpu/parallel/tempering.py:
// 476-541, the move vmapped over the ladder) has a kernel of its own,
// accept_rungs_kernel.  T ensembles of nw walkers lie one after the other
// in coords (T, nw, nd), log_prob, accepted and count (T, nw); q is (T,
// ng, nd), factor, lp_q and log_u (T, ng); a blob leaf's new rows are
// (T, ng, ...) and its buffer (T, nw, ...).  Rung r's split group is rows
// r*nw + split*ng .. + ng, and it draws its accept uniform under its own
// key keys[r] (a device table, ops/philox.py rung_seed).  At the tempered
// workload's shape (16 rungs x 128 walkers a split) the tiled kernel above
// ran 512 blocks of 256 threads with 4 walkers each (its plan halves the
// tile to fill the card): 4 threads of 256 held a walker, and each block
// still set up the TMA staging of 80 bytes of q (an mbarrier, a bulk
// copy, a wait and two block barriers), 2.82 us a launch against a 0.034
// us byte bound.  What bounds the launch is its chain of trips to memory,
// so the rung kernel is built for latency, as K15 is:
//   * One thread a walker, the grid's second dimension the rung, in
//     blocks of 128 (ops/_wrap.py rung_plan; in workload 4's replays
//     blocks of 32-256 were within 0.06 us of each other, 128 among the
//     fastest, and one grid over every rung's walkers, the rung found by
//     a multiply-high, 0.03 us slower), no shared memory and no barrier.
//   * One trip to memory before the stores: each thread issues the loads
//     of its key and the offset word (when it draws), its factor, lp_q,
//     log_prob, acceptance count and injected log_u, its q row (up to
//     kRowRegs floats) and its rows of the register leaves (up to
//     kRegLeaves leaves of 1 to kLeafUnits 4-byte units: the tempered
//     logL and logP and short user rows such as 2 logL and x) before the
//     Philox block completes; then it decides, and an accepted walker
//     stores everything from registers (its count too: the count is read
//     with the rest, not after the decision).
//   * What does not fit keeps a path that is correct for any nd and any
//     leaf, chosen by the plan: a q row longer than kRowRegs floats, and
//     every other leaf (ops/accept_kernel.py leaf_plan(..., rungs=True)),
//     is copied by the accepted walker's thread after the decision, unit
//     by unit (the largest of 16, 8, 4, 2, 1 bytes dividing its bases and
//     row), from the launch's parameters; leaves past kMaxLeaves are
//     copied by the blob-only kernel, in tiles of kThreads walkers of
//     every rung's split.
//   * __launch_bounds__(kRungThreads, 1): occupancy does not limit this
//     kernel, so the registers the leaf rows need (96) are not cut into
//     spills (the K15 lesson).
// The arithmetic is the tiled kernel's (the same accept uniform, the same
// operations in lnpdiff), so both equal the plain version bit for bit.
// The single-ensemble launches keep the tiled kernel, whose machine code
// is that of before the rung axis was added.
//
// Blob leaves (emcee_tpu/moves/red_blue.py:200-202 and :323-344, the
// tree_where and write-back of every blob leaf with the coordinates'
// mask; moves/base.py:103-126 for MH and Gaussian).  A leaf is any dtype
// of any row shape: to the kernel it is a byte row per walker.  Each
// leaf reaches the kernel as a descriptor in a struct passed by value
// (the split's new rows, the ensemble buffer, the row's bytes and an
// access unit), so a graph records it with the launch.  The unit is the
// largest of 16, 8, 4, 2, 1 bytes that divides both bases and the row
// (ops/accept_kernel.py blob_unit), so no unit straddles two walkers'
// rows.
//
// What bounds the blob leaves on an H100: latency and instructions, not
// bytes.  Their bytes are few (the main path's three 4-byte leaves: 1.5
// KB a tile of 128 walkers, 0.2 us of the launch's 0.8 us byte bound).
// The first design read each leaf's source rows after the accept
// decision, leaf after leaf, each leaf's descriptor by an indexed load
// from the kernel parameters, and its units with a division each: +1.5
// us for three leaves.  Staging every leaf's tile span in shared memory
// by a bulk copy at block start took the loads off the critical path but
// left the per-leaf work on it (+0.7 us; PERF.md).  Two paths now,
// chosen by the launch plan (ops/accept_kernel.py leaf_plan):
//   * Row leaves (Blobs = BlobRows<U>): up to kRowLeaves leaves whose rows
//     are each one 4- or 8-byte unit (scalar blobs: the main path's
//     three).  Each walker's thread loads its row of every leaf into
//     registers at block start, with static parameter offsets, so the
//     loads overlap the Philox draw (rejected rows are read too), and
//     stores them beside its log_prob when it accepts: no phase C, no
//     shared memory, no barrier.  chip_smoke.py phase 11 times it against
//     phase C on the main path's leaves.
//   * Any other leaves (Blobs = BlobLeaves), phase C after phase B:
//     - At block start the last warps' threads copy the leaf table (32
//       bytes a leaf) from the parameters into shared memory, a word a
//       thread; phase C reads a leaf's fields from there.
//     - Phase C copies each leaf's accepted rows from the source, leaf
//       after leaf.  A thread walks its units as (walker, unit in the
//       row), stepped by the block's width with a multiplier the plan
//       computes, so no unit needs a division.
// A launch takes up to kMaxLeaves leaves; the entry point launches the
// rest in groups of kMaxLeaves by a blob-only kernel that reads the
// split's `accepted`.  Without blob leaves the entry point launches the
// blob-free instantiation (Blobs = NoBlobs, an empty struct): phases A
// and B and its staging of q are the same source, phase C is compiled
// out, and its machine code is the same as before phase C was added.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bulk_copy.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;  // TILE_MAX in ops/_wrap.py
constexpr int kMaxLeaves = 16;  // BLOB_CAPACITY in ops/accept_kernel.py
constexpr int kRowLeaves = 4;  // ROW_LEAVES in ops/accept_kernel.py
// The rung kernel: the largest block, the leaves through registers, the
// 4-byte units of such a leaf's row, and the floats of a q row that go
// through registers (RUNG_THREADS_LIMIT and RUNG_ROW_REGS in ops/_wrap.py,
// RUNG_REG_LEAVES and RUNG_LEAF_UNITS in ops/accept_kernel.py).
constexpr int kRungThreads = 512;
constexpr int kRegLeaves = 4;
constexpr int kLeafUnits = 8;
constexpr int kRowRegs = 8;

}  // namespace

// One blob leaf (the layout of ops/accept_kernel.py _BlobLeaf): the
// split's new rows (ng, *shape), the ensemble buffer (nwalkers, *shape),
// the bytes of one walker's row, the access unit in bytes, and
// ceil(2^24 / units a row), which divides a unit index below 2^8 by the
// units of a row exactly as (k * inv) >> 24.
struct BlobLeaf {
  const unsigned char* src;
  unsigned char* dst;
  int row_bytes;
  int unit;
  uint32_t inv_upr;
};

namespace {

struct BlobLeaves {
  int n;
  BlobLeaf leaf[kMaxLeaves];
};

// Up to kRowLeaves leaves whose rows are each one unit U (4 or 8 bytes:
// scalar blobs), read into registers.
template <typename U>
struct BlobRows {
  using Unit = U;
  int n;
  BlobLeaf leaf[kRowLeaves];
};

template <typename T>
struct IsRows : std::false_type {};
template <typename U>
struct IsRows<BlobRows<U>> : std::true_type {};

// A row-leaf kernel's register of each leaf (a byte elsewhere, unused).
template <typename T>
struct RowUnit {
  using type = unsigned char;
};
template <typename U>
struct RowUnit<BlobRows<U>> {
  using type = U;
};

// The blob kernel's copy of the launch's leaf table (read from the kernel
// parameters once a block, at block start, so phase C's reads of a leaf's
// fields are shared-memory loads and not indexed parameter loads, each of
// which can miss the constant cache).
__device__ __forceinline__ BlobLeaf* blob_table() {
  __shared__ BlobLeaf s[kMaxLeaves];
  return s;
}

// The blob-free kernel's Blobs: no leaves.
struct NoBlobs {};

// Walkers [t0, t0 + cnt) of the split, whose acc is s_acc[0, cnt): copy
// the accepted walkers' rows of one leaf, unit by unit, from new row src0
// (t0 in the rung's rows) to buffer row dst0 (the walker's row).
template <typename U>
__device__ __forceinline__ void select_leaf(const BlobLeaf& leaf,
                                            const bool* s_acc, int64_t src0,
                                            int64_t dst0, int cnt, int t) {
  const int upr = leaf.row_bytes / static_cast<int>(sizeof(U));
  const U* __restrict__ src = reinterpret_cast<const U*>(leaf.src) +
                              src0 * upr;
  U* __restrict__ dst = reinterpret_cast<U*>(leaf.dst) + dst0 * upr;
  // Unit k = t + i * kThreads is unit u of walker w's row; the step moves
  // (w, u) by (dw, du).  t and kThreads are below 2^8 + 1, so inv_upr
  // divides both by upr (kThreads in 64 bits): no unit needs a division.
  int w = static_cast<int>((static_cast<uint32_t>(t) * leaf.inv_upr) >> 24);
  int u = t - w * upr;
  const int dw = static_cast<int>(
      (static_cast<uint64_t>(kThreads) * leaf.inv_upr) >> 24);
  const int du = kThreads - dw * upr;
  for (int k = t; w < cnt; k += kThreads) {
    if (s_acc[w]) dst[k] = src[k];
    u += du;
    w += dw;
    if (u >= upr) {
      u -= upr;
      ++w;
    }
  }
}

// Phase C: the n leaves of `leaves`.
__device__ __forceinline__ void select_blobs(const BlobLeaf* leaves, int n,
                                             const bool* s_acc, int64_t src0,
                                             int64_t dst0, int cnt, int t) {
  for (int l = 0; l < n; ++l) {
    const BlobLeaf& leaf = leaves[l];
    switch (leaf.unit) {
      case 16: select_leaf<uint4>(leaf, s_acc, src0, dst0, cnt, t); break;
      case 8: select_leaf<uint2>(leaf, s_acc, src0, dst0, cnt, t); break;
      case 4: select_leaf<uint32_t>(leaf, s_acc, src0, dst0, cnt, t); break;
      case 2: select_leaf<uint16_t>(leaf, s_acc, src0, dst0, cnt, t); break;
      default: select_leaf<uint8_t>(leaf, s_acc, src0, dst0, cnt, t); break;
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
  constexpr bool kBlobs = std::is_same_v<Blobs, BlobLeaves>;
  constexpr bool kRows = IsRows<Blobs>::value;
  // Row leaves: each walker's thread reads its row of every leaf now, so
  // the loads overlap the Philox draw (rejected rows too), and stores it
  // with its decision in phase A.
  [[maybe_unused]] typename RowUnit<Blobs>::type pre[kRows ? kRowLeaves : 1];
  if constexpr (kRows) {
    using U = typename Blobs::Unit;
    if (t < cnt) {
#pragma unroll
      for (int l = 0; l < kRowLeaves; ++l) {
        if (l < blobs.n) {
          const U* src = reinterpret_cast<const U*>(blobs.leaf[l].src);
          pre[l] = src[t0 + t];
        }
      }
    }
  }
  if constexpr (kBlobs) {
    // The last warps' threads copy the leaf table from the parameters
    // into shared memory, a word a thread (at a tile of 128 they hold no
    // walker); phase C, after the __syncthreads, reads it.
    constexpr int kWords = static_cast<int>(sizeof(BlobLeaf) / 4);
    constexpr int kFirst = kThreads - kMaxLeaves * kWords;
    static_assert(kFirst >= 0, "one word a thread");
    if (t >= kFirst && t - kFirst < blobs.n * kWords) {
      reinterpret_cast<uint32_t*>(blob_table())[t - kFirst] =
          reinterpret_cast<const uint32_t*>(blobs.leaf)[t - kFirst];
    }
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
      if constexpr (kRows) {
        // Row leaves: the walker's own rows, stored beside its log_prob.
        using U = typename Blobs::Unit;
#pragma unroll
        for (int l = 0; l < kRowLeaves; ++l) {
          if (l < blobs.n) {
            reinterpret_cast<U*>(blobs.leaf[l].dst)[row] = pre[l];
          }
        }
      }
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
  if constexpr (kBlobs) {
    select_blobs(blob_table(), blobs.n, s_acc, t0, lo + t0, cnt, t);
  }
}

// Leaves beyond the first kMaxLeaves: phase C alone, the acc of each
// walker read back from `accepted` (written by the launch before it on
// the same stream).
__global__ void __launch_bounds__(kThreads) accept_blobs_only_kernel(
    const bool* __restrict__ accepted, int ng, int split, int tile, int nw,
    const __grid_constant__ BlobLeaves leaves) {
  __shared__ bool s_acc[kThreads];
  const int t = threadIdx.x;
  const int t0 = blockIdx.x * tile;
  const int cnt = min(tile, ng - t0);
  const int64_t rs = static_cast<int64_t>(blockIdx.y) * ng;
  const int64_t rd = static_cast<int64_t>(blockIdx.y) * nw;
  const int64_t lo = static_cast<int64_t>(split) * ng;
  if (t < cnt) s_acc[t] = accepted[rd + lo + t0 + t];
  __syncthreads();
  select_blobs(leaves.leaf, leaves.n, s_acc, rs + t0, rd + lo + t0, cnt, t);
}

// Leaves [l0, min(l0 + kMaxLeaves, n)) of `all` as one launch's struct.
BlobLeaves leaf_group(const BlobLeaf* all, int n, int l0) {
  BlobLeaves g{};
  g.n = n - l0 < kMaxLeaves ? n - l0 : kMaxLeaves;
  for (int l = 0; l < g.n; ++l) g.leaf[l] = all[l0 + l];
  return g;
}

// All n (<= kRowLeaves) leaves of `all` as a row-leaf launch's struct.
template <typename U>
BlobRows<U> row_group(const BlobLeaf* all, int n) {
  BlobRows<U> g{};
  g.n = n;
  for (int l = 0; l < n; ++l) g.leaf[l] = all[l];
  return g;
}

template <typename Blobs>
void launch_select(int vec, int stage, dim3 grid, int smem, cudaStream_t st,
                   const float* q, const float* factor, const float* lp_q,
                   float* coords, float* log_prob, bool* accepted,
                   int32_t* count, const float* log_u, int ng, int nd,
                   int split, int tile, uint32_t k0, uint32_t k1,
                   const long long* offset_dev, unsigned long long offset,
                   const Blobs& blobs) {
  auto kernel = vec ? (stage ? accept_select_kernel<true, true, Blobs>
                             : accept_select_kernel<true, false, Blobs>)
                    : (stage ? accept_select_kernel<false, true, Blobs>
                             : accept_select_kernel<false, false, Blobs>);
  kernel<<<grid, kThreads, smem, st>>>(q, factor, lp_q, coords, log_prob,
                                       accepted, count, log_u, ng, nd, split,
                                       tile, k0, k1, offset_dev, offset,
                                       blobs);
}

// Copy one row of a leaf of `row_bytes` bytes, unit U by unit, from new
// row `from` to buffer row `to`.
template <typename U>
__device__ __forceinline__ void copy_row(const BlobLeaf& leaf, int64_t from,
                                         int64_t to) {
  const int n = leaf.row_bytes / static_cast<int>(sizeof(U));
  const U* __restrict__ s = reinterpret_cast<const U*>(leaf.src) + from * n;
  U* __restrict__ d = reinterpret_cast<U*>(leaf.dst) + to * n;
  for (int u = 0; u < n; ++u) d[u] = s[u];
}

// The rung kernel's leaves: leaf[0, n_reg) through registers (rows of
// 1 to kLeafUnits 4-byte units at 4-byte aligned bases), leaf[n_reg, n)
// copied by an accepted walker's thread after the decision.
struct RungLeaves {
  int n_reg;
  int n;
  BlobLeaf leaf[kMaxLeaves];
};

// K2 with the rung axis: one thread a walker of one rung's split (see the
// head comment).  kRegRow: the walker's q row (nd <= kRowRegs) is loaded
// into registers before the decision, else copied after it.  kLeaves:
// the launch carries blob leaves.
template <bool kRegRow, bool kLeaves>
__global__ void __launch_bounds__(kRungThreads, 1) accept_rungs_kernel(
    const float* __restrict__ q, const float* __restrict__ factor,
    const float* __restrict__ lp_q, float* __restrict__ coords,
    float* __restrict__ log_prob, bool* __restrict__ accepted,
    int32_t* __restrict__ count, const float* __restrict__ log_u, int ng,
    int nd, int split, int nw, uint32_t k0, uint32_t k1,
    const long long* __restrict__ keys,
    const long long* __restrict__ offset_dev, unsigned long long offset_inc,
    const __grid_constant__ RungLeaves leaves) {
  const bool drawn = log_u == nullptr;
  const uint64_t offset = drawn ? philox_offset(offset_dev, offset_inc) : 0;
  // Walker i of rung r's split: `from` is its row in the split inputs
  // (q, factor, lp_q, log_u, the leaves' new rows: T x ng), `row` its row
  // in the ensemble buffers (T x nw).
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ng) return;  // no barrier below
  const int r = blockIdx.y;
  const int64_t from = static_cast<int64_t>(r) * ng + i;
  const int64_t row = static_cast<int64_t>(r) * nw +
                      static_cast<int64_t>(split) * ng + i;
  // One trip to memory: every load is issued before the decision.
  if (drawn && keys != nullptr) {
    const auto key = static_cast<unsigned long long>(keys[r]);
    k0 = static_cast<uint32_t>(key);
    k1 = static_cast<uint32_t>(key >> 32);
  }
  const float f = factor[from];
  const float lpq = lp_q[from];
  const float lp = log_prob[row];
  const float lu_in = drawn ? 0.0f : log_u[from];
  const int32_t n_acc = count != nullptr ? count[row] : 0;
  [[maybe_unused]] float x[kRegRow ? kRowRegs : 1];
  if constexpr (kRegRow) {
    const float* __restrict__ qr = q + from * nd;
#pragma unroll
    for (int d = 0; d < kRowRegs; ++d) {
      if (d < nd) x[d] = qr[d];
    }
  }
  [[maybe_unused]] uint32_t pre[kLeaves ? kRegLeaves : 1]
                               [kLeaves ? kLeafUnits : 1];
  if constexpr (kLeaves) {
#pragma unroll
    for (int l = 0; l < kRegLeaves; ++l) {
      if (l < leaves.n_reg) {
        const int units = leaves.leaf[l].row_bytes >> 2;
        const uint32_t* __restrict__ s =
            reinterpret_cast<const uint32_t*>(leaves.leaf[l].src) +
            from * units;
#pragma unroll
        for (int u = 0; u < kLeafUnits; ++u) {
          if (u < units) pre[l][u] = s[u];
        }
      }
    }
  }
  float lu = lu_in;
  if (drawn) {
    const uint4 w = philox_at(static_cast<uint32_t>(i),
                              static_cast<uint32_t>(split), offset, k0, k1);
    lu = logf(philox_uniform(w.y));
  }
  const bool acc = lu < __fsub_rn(__fadd_rn(f, lpq), lp);
  accepted[row] = acc;
  if (!acc) return;
  // The stores, from registers where the plan loaded the rows.
  log_prob[row] = lpq;
  if (count != nullptr) count[row] = n_acc + 1;
  float* __restrict__ c = coords + row * nd;
  if constexpr (kRegRow) {
#pragma unroll
    for (int d = 0; d < kRowRegs; ++d) {
      if (d < nd) c[d] = x[d];
    }
  } else {
    const float* __restrict__ qr = q + from * nd;
    for (int d = 0; d < nd; ++d) c[d] = qr[d];
  }
  if constexpr (kLeaves) {
#pragma unroll
    for (int l = 0; l < kRegLeaves; ++l) {
      if (l < leaves.n_reg) {
        const int units = leaves.leaf[l].row_bytes >> 2;
        uint32_t* __restrict__ dst =
            reinterpret_cast<uint32_t*>(leaves.leaf[l].dst) + row * units;
#pragma unroll
        for (int u = 0; u < kLeafUnits; ++u) {
          if (u < units) dst[u] = pre[l][u];
        }
      }
    }
    for (int l = leaves.n_reg; l < leaves.n; ++l) {
      const BlobLeaf& leaf = leaves.leaf[l];
      switch (leaf.unit) {
        case 16: copy_row<uint4>(leaf, from, row); break;
        case 8: copy_row<uint2>(leaf, from, row); break;
        case 4: copy_row<uint32_t>(leaf, from, row); break;
        case 2: copy_row<uint16_t>(leaf, from, row); break;
        default: copy_row<uint8_t>(leaf, from, row); break;
      }
    }
  }
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
// the host array may go once this returns.  row_unit 4 or 8 (leaf_plan's
// choice) promises at most kRowLeaves leaves whose rows are each one
// unit of that many bytes: they are read into registers.  Returns
// cudaGetLastError() after the launches (1 + ceil((nleaves - kMaxLeaves)
// / kMaxLeaves) of them with more than kMaxLeaves leaves, else 1).
extern "C" int emcee_accept_select(
    const float* q, const float* factor, const float* lp_q, float* coords,
    float* log_prob, bool* accepted, int* count, const float* log_u, int ng,
    int nd, int split, int tile, int grid, int vec, int stage, int smem,
    unsigned long long seed, const long long* offset_dev,
    unsigned long long offset, const BlobLeaf* leaves, int nleaves,
    int row_unit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* cnt = reinterpret_cast<int32_t*>(count);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  const dim3 blocks(grid, 1);
  auto go = [&](const auto& blobs) {
    launch_select(vec, stage, blocks, smem, st, q, factor, lp_q, coords,
                  log_prob, accepted, cnt, log_u, ng, nd, split, tile, k0, k1,
                  offset_dev, offset, blobs);
  };
  if (nleaves == 0) {
    go(NoBlobs{});
  } else if (row_unit == 4) {
    go(row_group<uint32_t>(leaves, nleaves));
  } else if (row_unit == 8) {
    go(row_group<uint2>(leaves, nleaves));
  } else {
    go(leaf_group(leaves, nleaves, 0));
  }
  for (int l0 = kMaxLeaves; row_unit == 0 && l0 < nleaves; l0 += kMaxLeaves) {
    accept_blobs_only_kernel<<<blocks, kThreads, 0, st>>>(
        accepted, ng, split, tile, 0, leaf_group(leaves, nleaves, l0));
  }
  return static_cast<int>(cudaGetLastError());
}

// The rung axis: ntemps rungs of nw walkers one after the other in the
// ensemble buffers (coords (ntemps, nw, nd), log_prob, accepted and count
// (ntemps, nw)), ntemps blocks of ng rows in q (ntemps, ng, nd) and the
// other split inputs (ntemps, ng); a blob leaf's new rows (ntemps, ng,
// ...) and buffer (ntemps, nw, ...).  keys == nullptr draws every rung
// under seed, else rung r under keys[r] (a device table of ntemps keys).
// threads and reg_row are the launch plan of ops/_wrap.py rung_plan:
// threads a block (a multiple of 32 up to kRungThreads), one walker a
// thread, and reg_row != 0 (nd <= kRowRegs) to read the q rows into
// registers before the decision.  The first n_reg (<= kRegLeaves) of the
// `nleaves` leaf descriptors go through registers: each with a row of
// 1 to kLeafUnits 4-byte units and a unit of 4 or more (ops/accept_kernel.py
// leaf_plan(..., rungs=True)).  Leaves past kMaxLeaves take blob-only
// launches over every rung's split.  Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue, and no launch, for arguments
// out of range).
extern "C" int emcee_accept_rungs(
    const float* q, const float* factor, const float* lp_q, float* coords,
    float* log_prob, bool* accepted, int* count, const float* log_u, int ng,
    int nd, int split, int nw, int ntemps, int threads, int reg_row,
    const long long* keys, unsigned long long seed,
    const long long* offset_dev, unsigned long long offset,
    const BlobLeaf* leaves, int nleaves, int n_reg, void* stream) {
  if (ntemps < 1 || ntemps > 65535 || threads < 32 ||
      threads > kRungThreads || threads % 32 != 0 || nleaves < 0 ||
      n_reg < 0 || n_reg > kRegLeaves || n_reg > nleaves ||
      (reg_row && nd > kRowRegs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < n_reg; ++l) {
    if (leaves[l].unit < 4 || leaves[l].row_bytes % 4 != 0 ||
        leaves[l].row_bytes < 4 || leaves[l].row_bytes > 4 * kLeafUnits) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* cnt = reinterpret_cast<int32_t*>(count);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  RungLeaves g{};
  g.n_reg = n_reg;
  g.n = nleaves < kMaxLeaves ? nleaves : kMaxLeaves;
  for (int l = 0; l < g.n; ++l) g.leaf[l] = leaves[l];
  auto kernel = reg_row ? (nleaves ? accept_rungs_kernel<true, true>
                                   : accept_rungs_kernel<true, false>)
                        : (nleaves ? accept_rungs_kernel<false, true>
                                   : accept_rungs_kernel<false, false>);
  const dim3 blocks((ng + threads - 1) / threads, ntemps);
  kernel<<<blocks, threads, 0, st>>>(q, factor, lp_q, coords, log_prob,
                                     accepted, cnt, log_u, ng, nd, split, nw,
                                     k0, k1, keys, offset_dev, offset, g);
  // The blob-only kernel takes tiles of up to kThreads walkers (its shared
  // acc array and its division-free walk hold no more).
  const dim3 tiles((ng + kThreads - 1) / kThreads, ntemps);
  for (int l0 = kMaxLeaves; l0 < nleaves; l0 += kMaxLeaves) {
    accept_blobs_only_kernel<<<tiles, kThreads, 0, st>>>(
        accepted, ng, split, kThreads, nw, leaf_group(leaves, nleaves, l0));
  }
  return static_cast<int>(cudaGetLastError());
}

// K16: the shuffled split's group order, each segment's stable sort of its
// Philox keys.
//
// Replaces the permutation and strided grouping that XLA fuses into the
// shuffled proposal of the JAX package (emcee_tpu/moves/red_blue.py:218-219,
// jax.random.permutation and perm.reshape(ng, nsplits).T), vmapped over
// the rungs of a ladder by emcee_tpu/parallel/tempering.py:538.  There is
// no Pallas kernel behind it.  The port's plain version
// (ops/shuffle_kernel.py group_order_plain) is torch.argsort(stable=True)
// followed by a transpose, a copy and the add of each rung's base.
//
// A segment is one ensemble (or one rung of a ladder) of n walkers, the
// segments one after the other.  Its keys are Philox word 3 of walker
// lanes 0..n-1 (ops/philox.py walker_words / rung_words, K14), int64
// words holding values below 2^32.  perm is the stable argsort of the
// keys: ascending by (key, index), so equal keys keep their index order,
// exactly as torch.argsort(stable=True) gives it.  Sorted position
// p = i * nsplits + j is member i of group j, and the kernel writes the
// flat rows in group order directly:
//     order[r * n + j * ng + i] = r * n + perm_r[i * nsplits + j],
// ng = n / nsplits, so no transpose, copy or add follows.
//
// The sort key is one 64-bit word (key << 32 | index): the words are
// distinct, so any correct sort of them is the stable sort of the keys.
// Where the caller gives `sorted`, the last launch also writes each
// segment's words in sorted order, sorted[r * n + p] (R-hat's ranks,
// csrc/rhat.cu, read their keys and positions so, contiguously); the order
// is then optional.
//
// Two routes (ops/shuffle_kernel.py shuffle_plan), the segment on the
// grid's second dimension:
//   * rank: a segment of at most kRankMax walkers.  Each block loads the
//     segment's words into shared memory and each of its threads ranks
//     one word by counting the words below it (every thread reads the
//     same word at a time, a broadcast), so the position needs no network
//     and no sync after the load.  One launch; workload 4's 16 rungs x
//     256 walkers are 64 blocks of 64 threads.  A bitonic block took 6.24
//     us a launch there on an H100 80GB HBM3 at 700 W, the latency of its
//     36 synced stages.
//   * radix: a longer segment is sorted by a stable least-significant-
//     digit radix sort of its 32-bit keys, four 8-bit digits, the index
//     carried as the word's low half (Merrill & Grimshaw 2011; one sweep a
//     digit with a decoupled look-back, Adinets & Merrill 2022,
//     "Onesweep").  A stable sort by key of the words in index order is
//     the sort of the distinct words, so it gives the rank route's order
//     and torch.argsort(stable=True)'s.  Five launches:
//     - radix_hist_kernel: `hist` blocks a segment read its int64 keys
//       once and count all four digits in shared memory; each block
//       writes its four 256-bin counts (no global atomics, so the sums
//       are the same on every run).  It also zeroes the first pass's
//       look-back words, so a replayed graph needs no memset.
//     - radix_pass_kernel, one launch a digit, least significant first:
//       block x of segment r takes tile x, so the look-back makes
//       progress only where blocks start in index order, every tile it
//       waits on having started.  CUDA does not promise that order (MPS,
//       green contexts or preemption could break it); CUB's decoupled
//       look-back scans and rank_scan_kernel in csrc/rhat.cu assume it
//       too, and an atomic ticket a tile, which would not, put one more
//       trip to memory on every pass's critical path.  The block loads
//       the tile (pass 0:
//       the int64 keys, the index from the position; then the words the
//       pass before wrote), and ranks its words by digit stably: warp w
//       takes the tile's w-th run of 32 kItems words, 32 at a time in
//       order, each word's rank among the warp's words of its digit from
//       __match_any_sync (the lanes below with the same digit) and a
//       running count per (warp, digit) in shared memory; a thread a
//       digit then turns the warps' counts into offsets.  The tile's
//       count of each digit is published at once in a 32-bit status word
//       (a flag and the value), and its prefix over the tiles before is
//       found by a decoupled look-back (kLookBack statuses a step, in
//       flight at once, relaxed loads at the GPU's scope); tile 0 starts each digit at its bucket offset, the sum of
//       the histogram blocks' counts of the digits below, kBucketBatch
//       counts in flight at once (every tile waits on tile 0's prefix, so
//       its sum is on every pass's critical path).  The words are placed in shared memory in the
//       tile's digit order and written out in that order, so each digit's
//       run is contiguous.  Passes ping-pong through the scratch (2 T n
//       words); the last writes the order and the sorted words directly.
//       Each pass zeroes its tile's look-back words of the next pass (the
//       status buffers alternate).
//     A one-block bitonic sort of a segment was slower than the radix
//     route at every length from 2560 to 4096 walkers on an H100 80GB HBM3
//     at 700 W, so every segment above kRankMax takes the radix route.
//
// What bounds it on an H100: latency, and bytes on the radix route's long
// segments.  At workload 4's shape the inputs are 32 KB of keys and the
// output 32 KB of rows (~0.02 us at 3.35 TB/s); a rank is 256
// shared-memory compares a thread.  At one ensemble of 1e5 walkers the
// keys and rows are 1.6 MB (~0.5 us); the radix route is five launches,
// each a load, 32-way ranks and one look-back.  At R-hat's 6e7 keys a
// parameter the function needs 480 MB in and 480 MB out (0.287 ms); the
// radix route moves ~4.3 GB (the keys read twice, four passes of 8-byte
// words read and written: ~1.29 ms).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The longest segment the rank route takes (RANK_MAX), 16 KB of words,
// and its block (RANK_THREADS): a thread a word.
constexpr int kRankMax = 2048;
constexpr int kRankThreads = 64;

// The radix route (RADIX_THREADS, RADIX_PASSES, RADIX_LOOKBACK): blocks
// of 256 threads, a thread a digit in the look-back; four 8-bit digits;
// the statuses a look-back step reads at once.
constexpr int kRadixThreads = 256;
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr int kLookBack = 16;
// Histogram blocks' counts tile 0 loads at once.
constexpr int kBucketBatch = 32;
// A look-back status word: the flag in bits 30-31, the count below
// (counts stay below n < 2^29).
constexpr uint32_t kAgg = 1u << 30;
constexpr uint32_t kPrefix = 2u << 30;
constexpr uint32_t kValue = kAgg - 1;

// Member i of group j of segment r (sorted position p = i * nsplits + j)
// is walker `idx` of the segment, its sort word w; the order and the
// sorted words where given.
__device__ __forceinline__ void write_order(long long* __restrict__ order,
                                            unsigned long long* __restrict__
                                                sorted,
                                            int r, int n, int nsplits, int ng,
                                            int p, uint64_t w) {
  const long long base = static_cast<long long>(r) * n;
  if (sorted != nullptr) sorted[base + p] = w;
  if (order == nullptr) return;
  const int i = p / nsplits;
  const int j = p - i * nsplits;
  order[base + static_cast<long long>(j) * ng + i] =
      base + static_cast<long long>(static_cast<uint32_t>(w));
}

// The sort word of walker i of a segment's keys: (key << 32) | i.
__device__ __forceinline__ uint64_t sort_word(const long long* __restrict__ k,
                                              int i) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(k[i])) << 32) |
         static_cast<uint32_t>(i);
}

// The rank route: block blockIdx.x of segment blockIdx.y ranks the
// segment's words [blockIdx.x * kRankThreads, +kRankThreads).
__global__ void __launch_bounds__(kRankThreads) group_rank_kernel(
    const long long* __restrict__ keys, long long* __restrict__ order,
    unsigned long long* __restrict__ sorted, int n, int nsplits, int ng) {
  __shared__ unsigned long long s[kRankMax];
  const int r = blockIdx.y;
  const long long* k = keys + static_cast<long long>(r) * n;
  for (int i = threadIdx.x; i < n; i += kRankThreads) s[i] = sort_word(k, i);
  __syncthreads();
  const int e = blockIdx.x * kRankThreads + threadIdx.x;
  if (e >= n) return;
  const uint64_t v = s[e];
  int p = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) p += s[j] < v;
  write_order(order, sorted, r, n, nsplits, ng, p, v);
}

// The radix route's buffers and shape, as emcee_group_order lays them out.
struct RadixArgs {
  const long long* keys;          // (T, n) int64 keys
  unsigned long long* buf[2];     // the passes' words, T n each
  long long* order;               // the order, or null
  unsigned long long* sorted;     // the sorted words, or null
  uint32_t* status;               // [2][T][tiles][kBins] look-back words
  uint32_t* part;                 // [T][hist][kPasses][kBins] digit counts
  int T, n, nsplits, ng;
  int tiles;                      // tiles a segment
  int hist;                       // histogram blocks a segment
  int per_hist;                   // keys a histogram block
};

// The histogram launch: block blockIdx.x of segment blockIdx.y counts the
// four digits of its keys; the grid zeroes the first pass's status words.
__global__ void __launch_bounds__(kRadixThreads) radix_hist_kernel(
    const RadixArgs a) {
  __shared__ uint32_t h[kPasses * kBins];
  const int t = threadIdx.x;
  for (int i = t; i < kPasses * kBins; i += kRadixThreads) h[i] = 0;
  const long long me = static_cast<long long>(blockIdx.y) * gridDim.x +
                       blockIdx.x;
  const long long step =
      static_cast<long long>(gridDim.x) * gridDim.y * kRadixThreads;
  const long long words = static_cast<long long>(a.T) * a.tiles * kBins;
  for (long long i = me * kRadixThreads + t; i < words; i += step) {
    a.status[i] = 0;
  }
  __syncthreads();
  const long long* k = a.keys + static_cast<long long>(blockIdx.y) * a.n;
  const int lo = blockIdx.x * a.per_hist;
  const int hi = min(a.n, lo + a.per_hist);
#pragma unroll 8
  for (int e = lo + t; e < hi; e += kRadixThreads) {
    const uint32_t key = static_cast<uint32_t>(k[e]);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      atomicAdd(&h[p * kBins + ((key >> (8 * p)) & (kBins - 1))], 1u);
    }
  }
  __syncthreads();
  uint32_t* out = a.part + (static_cast<long long>(blockIdx.y) * a.hist +
                            blockIdx.x) * (kPasses * kBins);
  for (int i = t; i < kPasses * kBins; i += kRadixThreads) out[i] = h[i];
}

// The exclusive sum of v over the block's threads in thread order;
// s_warp holds kRadixWarps words, used by no other call.
__device__ __forceinline__ uint32_t block_exclusive(uint32_t v,
                                                    uint32_t* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  uint32_t before = 0;
#pragma unroll
  for (int w = 0; w < kRadixWarps; ++w) before += w < warp ? s_warp[w] : 0;
  return before + x - v;
}

__device__ __forceinline__ void publish(uint32_t* p, uint32_t v) {
  atomicExch(p, v);
}

// The count of this thread's digit in the tiles before `tile`, plus the
// digit's bucket offset: the tiles' status words st[k * kBins], read from
// the nearest, kLookBack at a time, and summed until one holds a prefix.
__device__ __forceinline__ uint32_t look_back(const uint32_t* st, int tile) {
  uint32_t sum = 0;
  int k = tile;  // the tiles below k are still to be summed
  while (true) {
    uint32_t s[kLookBack];
#pragma unroll
    for (int j = 0; j < kLookBack; ++j) {
      s[j] = 0u;
      if (k - 1 - j >= 0) {
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                     : "=r"(s[j])
                     : "l"(st + static_cast<long long>(k - 1 - j) * kBins));
      }
    }
    int j = 0;
#pragma unroll
    for (; j < kLookBack; ++j) {
      if ((s[j] & (kAgg | kPrefix)) == 0) break;  // not yet published
      sum += s[j] & kValue;
      if (s[j] & kPrefix) return sum;
    }
    k -= j;
  }
}

// One pass of the radix route over digit `pass` (bits 8 pass .. 8 pass +
// 7 of the key): tile blockIdx.x of segment blockIdx.y.
template <int kItems, bool kFirst, bool kLast>
__global__ void __launch_bounds__(kRadixThreads) radix_pass_kernel(
    const RadixArgs a, const int pass) {
  constexpr int kTile = kRadixThreads * kItems;
  __shared__ unsigned long long s_words[kTile];
  __shared__ uint32_t s_count[kRadixWarps][kBins];
  __shared__ uint32_t s_scan[2][kRadixWarps];
  __shared__ uint32_t s_local[kBins];
  __shared__ int s_dst[kBins];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  for (int i = t; i < kRadixWarps * kBins; i += kRadixThreads) {
    (&s_count[0][0])[i] = 0;
  }
  __syncthreads();
  const long long seg = static_cast<long long>(r) * a.n;
  const int base = tile * kTile + warp * (32 * kItems);
  const int shift = 32 + 8 * pass;
  // Pass 0 writes buf[0], pass 1 buf[1], pass 2 buf[0].
  const unsigned long long* src = (pass & 1) ? a.buf[0] : a.buf[1];
  uint64_t w[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = base + i * 32 + lane;
    w[i] = 0;
    if (e < a.n) w[i] = kFirst ? sort_word(a.keys + seg, e) : src[seg + e];
  }
  // Each word's rank among the warp's words of its digit, in order.
  const uint32_t lanes_below = (1u << lane) - 1;
  uint32_t rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = base + i * 32 + lane < a.n;
    const uint32_t d =
        valid ? static_cast<uint32_t>(w[i] >> shift) & (kBins - 1) : kBins;
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const uint32_t c = valid ? s_count[warp][d] : 0;
    rank[i] = c + __popc(peers & lanes_below);
    __syncwarp();
    if (valid && (peers & lanes_below) == 0) {
      s_count[warp][d] = c + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // Thread t is digit t: the warps' offsets and the tile's count.
  uint32_t cnt = 0;
#pragma unroll
  for (int v = 0; v < kRadixWarps; ++v) {
    const uint32_t c = s_count[v][t];
    s_count[v][t] = cnt;
    cnt += c;
  }
  uint32_t* st = a.status +
                 (static_cast<long long>(pass & 1) * a.T + r) * a.tiles *
                     kBins + t;
  if (tile > 0) publish(st + static_cast<long long>(tile) * kBins, kAgg | cnt);
  const uint32_t local = block_exclusive(cnt, s_scan[0]);
  uint32_t before;
  if (tile == 0) {
    // The digit's bucket offset: the counts of the digits below it.
    const uint32_t* pp = a.part + static_cast<long long>(r) * a.hist *
                                      (kPasses * kBins) + pass * kBins + t;
    uint32_t total = 0;
    for (int b0 = 0; b0 < a.hist; b0 += kBucketBatch) {
      uint32_t c[kBucketBatch];
#pragma unroll
      for (int j = 0; j < kBucketBatch; ++j) {
        c[j] = b0 + j < a.hist
                   ? pp[static_cast<long long>(b0 + j) * (kPasses * kBins)]
                   : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBucketBatch; ++j) total += c[j];
    }
    before = block_exclusive(total, s_scan[1]);
  } else {
    before = look_back(st, tile);
  }
  publish(st + static_cast<long long>(tile) * kBins, kPrefix | (before + cnt));
  if (!kLast) {
    a.status[((static_cast<long long>((pass + 1) & 1) * a.T + r) * a.tiles +
              tile) * kBins + t] = 0;
  }
  s_local[t] = local;
  s_dst[t] = static_cast<int>(before) - static_cast<int>(local);
  __syncthreads();
  // The tile in digit order in shared memory, then out in that order.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (base + i * 32 + lane < a.n) {
      const uint32_t d = static_cast<uint32_t>(w[i] >> shift) & (kBins - 1);
      s_words[s_local[d] + s_count[warp][d] + rank[i]] = w[i];
    }
  }
  __syncthreads();
  const int len = min(kTile, a.n - tile * kTile);
  unsigned long long* dst = (pass & 1) ? a.buf[1] : a.buf[0];
  for (int p = t; p < len; p += kRadixThreads) {
    const uint64_t v = s_words[p];
    const int q = s_dst[static_cast<uint32_t>(v >> shift) & (kBins - 1)] + p;
    if constexpr (kLast) {
      write_order(a.order, a.sorted, r, a.n, a.nsplits, a.ng, q, v);
    } else {
      dst[seg + q] = v;
    }
  }
}

// The four passes with tiles of kItems words a thread.
template <int kItems>
void radix_passes(const RadixArgs& a, cudaStream_t st) {
  const dim3 grid(a.tiles, a.T);
  radix_pass_kernel<kItems, true, false><<<grid, kRadixThreads, 0, st>>>(a,
                                                                        0);
  radix_pass_kernel<kItems, false, false><<<grid, kRadixThreads, 0, st>>>(
      a, 1);
  radix_pass_kernel<kItems, false, false><<<grid, kRadixThreads, 0, st>>>(
      a, 2);
  radix_pass_kernel<kItems, false, true><<<grid, kRadixThreads, 0, st>>>(a,
                                                                        3);
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/shuffle_kernel.py).  keys
// (ntemps, n) int64, order (ntemps * n) int64 and sorted (ntemps * n)
// words are device pointers, order or sorted (but not both) null for an
// output not wanted.  chunk 0 takes the rank route (n <= kRankMax); else
// the radix route with tiles of chunk = 256 x (1, 4 or 16) keys,
// threads 256 and `hist` histogram blocks a segment (1 to min(n, 65535));
// scratch then holds 2 * ntemps * n words for the passes, then 32-bit
// words: the status words (2 * ntemps * tiles * 256) and the digit counts
// (ntemps * hist * 1024), tiles = ceil(n / chunk) (radix_scratch in
// ops/shuffle_kernel.py).  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue, and no
// launch, for arguments out of range).
extern "C" int emcee_group_order(const long long* keys, long long* order,
                                 unsigned long long* sorted,
                                 unsigned long long* scratch, int ntemps,
                                 int n, int nsplits, int chunk, int threads,
                                 int hist, void* stream) {
  if (ntemps < 1 || ntemps > 65535 || n < 1 || nsplits < 1 ||
      n % nsplits != 0 || (order == nullptr && sorted == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ng = n / nsplits;
  if (chunk == 0) {
    if (n > kRankMax) return static_cast<int>(cudaErrorInvalidValue);
    group_rank_kernel<<<dim3((n + kRankThreads - 1) / kRankThreads, ntemps),
                        kRankThreads, 0, st>>>(keys, order, sorted, n,
                                               nsplits, ng);
    return static_cast<int>(cudaGetLastError());
  }
  const int items = chunk / kRadixThreads;
  if (threads != kRadixThreads || chunk % kRadixThreads != 0 ||
      (items != 1 && items != 4 && items != 16) ||
      hist < 1 || hist > 65535 || hist > n || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RadixArgs a;
  const long long words = static_cast<long long>(ntemps) * n;
  a.keys = keys;
  a.buf[0] = scratch;
  a.buf[1] = scratch + words;
  a.order = order;
  a.sorted = sorted;
  a.T = ntemps;
  a.n = n;
  a.nsplits = nsplits;
  a.ng = ng;
  a.tiles = (n + chunk - 1) / chunk;
  a.hist = hist;
  a.per_hist = (n + hist - 1) / hist;
  a.status = reinterpret_cast<uint32_t*>(scratch + 2 * words);
  a.part = a.status + 2ll * ntemps * a.tiles * kBins;
  radix_hist_kernel<<<dim3(hist, ntemps), kRadixThreads, 0, st>>>(a);
  switch (items) {
    case 1:
      radix_passes<1>(a, st);
      break;
    case 4:
      radix_passes<4>(a, st);
      break;
    default:
      radix_passes<16>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

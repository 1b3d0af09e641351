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
// distinct, so any correct sort of them is the stable sort of the keys,
// and an unstable network such as a bitonic sort serves.  Where the caller
// gives `sorted`, the last launch also writes each segment's words in
// sorted order, sorted[r * n + p] (R-hat's ranks, csrc/rhat.cu, read
// their keys and positions so, contiguously); the order is then optional.
//
// Three routes (ops/shuffle_kernel.py shuffle_plan), the segment on the
// grid's second dimension:
//   * rank: a segment of at most kRankMax walkers.  Each block loads the
//     segment's words into shared memory and each of its threads ranks
//     one word by counting the words below it (every thread reads the
//     same word at a time, a broadcast), so the position needs no network
//     and no sync after the load.  One launch; workload 4's 16 rungs x
//     256 walkers are 64 blocks of 64 threads.  A bitonic block (the
//     short route) took 6.24 us a launch there on an H100 80GB HBM3 at
//     700 W, the latency of its 36 synced stages.
//   * short: a segment of at most kChunkMax walkers is sorted in one
//     block's shared memory (a bitonic network over the next power of two,
//     padded with all-ones words, which sort last), one block a segment;
//     the block writes the order.  One launch.
//   * long: a segment longer than that is cut into chunks of `chunk`
//     walkers, each sorted so by a block (the sort words written to
//     scratch), and the sorted runs are merged pairwise, the run doubling
//     each pass, ceil(log2(chunks)) passes.  A merge pass needs no shared
//     memory and no sync across blocks: one thread a word, and since the
//     words are distinct, a word at index i of its run A goes to i plus
//     the count of words of the sibling run B below it (a binary search of
//     B), and a word of B likewise with A.  The last pass writes the
//     order.  1 + ceil(log2(ceil(n / chunk))) launches, no atomics, the
//     same words on every run.  Four runs merged at a time (three binary
//     searches stepping together a thread) took 49.8 us a call at 1e5
//     walkers, against 42.0 pairwise, on an H100 80GB HBM3 at 700 W.
//
// What bounds it on an H100: latency.  At workload 4's shape the inputs
// are 32 KB of keys and the output 32 KB of rows (~0.02 us at 3.35 TB/s);
// a rank is 256 shared-memory compares a thread, a bitonic network of 256
// words 36 synced stages of one block.  At one ensemble of 1e5 walkers the
// keys and rows are 1.6 MB (~0.5 us), and each merge pass a dependent
// chain of ~17 loads a thread.  The design keeps the short sorts in shared
// memory and every pass of the long one free of cross-block
// synchronisation.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The longest segment (and chunk) a block sorts: kChunkMax 8-byte words of
// shared memory, 32 KB, under the 48 KB a block takes without opting in
// (CHUNK_MAX in ops/shuffle_kernel.py).
constexpr int kChunkMax = 4096;
// The longest segment the rank route takes (RANK_MAX), 16 KB of words,
// and its block (RANK_THREADS): a thread a word.
constexpr int kRankMax = 2048;
constexpr int kRankThreads = 64;
constexpr int kSortThreadsMax = 1024;
// The merge pass's block (MERGE_THREADS).
constexpr int kMergeThreads = 256;

constexpr uint64_t kPad = ~0ull;

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

// Sorts chunk blockIdx.x (of `chunk` walkers, a power of two) of segment
// blockIdx.y in shared memory.  kFinal: the chunk is the whole segment,
// and the block writes the order; else it writes the chunk's sorted words
// to `words` at the chunk's place.
template <bool kFinal>
__global__ void __launch_bounds__(kSortThreadsMax) group_order_kernel(
    const long long* __restrict__ keys, long long* __restrict__ order,
    unsigned long long* __restrict__ sorted,
    unsigned long long* __restrict__ words, int n, int nsplits, int ng,
    int chunk) {
  extern __shared__ unsigned long long s[];
  const int r = blockIdx.y;
  const int c0 = blockIdx.x * chunk;
  const int len = min(chunk, n - c0);
  const long long* k = keys + static_cast<long long>(r) * n;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    s[i] = i < len ? sort_word(k, c0 + i) : kPad;
  }
  __syncthreads();
  const int half = chunk >> 1;
  for (int size = 2; size <= chunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // Pair t of this stage: lo and lo + stride, ascending where bit
        // `size` of lo is clear (all of the last merge).
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const uint64_t a = s[lo];
        const uint64_t b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    const uint64_t w = s[p];
    if constexpr (kFinal) {
      write_order(order, sorted, r, n, nsplits, ng, p, w);
    } else {
      words[static_cast<long long>(r) * n + c0 + p] = w;
    }
  }
}

// The words of `a` (m of them, ascending) below v.
__device__ __forceinline__ int below(const unsigned long long* __restrict__ a,
                                     int m, uint64_t v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One merge pass over segment blockIdx.y: sorted runs of `run` words
// (the last one shorter) merged pairwise into runs of 2 run.  kFinal: the
// pass leaves one run, and writes the order instead of the words.
template <bool kFinal>
__global__ void __launch_bounds__(kMergeThreads) group_merge_kernel(
    const unsigned long long* __restrict__ src,
    unsigned long long* __restrict__ dst, long long* __restrict__ order,
    unsigned long long* __restrict__ sorted, int n, int nsplits, int ng,
    int run) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long at = static_cast<long long>(blockIdx.y) * n;
  const unsigned long long* seg = src + at;
  const uint64_t v = seg[e];
  const int pair = 2 * run;  // below 2^31: run < n < 2^29
  const int base = e - e % pair;
  const int i = e - base;
  int p;
  if (i < run) {
    // In run A; its sibling B is [base + run, min(base + pair, n)).
    const int b0 = base + run;
    const int m = b0 < n ? min(run, n - b0) : 0;
    p = base + i + below(seg + b0, m, v);
  } else {
    // In run B; A is [base, base + run), whole.
    p = base + (i - run) + below(seg + base, run, v);
  }
  if constexpr (kFinal) {
    write_order(order, sorted, blockIdx.y, n, nsplits, ng, p, v);
  } else {
    dst[at + p] = v;
  }
}

// Merge passes for `chunks` sorted chunks: ceil(log2(chunks)).
int merge_passes(int chunks) {
  int k = 0;
  while ((1 << k) < chunks) ++k;
  return k;
}

}  // namespace

// Plain C entry point, bound with ctypes (ops/shuffle_kernel.py).  keys
// (ntemps, n) int64, order (ntemps * n) int64 and sorted (ntemps * n)
// words are device pointers, order or sorted (but not both) null for an
// output not wanted; scratch holds 2 * ntemps * n words (the long route;
// unused, and may be null, on the others).  chunk 0 takes the rank route
// (n <= kRankMax); else chunk is a power of two from 2 to kChunkMax and
// threads the sorting block's (a multiple of 32, at most kSortThreadsMax),
// and chunk >= n takes the short route.  Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue, and no launch, for arguments out of
// range).
extern "C" int emcee_group_order(const long long* keys, long long* order,
                                 unsigned long long* sorted,
                                 unsigned long long* scratch, int ntemps,
                                 int n, int nsplits, int chunk, int threads,
                                 void* stream) {
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
  if (chunk < 2 || chunk > kChunkMax ||
      (chunk & (chunk - 1)) != 0 || threads < 32 ||
      threads > kSortThreadsMax || threads % 32 != 0 ||
      (chunk < n && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(unsigned long long) * chunk;
  if (chunk >= n) {
    group_order_kernel<true><<<dim3(1, ntemps), threads, smem, st>>>(
        keys, order, sorted, nullptr, n, nsplits, ng, chunk);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (n + chunk - 1) / chunk;
  const int merges = merge_passes(chunks);
  unsigned long long* buf[2] = {
      scratch, scratch + static_cast<size_t>(ntemps) * n};
  group_order_kernel<false><<<dim3(chunks, ntemps), threads, smem, st>>>(
      keys, nullptr, nullptr, buf[0], n, nsplits, ng, chunk);
  const dim3 grid((n + kMergeThreads - 1) / kMergeThreads, ntemps);
  int run = chunk;
  for (int m = 0; m < merges; ++m, run *= 2) {
    const unsigned long long* src = buf[m & 1];
    if (m + 1 == merges) {
      group_merge_kernel<true><<<grid, kMergeThreads, 0, st>>>(
          src, nullptr, order, sorted, n, nsplits, ng, run);
    } else {
      group_merge_kernel<false><<<grid, kMergeThreads, 0, st>>>(
          src, buf[(m + 1) & 1], nullptr, nullptr, n, nsplits, ng, run);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K6c and K6d: the rank-normalised split R-hat's keys, normal scores and
// potential scale reduction factor.
//
// Replaces the XLA-fused chain of emcee_tpu/ops/autocorr.py:253-271
// (_rhat_device, with jnp.median :364 and the split's concatenate :354):
//   K6c  rank_keys_kernel: each parameter's pooled draws (or |x - median|
//        for the tail pass, :269) as order-preserving integer keys, which
//        K16 (csrc/shuffle_order.cu) sorts stably in place of
//        jnp.argsort (:237), writing them in sorted order beside each
//        draw's position; rank_scan_kernel and rank_finish_kernel: the
//        tie groups' average ranks of _avg_ranks_1d (:229-250), their
//        normal scores ndtri((r - 3/8) / (S + 1/4)) (rank_norm :262-266)
//        at each draw's own position, and the pooled median (:364).
//   K6d  psrf_kernel: _psrf_device (:219-226) and jnp.maximum(bulk, tail)
//        (:271); with rank_normalized=False the raw draws' PSRF.
// There is no Pallas kernel behind it.  The port's plain versions
// (ops/autocorr_kernel.py *_plain) are the torch operations of the port's
// route before the kernels (torch.sort, cumsum, scatter_add_,
// torch.special.ndtri, torch.var).
//
// The draws are read in place: a split block's two halves are the chain's
// steps [0, h) and [shift, shift + h), chains c < m of the first and c - m
// of the second, as jnp.concatenate([x[:h], x[n - h:]], axis=1) pools
// them (pooled index p = t C + c), through the chain's strides.
//
// Keys.  float32 draws: the bits u, as u | 2^31 for a positive sign and ~u
// for a negative one, so that the keys order as the values do; -0.0 is
// folded onto +0.0 (they tie, as rankdata ties them), and every NaN gets
// the one key above +inf's, 2^32 - 1 (NaNs sort last in index order, as
// torch.sort(stable=True) and jnp.argsort place them).  float64 draws:
// the same on 64 bits, split into a low and a high word that K16 sorts in
// two stable passes (low word, then the high words gathered through the
// first order by K17).  K16's last pass writes the sorted words: sw, each
// (low key word << 32 | the draw's pooled position) (for float64 the
// first pass's words, gathered through the second pass's order by K17),
// and for float64 sh, the high key words the same way.
//
// Ranks.  rank_scan_kernel reads the sorted keys contiguously from sw and
// sh (tiles of 2048 positions, 8 a thread).  A position starts a tie
// group where its key differs from the one before, or is a NaN's (NaN !=
// NaN, as the plain version's and JAX's sv[1:] != sv[:-1] test it).  The
// start of each position's group is a running maximum of start positions:
// a block scan, then a decoupled look-back over the tiles before it
// (Merrill & Garland 2016), each tile's status one 64-bit word (a flag and
// the value; zeroed by the wrapper before the launch), as K9a's lists are
// compacted.  Positions grow with the tile, so the look-back stops at the
// first tile that holds a start: an all-tied column of 1e7 draws costs one
// pass, not S^2 walks.  It writes grp[k] = the group's first position for
// a position that does not start it, and grp[first] = the group's last
// position, by the group's last member.  rank_finish_kernel then reads a position's first and last
// with at most two loads, the average rank (first + last) / 2 + 1 (exact
// in float64), its normal score by the Cephes rational approximations that
// torch.special.ndtri uses (calc_ndtri, float64), and writes it at the
// draw's own position (from sw: the one scattered write); the position S/2
// writes the median 0.5 (v_(S-1)/2 + v_S/2), numpy's and JAX's median.
//
// PSRF.  A thread a (chain, parameter) column, coalesced across chains:
// the chain's mean and variance by Welford in float64.  The block merges
// its chains' (count, mean of means, M2 of means, sum of variances) by
// Chan's combine in a fixed tree and writes a partial; the last block (a
// done-counter, which the wrapper zeroes before the launch) merges every
// block's partial the same way and finishes sqrt(var_hat / within), and
// for the tail pass the maximum with the bulk value in place (NaN if
// either is).  A zero within-chain variance gives NaN (0 / 0), as in JAX.
// It does not sort, so it takes any number of draws.
//
// What bounds them on an H100: bytes.  At the convergence monitor's last
// check (the second half of 1200 x 1e5 x 5 float32, split: S = 6e7 pooled
// draws a parameter, one parameter a group) rank_keys reads 240 MB and
// writes 480 MB of keys (int64 words, K16's interface; 240 MB of 32-bit
// keys is what the function needs); the scan reads the 480 MB of sorted
// words, each a 32-bit key and a 32-bit position, contiguously and writes
// 240 MB of links; the finish reads the links and the words (720 MB) and
// scatters 480 MB of float64 scores, the one random access left; psrf
// reads the scores once.
#include <cuda_runtime.h>

#include <cstdint>

// The arguments of every entry point (RhatArgs in ops/autocorr_kernel.py;
// the same order and types), outside the anonymous namespace so that the
// C entry points that take it keep external linkage.
struct RhatArgs {
  const void* x;        // the draws' base
  long long st;         // element strides of the (step, chain, parameter)
  long long sc;         //   axes
  long long sd;
  long long shift;      // the second half's first step (split), else 0
  const void* center;   // rank_keys: the medians (d,) for |x - median|, or null
  long long* lo;        // rank_keys: keys (d, S), the low words
  long long* hi;        // rank_keys: float64 keys' high words, else null
  const long long* sw;  // rank_scores: (d, S) sorted (low key << 32 | p)
  const long long* sh;  // rank_scores: float64's (d, S) sorted high keys << 32
  int* grp;             // (d * S) the groups' links
  double* z;            // (d, S) the normal scores
  void* med;            // rank_scores: the medians out (d,), or null
  unsigned long long* status;  // (d, tiles) the look-back's words, zeroed
  double denom;         // S + 1/4
  double coef;          // psrf: (h - 1) / h
  double* part;         // psrf: (d, blocks, 4) the blocks' partials
  int* done;            // psrf: the done-counter, zeroed
  double* out;          // psrf: (d,)
  unsigned long long nan_key;  // the NaNs' key
  int h;                // steps
  int m;                // chains of the first half
  int C;                // chains
  int d;                // parameters
  int f64;              // float64 draws, else float32
  int tiles;            // rank_scores: tiles a parameter
  int blocks;           // psrf: blocks a parameter
  int prior;            // psrf: the maximum with out's values
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
// SCAN_TILE in ops/autocorr_kernel.py
constexpr int kScanTile = kThreads * kItems;

constexpr unsigned long long kAgg = 1ull << 30;
constexpr unsigned long long kPrefix = 2ull << 30;
constexpr unsigned long long kValue = (1ull << 30) - 1;

template <typename T>
__device__ __forceinline__ T draw(const RhatArgs& a, long long p, int j) {
  const int t = static_cast<int>(p / a.C);
  const int c = static_cast<int>(p - static_cast<long long>(t) * a.C);
  const long long row = c < a.m ? t : t + a.shift;
  const long long col = c < a.m ? c : c - a.m;
  const long long at = row * a.st + col * a.sc;
  return static_cast<const T*>(a.x)[at + static_cast<long long>(j) * a.sd];
}

__device__ __forceinline__ float absdiff(float v, float m) {
  return fabsf(__fsub_rn(v, m));
}
__device__ __forceinline__ double absdiff(double v, double m) {
  return fabs(__dsub_rn(v, m));
}
__device__ __forceinline__ float mid(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}
__device__ __forceinline__ double mid(double a, double b) {
  return __dmul_rn(0.5, __dadd_rn(a, b));
}

__device__ __forceinline__ unsigned long long order_key(float v) {
  if (v != v) return 0xffffffffull;
  uint32_t u = __float_as_uint(v);
  if (v == 0.0f) u = 0u;
  return (u & 0x80000000u) ? static_cast<uint32_t>(~u) : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long order_key(double v) {
  if (v != v) return ~0ull;
  unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(v));
  if (v == 0.0) u = 0ull;
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

// Pooled draw p of every parameter into the keys.
template <typename T>
__global__ void __launch_bounds__(kThreads) rank_keys_kernel(const RhatArgs a) {
  const long long S = static_cast<long long>(a.h) * a.C;
  const long long p =
      blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (p >= S) return;
  const T* center = static_cast<const T*>(a.center);
  for (int j = 0; j < a.d; ++j) {
    T v = draw<T>(a, p, j);
    if (center != nullptr) v = absdiff(v, center[j]);
    const unsigned long long k = order_key(v);
    a.lo[j * S + p] = static_cast<long long>(k & 0xffffffffull);
    if (a.hi != nullptr) a.hi[j * S + p] = static_cast<long long>(k >> 32);
  }
}

// The key at sorted position k of the parameter whose positions start at
// row, from the sorted words.
__device__ __forceinline__ unsigned long long sorted_key(const RhatArgs& a,
                                                         long long row,
                                                         long long k) {
  const unsigned long long lo =
      static_cast<unsigned long long>(__ldg(a.sw + row + k)) >> 32;
  if (a.sh == nullptr) return lo;
  const unsigned long long hi =
      static_cast<unsigned long long>(__ldg(a.sh + row + k)) >> 32;
  return (hi << 32) | lo;
}

// The pooled position of the draw at sorted position k.
__device__ __forceinline__ long long sorted_pos(const RhatArgs& a,
                                                long long row, long long k) {
  return static_cast<long long>(
      static_cast<uint32_t>(__ldg(a.sw + row + k)));
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long flag,
                                        unsigned long long v) {
  atomicExch(p, flag | v);
}

// The largest value (a start position + 1, or 0) of the tiles before
// `tile`, this tile's aggregate agg published first.  One thread of the
// tile calls it.
__device__ unsigned long long look_back(unsigned long long* st, int tile,
                                        unsigned long long agg) {
  if (tile == 0) {
    publish(st, kPrefix, agg);
    return 0;
  }
  publish(st + tile, kAgg, agg);
  unsigned long long excl = 0;
  for (int t = tile - 1; t >= 0; --t) {
    unsigned long long s;
    do {
      s = *reinterpret_cast<const volatile unsigned long long*>(st + t);
    } while ((s & (3ull << 30)) == 0);
    excl = s & kValue;
    // Positions grow with the tile: the nearest tile holding a start holds
    // the largest.
    if (excl != 0 || (s & (3ull << 30)) == kPrefix) break;
  }
  publish(st + tile, kPrefix, agg > excl ? agg : excl);
  return excl;
}

// Tile blockIdx.x of parameter blockIdx.y: the tie groups' links.
__global__ void __launch_bounds__(kThreads) rank_scan_kernel(const RhatArgs a) {
  __shared__ unsigned long long s_first[kThreads];
  __shared__ unsigned long long s_last[kThreads];
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_prefix;
  const long long S = static_cast<long long>(a.h) * a.C;
  const int j = blockIdx.y;
  const int tile = blockIdx.x;
  const long long row = j * S;
  const int x = threadIdx.x;
  const long long k0 = static_cast<long long>(tile) * kScanTile + x * kItems;
  unsigned long long kv[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    kv[i] = k0 + i < S ? sorted_key(a, row, k0 + i) : 0ull;
  }
  s_first[x] = kv[0];
  s_last[x] = kv[kItems - 1];
  __syncthreads();
  const unsigned long long prev =
      x > 0 ? s_last[x - 1]
            : (k0 > 0 && k0 < S ? sorted_key(a, row, k0 - 1) : 0ull);
  const unsigned long long next =
      x < kThreads - 1 ? s_first[x + 1]
                       : (k0 + kItems < S ? sorted_key(a, row, k0 + kItems)
                                          : 0ull);
  // This thread's last start (position + 1), 0 if none.
  unsigned starts = 0;
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long k = k0 + i;
    const unsigned long long before = i ? kv[i - 1] : prev;
    if (k < S && (k == 0 || kv[i] != before || kv[i] == a.nan_key)) {
      starts |= 1u << i;
      mine = static_cast<int>(k + 1);
    }
  }
  // The block's exclusive running maximum over its threads.
  const int lane = x & 31, warp = x >> 5;
  int v = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, y);
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = max(w, y);
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) excl = 0;
  if (warp > 0) excl = max(excl, s_warp[warp - 1]);
  if (x == 0) {
    s_prefix = look_back(a.status + static_cast<long long>(j) * a.tiles, tile,
                         static_cast<unsigned long long>(s_warp[kWarps - 1]));
  }
  __syncthreads();
  int run = max(excl, static_cast<int>(s_prefix));
  int* grp = a.grp + row;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long k = k0 + i;
    if (k >= S) break;
    if (starts & (1u << i)) run = static_cast<int>(k + 1);
    const int first = run - 1;
    const unsigned long long after = i + 1 < kItems ? kv[i + 1] : next;
    const bool end = k == S - 1 || after != kv[i] || after == a.nan_key;
    if (!(starts & (1u << i))) grp[k] = first;
    if (end) grp[first] = static_cast<int>(k);
  }
}

// Cephes' polevl: the polynomial of degree n with coefficients c (highest
// first) at x.
template <int N>
__device__ __forceinline__ double polevl(double x, const double (&c)[N]) {
  double r = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) r = r * x + c[i];
  return r;
}

// The standard normal quantile: Cephes ndtri, as torch.special.ndtri
// computes it (ATen/native/Math.h calc_ndtri).
__device__ double ndtri(double y0) {
  const double s2pi = 2.50662827463100050242E0;
  const double P0[5] = {-5.99633501014107895267E1, 9.80010754185999661536E1,
                        -5.66762857469070293439E1, 1.39312609387279679503E1,
                        -1.23916583867381258016E0};
  const double Q0[9] = {1.00000000000000000000E0,  1.95448858338141759834E0,
                        4.67627912898881538453E0,  8.63602421390890590575E1,
                        -2.25462687854119370527E2, 2.00260212380060660359E2,
                        -8.20372256168333339912E1, 1.59056225126211695515E1,
                        -1.18331621121330003142E0};
  const double P1[9] = {4.05544892305962419923E0,  3.15251094599893866154E1,
                        5.71628192246421288162E1,  4.40805073893200834700E1,
                        1.46849561928858024014E1,  2.18663306850790267539E0,
                        -1.40256079171354495875E-1, -3.50424626827848203418E-2,
                        -8.57456785154685413611E-4};
  const double Q1[9] = {1.00000000000000000000E0,  1.57799883256466749731E1,
                        4.53907635128879210584E1,  4.13172038254672030440E1,
                        1.50425385692907503408E1,  2.50464946208309415979E0,
                        -1.42182922854787788574E-1, -3.80806407691578277194E-2,
                        -9.33259480895457427372E-4};
  const double P2[9] = {3.23774891776946035970E0, 6.91522889068984211695E0,
                        3.93881025292474443415E0, 1.33303460815807542389E0,
                        2.01485389549179081538E-1, 1.23716634817820021358E-2,
                        3.01581553508235416007E-4, 2.65806974686737550832E-6,
                        6.23974539184983293730E-9};
  const double Q2[9] = {1.00000000000000000000E0, 6.02427039364742014255E0,
                        3.67983563856160859403E0, 1.37702099489081330271E0,
                        2.16236993594496635890E-1, 1.34204006088543189037E-2,
                        3.28014464682127739104E-4, 2.89247864745380683936E-6,
                        6.79019408009981274425E-9};
  const double expm2 = 0.13533528323661269189;  // exp(-2)
  if (y0 == 0.0) return -__longlong_as_double(0x7ff0000000000000ll);
  if (y0 == 1.0) return __longlong_as_double(0x7ff0000000000000ll);
  if (y0 < 0.0 || y0 > 1.0) return __longlong_as_double(0x7ff8000000000000ll);
  bool code = true;
  double y = y0;
  if (y > 1.0 - expm2) {
    y = 1.0 - y;
    code = false;
  }
  if (y > expm2) {
    y = y - 0.5;
    const double y2 = y * y;
    const double x = y + y * (y2 * polevl(y2, P0) / polevl(y2, Q0));
    return x * s2pi;
  }
  double x = sqrt(-2.0 * log(y));
  const double x0 = x - log(x) / x;
  const double z = 1.0 / x;
  const double x1 = x < 8.0 ? z * polevl(z, P1) / polevl(z, Q1)
                            : z * polevl(z, P2) / polevl(z, Q2);
  x = x0 - x1;
  return code ? -x : x;
}

// Position blockIdx.x * 256 + threadIdx.x of parameter blockIdx.y: its
// average rank's normal score at its draw's position; the median.
template <typename T>
__global__ void __launch_bounds__(kThreads) rank_finish_kernel(
    const RhatArgs a) {
  const long long S = static_cast<long long>(a.h) * a.C;
  const long long k =
      blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (k >= S) return;
  const int j = blockIdx.y;
  const long long row = j * S;
  const int g = a.grp[row + k];
  long long first, last;
  if (g >= k) {
    first = k;
    last = g;
  } else {
    first = g;
    last = a.grp[row + g];
  }
  const double rank = static_cast<double>(first + last + 2) * 0.5;
  const double u = __ddiv_rn(__dsub_rn(rank, 0.375), a.denom);
  a.z[row + sorted_pos(a, row, k)] = ndtri(u);
  if (a.med != nullptr && k == S / 2) {
    const T lo = draw<T>(a, sorted_pos(a, row, (S - 1) / 2), j);
    const T hi = draw<T>(a, sorted_pos(a, row, S / 2), j);
    static_cast<T*>(a.med)[j] = mid(lo, hi);
  }
}

// Chan's combine of (count, mean, M2, sum of variances).
struct Moments {
  double n, mean, m2, var;
};

__device__ __forceinline__ Moments combine(const Moments& p, const Moments& q) {
  if (q.n == 0.0) return p;
  if (p.n == 0.0) return q;
  const double n = p.n + q.n;
  const double delta = q.mean - p.mean;
  return {n, p.mean + delta * (q.n / n),
          p.m2 + q.m2 + delta * delta * (p.n * q.n / n), p.var + q.var};
}

__device__ __forceinline__ Moments shfl_down(const Moments& v, int o) {
  return {__shfl_down_sync(0xffffffffu, v.n, o),
          __shfl_down_sync(0xffffffffu, v.mean, o),
          __shfl_down_sync(0xffffffffu, v.m2, o),
          __shfl_down_sync(0xffffffffu, v.var, o)};
}

// The block's moments, in a fixed tree; thread 0 gets them.
__device__ Moments block_combine(Moments v, Moments* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments y = shfl_down(v, o);
    v = combine(v, y);
  }
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : Moments{0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Moments y = shfl_down(v, o);
      v = combine(v, y);
    }
  }
  __syncthreads();
  return v;
}

// Chains blockIdx.x * 256 .. of parameter blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads) psrf_kernel(const RhatArgs a) {
  __shared__ Moments sh[kWarps];
  __shared__ bool s_last;
  const int j = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  Moments v{0.0, 0.0, 0.0, 0.0};
  if (c < a.C) {
    double n = 0.0, mean = 0.0, m2 = 0.0;
    for (int t = 0; t < a.h; ++t) {
      const double x = static_cast<double>(
          draw<T>(a, static_cast<long long>(t) * a.C + c, j));
      n += 1.0;
      const double delta = x - mean;
      mean += delta / n;
      m2 += delta * (x - mean);
    }
    v = {1.0, mean, 0.0, m2 / (n - 1.0)};
  }
  v = block_combine(v, sh);
  double* part =
      a.part + (static_cast<long long>(j) * a.blocks + blockIdx.x) * 4;
  if (threadIdx.x == 0) {
    part[0] = v.n;
    part[1] = v.mean;
    part[2] = v.m2;
    part[3] = v.var;
  }
  // The last block of the grid merges every partial.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int total = a.blocks * a.d;
    s_last = atomicAdd(a.done, 1) == total - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int jj = 0; jj < a.d; ++jj) {
    const volatile double* pj =
        a.part + static_cast<long long>(jj) * a.blocks * 4;
    Moments w{0.0, 0.0, 0.0, 0.0};
    for (int b = threadIdx.x; b < a.blocks; b += kThreads) {
      w = combine(w, Moments{pj[4 * b], pj[4 * b + 1], pj[4 * b + 2],
                             pj[4 * b + 3]});
    }
    w = block_combine(w, sh);
    if (threadIdx.x == 0) {
      const double between = static_cast<double>(a.h) * (w.m2 / (a.C - 1.0));
      const double within = w.var / a.C;
      const double var_hat =
          __dadd_rn(__dmul_rn(a.coef, within),
                    __ddiv_rn(between, static_cast<double>(a.h)));
      double r = sqrt(__ddiv_rn(var_hat, within));
      if (a.prior) {
        const double p = a.out[jj];
        // NaN if either is, that operand's (as torch.maximum returns it)
        r = p != p ? p : (r != r ? r : (p > r ? p : r));
      }
      a.out[jj] = r;
    }
  }
}

bool bad_draws(const RhatArgs& a) {
  return a.x == nullptr || a.h < 1 || a.m < 1 || a.C < a.m || a.d < 1 ||
         a.d > 65535;
}

// The ranks' draws: positions in 32 bits, and K16's segments below 2^29.
bool bad_sort(const RhatArgs& a) {
  return bad_draws(a) || static_cast<long long>(a.h) * a.C >= (1ll << 29) ||
         (a.f64 != 0) != (a.hi != nullptr || a.sh != nullptr);
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/autocorr_kernel.py); the
// arguments are a host RhatArgs whose pointers are device pointers.  Each
// returns cudaGetLastError() after its launches (cudaErrorInvalidValue, and
// no launch, for arguments out of range).

// K6c: every parameter's keys of the pooled draws (of |x - center| where
// center is set).
extern "C" int emcee_rank_keys(const RhatArgs* args, void* stream) {
  const RhatArgs a = *args;
  if (bad_sort(a) || a.lo == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long S = static_cast<long long>(a.h) * a.C;
  const unsigned grid = static_cast<unsigned>((S + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.f64) {
    rank_keys_kernel<double><<<grid, kThreads, 0, s>>>(a);
  } else {
    rank_keys_kernel<float><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6c: the sorted keys' tie groups (rank_scan_kernel), then every draw's
// normal score and the medians (rank_finish_kernel): two launches.
extern "C" int emcee_rank_scores(const RhatArgs* args, void* stream) {
  const RhatArgs a = *args;
  const long long S = static_cast<long long>(a.h) * a.C;
  if (bad_sort(a) || a.sw == nullptr || a.grp == nullptr ||
      a.z == nullptr || a.status == nullptr ||
      a.tiles != (S + kScanTile - 1) / kScanTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rank_scan_kernel<<<dim3(a.tiles, a.d), kThreads, 0, s>>>(a);
  const dim3 grid(static_cast<unsigned>((S + kThreads - 1) / kThreads), a.d);
  if (a.f64) {
    rank_finish_kernel<double><<<grid, kThreads, 0, s>>>(a);
  } else {
    rank_finish_kernel<float><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6d: the PSRF of the draws into out (the maximum with out's values where
// prior is set).
extern "C" int emcee_psrf(const RhatArgs* args, void* stream) {
  const RhatArgs a = *args;
  if (bad_draws(a) || a.part == nullptr || a.done == nullptr ||
      a.out == nullptr || a.blocks != (a.C + kThreads - 1) / kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(a.blocks, a.d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.f64) {
    psrf_kernel<double><<<grid, kThreads, 0, s>>>(a);
  } else {
    psrf_kernel<float><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6a and K6b: the walker-averaged autocorrelation function's passes
// around cuFFT, and the windows that read it.
//
// Replaces the XLA-fused chain of emcee_tpu/ops/autocorr.py:
//   K6a  _acf_batched (:51-55): each series centred on its mean and padded
//        to 2 next_pow_two(n_t) (acf_center_kernel), and the power
//        spectrum f conj(f) between the FFTs (acf_power_kernel).  The FFTs
//        stay torch.fft.rfft / irfft (cuFFT), a library call as XLA's FFT
//        was.
//   K6b  the normalisation acf / acf[0] and the walker sum (:55-56,
//        _mean_acf :67-69, the chunk loop of _walker_mean_acf :103-107;
//        acf_reduce_kernel), then the walker mean and either window
//        (tau_window_kernel): Sokal's (_tau_from_f :75-85) or Geyer's
//        initial monotone sequence (_tau_geyer_device :115-143).
// There is no Pallas kernel behind it.  The port's plain versions
// (ops/autocorr_kernel.py *_plain) are the torch operations of the port's
// route before the kernels.
//
// acf_center: a block takes 32 series (a series is one (walker,
// parameter) column of a walker chunk, walker-major) and reads them
// through the chain's strides, so a thinned view or a walker slice needs
// no copy.  Its threads first sum each series over n_t in float64 (8 rows
// of threads, merged in a fixed order), then copy 32 x 32 tiles of steps
// through shared memory, centred, into the series-major buffer that
// rfft(dim=-1) reads contiguously, and write the padding's zeros.
// acf_power: |F|^2 in place, the imaginary part 0.
// acf_reduce: a block takes 32 lags and one group of walkers; a warp reads
// 32 consecutive lags of one series (128 bytes) and its lag 0, divides in
// the chain's type (as acf / acf[:1] does) and adds in float64.  The
// block's partial for (group, lag, parameter) is written, or added to the
// previous chunk's: each cell has one owner, so the chunks need no
// atomics and no extra launch.
// tau_window: one block a parameter.  Its threads add the groups'
// partials in group order and divide by n_w (the mean ACF, written out
// in float64); then one thread runs the window's loop, which ends where
// the window is known: Sokal's running sum (numpy's cumsum order, so its
// taus and window equal the float64 host windowing bit for bit for a
// given ACF) or Geyer's pair sums, their running minimum and sum.  Only
// tau (and the window index) leave it.
//
// What bounds them on an H100: bytes.  At the convergence monitor's last
// check (200 x 1e5 x 5 float32, walker chunks of 13107) acf_center reads
// 52 MB of chain a chunk and writes 134 MB of padded series, acf_power
// reads and writes 135 MB of spectrum, acf_reduce reads the 52 MB of the
// first n_t lags; tau_window reads a few hundred kB of partials.  The
// design reads the chain in place, writes each buffer once, and keeps the
// walker sum's partials out of any second pass.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;  // series of acf_center's block; lags of acf_reduce's
constexpr int kRows = 8;   // rows of threads: blocks of 256
constexpr int kThreads = kTile * kRows;
constexpr int kWindowThreads = 256;
constexpr int kPowerThreads = 256;

__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

// Series s0 + threadIdx.x .. of walkers lo.. of x (n_t, n_w, n_d), strides
// (st, sw, sd) in elements, into out (nser, m2): the centred series and
// zeros from n_t on.
template <typename T>
__global__ void __launch_bounds__(kThreads) acf_center_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long st, long long sw,
    long long sd, int nt, int lo, int nser, int nd, int m2) {
  __shared__ double s_sum[kRows][kTile];
  __shared__ T s_mean[kTile];
  __shared__ T tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int s0 = blockIdx.x * kTile;
  const int s = s0 + tx;
  const bool live = s < nser;
  long long off = 0;
  if (live) {
    const int w = s / nd;
    off = static_cast<long long>(lo + w) * sw +
          static_cast<long long>(s - w * nd) * sd;
  }
  double acc = 0.0;
  if (live) {
    for (int t = ty; t < nt; t += kRows) {
      acc += static_cast<double>(x[off + static_cast<long long>(t) * st]);
    }
  }
  s_sum[ty][tx] = acc;
  __syncthreads();
  if (ty == 0) {
    double a = 0.0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) a += s_sum[r][tx];
    s_mean[tx] = static_cast<T>(a / nt);
  }
  __syncthreads();
  const T mean = s_mean[tx];
  for (int t0 = 0; t0 < m2; t0 += kTile) {
    const int tw = t0 + tx;  // the step this thread writes
    if (t0 < nt) {
      for (int r = ty; r < kTile; r += kRows) {
        const int t = t0 + r;
        tile[r][tx] = (live && t < nt)
                          ? sub(x[off + static_cast<long long>(t) * st], mean)
                          : T(0);
      }
      __syncthreads();
      for (int r = ty; r < kTile; r += kRows) {
        const int sr = s0 + r;
        if (sr < nser && tw < m2) {
          out[static_cast<long long>(sr) * m2 + tw] = tile[tx][r];
        }
      }
      __syncthreads();
    } else {
      for (int r = ty; r < kTile; r += kRows) {
        const int sr = s0 + r;
        if (sr < nser && tw < m2) {
          out[static_cast<long long>(sr) * m2 + tw] = T(0);
        }
      }
    }
  }
}

// |F|^2 of n complex values (re, im pairs) in place.
template <typename T, typename V>
__global__ void __launch_bounds__(kPowerThreads) acf_power_kernel(
    V* __restrict__ f, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(kPowerThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kPowerThreads) {
    const V v = f[i];
    V p;
    p.x = add(mul(v.x, v.x), mul(v.y, v.y));
    p.y = T(0);
    f[i] = p;
  }
}

// Lags blockIdx.x * 32 .. of walker group blockIdx.y (walkers [g wg,
// min(nw, (g + 1) wg)) of the chunk) into part[g] (groups, nt, nd).
template <typename T>
__global__ void __launch_bounds__(kThreads) acf_reduce_kernel(
    const T* __restrict__ acf, double* __restrict__ part, int nt, int nd,
    int m2, int nw, int wg, int first) {
  __shared__ double s[kRows][kTile];
  const int t = blockIdx.x * kTile + threadIdx.x;
  const int g = blockIdx.y;
  const int w0 = g * wg;
  const int w1 = min(nw, w0 + wg);
  for (int j = 0; j < nd; ++j) {
    double acc = 0.0;
    if (t < nt) {
      for (int w = w0 + threadIdx.y; w < w1; w += kRows) {
        const T* row = acf + (static_cast<long long>(w) * nd + j) * m2;
        acc += static_cast<double>(div(row[t], row[0]));
      }
    }
    s[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && t < nt) {
      double a = 0.0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) a += s[r][threadIdx.x];
      double* p = part + (static_cast<long long>(g) * nt + t) * nd + j;
      *p = first ? a : *p + a;
    }
    __syncthreads();
  }
}

// Parameter blockIdx.x: the mean ACF f (nt, nd) from the partials, then
// the window.  method 0: Sokal (c); 1: Geyer (floor).
__global__ void __launch_bounds__(kWindowThreads) tau_window_kernel(
    const double* __restrict__ part, double* __restrict__ f,
    double* __restrict__ tau, long long* __restrict__ win, int groups, int nt,
    int nd, double nw, int method, double c, double floor_) {
  const int j = blockIdx.x;
  for (int t = threadIdx.x; t < nt; t += kWindowThreads) {
    double a = 0.0;
    for (int g = 0; g < groups; ++g) {
      a = __dadd_rn(a, part[(static_cast<long long>(g) * nt + t) * nd + j]);
    }
    f[static_cast<long long>(t) * nd + j] = __ddiv_rn(a, nw);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double* fj = f + j;
  if (method == 0) {
    // taus = 2 cumsum(f) - 1 and mask = t < c taus: the window is
    // argmin(mask) (the first lag where it fails, 0 if it never does)
    // where the mask holds anywhere, else the last lag (numpy's and the
    // reference's auto_window).  The loop ends once both are known.
    double s = 0.0, tj = 0.0, tau0 = 0.0, tau_fail = 0.0;
    int fail = -1;
    bool held = false;
    for (int t = 0; t < nt; ++t) {
      s = __dadd_rn(s, fj[static_cast<long long>(t) * nd]);
      tj = __dsub_rn(__dmul_rn(2.0, s), 1.0);
      if (t == 0) tau0 = tj;
      if (static_cast<double>(t) < __dmul_rn(c, tj)) {
        held = true;
      } else if (fail < 0) {
        fail = t;
        tau_fail = tj;
      }
      if (held && fail >= 0) break;
    }
    if (!held) {
      tau[j] = tj;
      win[j] = nt - 1;
    } else if (fail < 0) {
      tau[j] = tau0;
      win[j] = 0;
    } else {
      tau[j] = tau_fail;
      win[j] = fail;
    }
    return;
  }
  const int npairs = nt / 2;
  if (npairs < 1) {
    tau[j] = __longlong_as_double(0x7ff8000000000000ll);
    win[j] = 0;
    return;
  }
  // G_k = f_2k + f_2k+1 up to the first that is not positive, their
  // running minimum summed; tau = -1 + 2 sum, floored.
  double gmin = __longlong_as_double(0x7ff0000000000000ll), sum = 0.0;
  int k = 0;
  for (; k < npairs; ++k) {
    const double g = __dadd_rn(fj[static_cast<long long>(2 * k) * nd],
                               fj[static_cast<long long>(2 * k + 1) * nd]);
    if (!(g > 0.0)) break;
    gmin = g < gmin ? g : gmin;
    sum = __dadd_rn(sum, gmin);
  }
  const double t = __dadd_rn(-1.0, __dmul_rn(2.0, sum));
  tau[j] = t < floor_ ? floor_ : t;
  win[j] = k;
}

int power_blocks(long long n, int blocks) {
  const long long need = (n + kPowerThreads - 1) / kPowerThreads;
  return static_cast<int>(need < blocks ? (need < 1 ? 1 : need) : blocks);
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/autocorr_kernel.py).  Every
// pointer is a device pointer; f64 selects float64 (else float32) data.
// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue,
// and no launch, for arguments out of range).

// K6a: walkers [lo, lo + nser / nd) of x (n_t, n_w, n_d; element strides
// st, sw, sd) into out (nser, m2), centred and zero-padded.
extern "C" int emcee_acf_center(const void* x, void* out, long long st,
                                long long sw, long long sd, int nt, int lo,
                                int nser, int nd, int m2, int f64,
                                void* stream) {
  if (nt < 1 || nser < 1 || nd < 1 || nser % nd != 0 || m2 < nt || lo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nser + kTile - 1) / kTile), block(kTile, kRows);
  if (f64) {
    acf_center_kernel<double><<<grid, block, 0, s>>>(
        static_cast<const double*>(x), static_cast<double*>(out), st, sw, sd,
        nt, lo, nser, nd, m2);
  } else {
    acf_center_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), st, sw, sd,
        nt, lo, nser, nd, m2);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6a: |F|^2 of n complex values in place, on at most `blocks` blocks.
extern "C" int emcee_acf_power(void* f, long long n, int f64, int blocks,
                               void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = power_blocks(n, blocks);
  if (f64) {
    acf_power_kernel<double, double2><<<grid, kPowerThreads, 0, s>>>(
        static_cast<double2*>(f), n);
  } else {
    acf_power_kernel<float, float2><<<grid, kPowerThreads, 0, s>>>(
        static_cast<float2*>(f), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6b: the ACFs acf (nw * nd, m2) of a chunk's nw walkers, each divided by
// its lag 0 and summed over the walkers of each of `groups` groups of wg
// into part (groups, nt, nd), written (first) or added.
extern "C" int emcee_acf_reduce(const void* acf, double* part, int nt, int nd,
                                int m2, int nw, int wg, int groups, int first,
                                int f64, void* stream) {
  if (nt < 1 || nd < 1 || m2 < nt || nw < 1 || wg < 1 || groups < 1 ||
      groups > 65535 || static_cast<long long>(wg) * groups < nw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nt + kTile - 1) / kTile, groups), block(kTile, kRows);
  if (f64) {
    acf_reduce_kernel<double><<<grid, block, 0, s>>>(
        static_cast<const double*>(acf), part, nt, nd, m2, nw, wg, first);
  } else {
    acf_reduce_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(acf), part, nt, nd, m2, nw, wg, first);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6b: the mean ACF f (nt, nd) of the partials part (groups, nt, nd) over
// nw walkers, and each parameter's tau and window (method 0: Sokal with
// c; 1: Geyer floored at floor_).
extern "C" int emcee_tau_window(const double* part, double* f, double* tau,
                                long long* win, int groups, int nt, int nd,
                                double nw, int method, double c,
                                double floor_, void* stream) {
  if (groups < 1 || nt < 1 || nd < 1 || nd > 65535 || !(nw >= 1.0) ||
      (method != 0 && method != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tau_window_kernel<<<nd, kWindowThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      part, f, tau, win, groups, nt, nd, nw, method, c, floor_);
  return static_cast<int>(cudaGetLastError());
}

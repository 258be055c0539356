// The NaN-aware tile combine for Hopper (sm_90a): a per-pixel reduction
// over a [T, B, H, W] f64 stack of aligned tiles, NaN marking no data,
// into [B, H, W] f64.
//
// Replaces the XLA body of the JAX package's combine,
// mosaic_tpu/core/raster/rops.py:188 combine (jnp.nanmean, nanmin,
// nanmax, nanmedian, nansum and the count of non-NaN values over axis 0),
// which raster_to_grid reaches through combine_avg where tiles overlap.
// It has no Pallas form.  The plain PyTorch version is
// ops/raster_combine.py combine_ref.
//
// Per pixel, over the T values v_t that are not NaN (n of them):
//   sum    = ((0 + v_0) + v_1) + ...   in t order; 0 when n = 0;
//   count  = n;
//   avg    = sum / n                   NaN when n = 0 (0 / 0);
//   min    = the least v_t, max the largest; NaN when n = 0;
//   median = jnp.nanmedian's formula (nanquantile at 0.5, "linear"):
//            q = 0.5 * (n - 1), lo = floor(q), hi = ceil(q),
//            hw = q - lo, lw = 1 - hw,
//            median = s_lo * lw + s_hi * hw
//            with s_k the k-th smallest value; NaN when n = 0.
// Every sum, product and quotient is rounded once (__dadd_rn, __dmul_rn,
// __ddiv_rn; the build also has -fmad=false), in the order above, which
// combine_ref keeps, so the two are bit-equal.
//
// The median takes its order statistics by counting, with no cap on T
// and no local array: value v_i holds the sorted ranks [lt_i, lt_i +
// eq_i), lt_i the number of values below it and eq_i the number equal to
// it, so s_k is the first v_i (in t order) with lt_i <= k < lt_i + eq_i.
// That reads the pixel's column T + T^2 times, which at the T of
// overlapping tiles (2 to 4) is a few reads more than the other reducers.
//
// What bounds it on an H100: its bytes, the stack read once and the
// output written once.  At four quarter tiles of an SRTM 1-arc-second
// tile pasted on their common grid (4 x 3601 x 3601 f64) that is 519 MB,
// 155 us at HBM3's 3.35 TB/s.  A thread per output pixel reads the T
// values of its column, T planes apart; neighbouring threads read
// neighbouring pixels, so every load of a warp is one contiguous 256-byte
// run.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

enum Reducer { kAvg = 0, kMin = 1, kMax = 2, kMedian = 3, kSum = 4,
               kCount = 5 };

template <int R>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const double* __restrict__ s, int T, long long P,
                   double* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const double* col = s + p;
  const double nan = __longlong_as_double(0x7ff8000000000000ll);
  if (R == kAvg || R == kSum || R == kCount) {
    double sum = 0.0;
    int n = 0;
    for (int t = 0; t < T; ++t) {
      const double v = __ldg(col + (long long)t * P);
      if (!isnan(v)) {
        sum = __dadd_rn(sum, v);
        ++n;
      }
    }
    out[p] = R == kSum ? sum
           : R == kCount ? (double)n
                         : __ddiv_rn(sum, (double)n);
  } else if (R == kMin || R == kMax) {
    double m = R == kMin ? INFINITY : -INFINITY;
    int n = 0;
    for (int t = 0; t < T; ++t) {
      const double v = __ldg(col + (long long)t * P);
      n += !isnan(v);
      // a NaN compares false and leaves m; the first of equal values stays
      if (R == kMin ? v < m : v > m) m = v;
    }
    out[p] = n ? m : nan;
  } else {
    int n = 0;
    for (int t = 0; t < T; ++t) n += !isnan(__ldg(col + (long long)t * P));
    if (n == 0) {
      out[p] = nan;
      return;
    }
    const double q = __dmul_rn(0.5, (double)(n - 1));
    const double lo = floor(q);
    const double hi = ceil(q);
    const double hw = __dsub_rn(q, lo);
    const double lw = __dsub_rn(1.0, hw);
    const int klo = (int)lo;
    const int khi = (int)hi;
    double s_lo = nan, s_hi = nan;
    bool have_lo = false, have_hi = false;
    for (int i = 0; i < T && !(have_lo && have_hi); ++i) {
      const double vi = __ldg(col + (long long)i * P);
      if (isnan(vi)) continue;
      int lt = 0, eq = 0;
      for (int j = 0; j < T; ++j) {
        const double vj = __ldg(col + (long long)j * P);
        lt += vj < vi;
        eq += vj == vi;
      }
      if (!have_lo && lt <= klo && klo < lt + eq) {
        s_lo = vi;
        have_lo = true;
      }
      if (!have_hi && lt <= khi && khi < lt + eq) {
        s_hi = vi;
        have_hi = true;
      }
    }
    out[p] = __dadd_rn(__dmul_rn(s_lo, lw), __dmul_rn(s_hi, hw));
  }
}

template <int R>
int launch(const double* s, int T, long long P, double* out,
           cudaStream_t stream) {
  const long long blocks = (P + kThreads - 1) / kThreads;
  combine_kernel<R><<<(unsigned)blocks, kThreads, 0, stream>>>(s, T, P, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// stack [T, P] f64 (T tiles of P = B * H * W pixels each) and out [P]
// f64, contiguous on the device; T >= 1; reducer 0 avg, 1 min, 2 max,
// 3 median, 4 sum, 5 count (the wrapper checks).  Launches on `stream`
// and returns the launch's CUDA error (cudaErrorInvalidValue for an
// unknown reducer).
int raster_combine_launch(const double* stack, int T, long long P,
                          int reducer, double* out, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (reducer) {
    case kAvg: return launch<kAvg>(stack, T, P, out, st);
    case kMin: return launch<kMin>(stack, T, P, out, st);
    case kMax: return launch<kMax>(stack, T, P, out, st);
    case kMedian: return launch<kMedian>(stack, T, P, out, st);
    case kSum: return launch<kSum>(stack, T, P, out, st);
    case kCount: return launch<kCount>(stack, T, P, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* raster_combine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

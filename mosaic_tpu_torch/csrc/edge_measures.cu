// Per-geometry measures of padded edge blocks for Hopper (sm_90a): area,
// length, centroid or bounds of each geometry of an EdgeBlocks batch,
// a [G, E, 2] (a, b) pair of edge endpoints with a [G, E] validity mask,
// in float32 or float64.
//
// Replaces the XLA bodies of the JAX package's
// mosaic_tpu/core/geometry/measures.py :27 area, :37 length, :43
// centroid and :64 bounds, each a masked reduction over a geometry's
// padded edges.  None has a Pallas form.  The plain PyTorch version is
// ops/edge_measures.py edge_measures_ref.
//
// Per geometry, over its E edge slots in order ([x]_e is x where slot e
// is valid and +0 where it is not, the select XLA makes of the JAX
// body's multiply by the bool mask; cross_e = ax*by - ay*bx; len_e =
// sqrt(dx*dx + dy*dy) with d = b - a; every sum starts at 0 and adds
// e = 0, 1, ... in turn):
//   area     = max(0.5 * sum([cross]_e), 0), NaN kept;
//   length   = sum([len]_e);
//   centroid = with w_e = [cross]_e, l_e = [len]_e, A = sum(w_e):
//              sum((a + b) * w_e) / (3 A + eps)      where |A| > 1e-30,
//              else sum(0.5 (a + b) * l_e) / (L + eps), L the length,
//              where L > 1e-30,
//              else sum([a]_e) / (n + eps), n the valid slots;
//   bounds   = (xmin, ymin, xmax, ymax) over both endpoints of the valid
//              slots, +-inf where none is valid, NaN where one is NaN.
// eps is the JAX body's 1e-300 guard: 0 in float32, where 1e-300 rounds
// to 0 (so a row with no valid slot has a NaN centroid there, as XLA
// gives), 1e-300 in float64.  The thresholds 1e-30 are rounded to the
// block's type.  A masked slot's endpoints still enter the centroid's
// products (a + b) * w_e and 0.5 (a + b) * l_e, so a NaN there gives a
// NaN centroid, as in the JAX body.  Each multiply, add
// and subtract is rounded on its own (-fmad=false), the divide and sqrt
// are IEEE, the sums run left to right, and the min and max take a NaN
// and then keep it (v < m or v is NaN), so the kernel is bit-equal to the
// plain version, which follows the same steps.
//
// What bounds it on an H100: its bytes, the endpoints and the mask read
// once and the output written once (at 2^20 footprints of 8 edge slots in
// float64, 277 MB, 83 us at 3.35 TB/s); the arithmetic is some 30
// operations an edge.  Design: one thread a geometry, 128 a block, each
// reading its own slots in order (a geometry's slots are contiguous, so
// the lines a warp touches are reused from L1 over the loop).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;

enum Measure { kArea = 0, kLength = 1, kCentroid = 2, kBounds = 3 };

template <typename T>
struct Guard;
template <>
struct Guard<float> {
  static __device__ float eps() { return 0.0f; }
  static __device__ float tiny() { return 1e-30f; }
};
template <>
struct Guard<double> {
  static __device__ double eps() { return 1e-300; }
  static __device__ double tiny() { return 1e-30; }
};

// IEEE square root and absolute value by type (sqrtf is correctly
// rounded without --use_fast_math)
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T keep_min(T m, T v) {
  return (v < m || v != v) ? v : m;
}

template <typename T>
__device__ __forceinline__ T keep_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    measures_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const bool* __restrict__ mask, long long G, int E,
                    T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const T* ag = a + g * E * 2;
  const T* bg = b + g * E * 2;
  const bool* mg = mask + g * E;
  const T zero = T(0), half = T(0.5);
  if (M == kBounds) {
    const T inf = T(INFINITY);
    T xmin = inf, ymin = inf, xmax = -inf, ymax = -inf;
    for (int e = 0; e < E; ++e) {
      if (!mg[e]) continue;
      const T ax = __ldg(ag + 2 * e), ay = __ldg(ag + 2 * e + 1);
      const T bx = __ldg(bg + 2 * e), by = __ldg(bg + 2 * e + 1);
      xmin = keep_min(keep_min(xmin, ax), bx);
      ymin = keep_min(keep_min(ymin, ay), by);
      xmax = keep_max(keep_max(xmax, ax), bx);
      ymax = keep_max(keep_max(ymax, ay), by);
    }
    out[4 * g] = xmin;
    out[4 * g + 1] = ymin;
    out[4 * g + 2] = xmax;
    out[4 * g + 3] = ymax;
    return;
  }
  T A = zero, L = zero, sx = zero, sy = zero, lx = zero, ly = zero,
    vx = zero, vy = zero;
  int n = 0;
  for (int e = 0; e < E; ++e) {
    const bool m = mg[e];
    n += m;
    const T ax = __ldg(ag + 2 * e), ay = __ldg(ag + 2 * e + 1);
    const T bx = __ldg(bg + 2 * e), by = __ldg(bg + 2 * e + 1);
    if (M == kArea || M == kCentroid) {
      const T w = m ? ax * by - ay * bx : zero;
      A = A + w;
      if (M == kCentroid) {
        sx = sx + (ax + bx) * w;
        sy = sy + (ay + by) * w;
      }
    }
    if (M == kLength || M == kCentroid) {
      const T dx = bx - ax, dy = by - ay;
      const T len = m ? root(dx * dx + dy * dy) : zero;
      L = L + len;
      if (M == kCentroid) {
        lx = lx + half * (ax + bx) * len;
        ly = ly + half * (ay + by) * len;
        vx = vx + (m ? ax : zero);
        vy = vy + (m ? ay : zero);
      }
    }
  }
  if (M == kArea) {
    const T v = half * A;
    out[g] = (v > zero || v != v) ? v : zero;
  } else if (M == kLength) {
    out[g] = L;
  } else {
    const T eps = Guard<T>::eps(), tiny = Guard<T>::tiny();
    T cx, cy;
    if (mag(A) > tiny) {
      const T d = T(3) * A + eps;
      cx = sx / d;
      cy = sy / d;
    } else if (L > tiny) {
      const T d = L + eps;
      cx = lx / d;
      cy = ly / d;
    } else {
      const T d = T(n) + eps;
      cx = vx / d;
      cy = vy / d;
    }
    out[2 * g] = cx;
    out[2 * g + 1] = cy;
  }
}

template <typename T>
int launch(const T* a, const T* b, const bool* mask, long long G, int E,
           int what, T* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((G + kThreads - 1) / kThreads);
  switch (what) {
    case kArea:
      measures_kernel<T, kArea><<<blocks, kThreads, 0, stream>>>(
          a, b, mask, G, E, out);
      break;
    case kLength:
      measures_kernel<T, kLength><<<blocks, kThreads, 0, stream>>>(
          a, b, mask, G, E, out);
      break;
    case kCentroid:
      measures_kernel<T, kCentroid><<<blocks, kThreads, 0, stream>>>(
          a, b, mask, G, E, out);
      break;
    case kBounds:
      measures_kernel<T, kBounds><<<blocks, kThreads, 0, stream>>>(
          a, b, mask, G, E, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b [G, E, 2] and out ([G], [G, 2] or [G, 4] as `what` is 0 area,
// 1 length, 2 centroid or 3 bounds) of one type, mask [G, E] bool, all
// contiguous on the device; the wrapper checks them.  Launches on
// `stream` and returns the launch's CUDA error.
int edge_measures_f32_launch(const float* a, const float* b,
                             const bool* mask, long long G, int E, int what,
                             float* out, void* stream) {
  if (G <= 0) return 0;
  return launch<float>(a, b, mask, G, E, what, out, (cudaStream_t)stream);
}

int edge_measures_f64_launch(const double* a, const double* b,
                             const bool* mask, long long G, int E, int what,
                             double* out, void* stream) {
  if (G <= 0) return 0;
  return launch<double>(a, b, mask, G, E, what, out, (cudaStream_t)stream);
}

const char* edge_measures_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

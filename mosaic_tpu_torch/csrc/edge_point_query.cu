// Point queries against padded edge blocks for Hopper (sm_90a): for every
// (point, geometry) pair, the crossing count of a +x ray from the point
// over the geometry's edges, and/or the point's distance to the nearest
// of those edges, in float32 or float64.
//
// Replaces the XLA bodies of the JAX package's
// mosaic_tpu/core/geometry/predicates.py :26 crossing_number and :42
// points_in_polygons (with_boundary_dist), and measures.py :94
// distance_points_to_geoms over :82 point_segment_dist2.  None has a
// Pallas form.  One launch gives both outputs where points_in_polygons
// asks for the boundary distance.  The plain PyTorch version is
// ops/edge_point.py edge_point_query_ref.
//
// Per (point p, geometry g), over g's valid edges (a, b) in slot order:
//   count: straddle = (ay <= py) != (by <= py), the half-open rule;
//          t = (py - ay) / (by == ay ? 1 : by - ay); xi = ax + t (bx - ax);
//          count += straddle && px < xi;
//   dist:  ab = b - a, ap = p - a, denom = abx*abx + aby*aby,
//          t = clip((apx*abx + apy*aby) / (denom + eps), 0, 1) (NaN kept),
//          d = p - (a + t ab), d2 = dx*dx + dy*dy; the least d2 in slot
//          order, a NaN taken and then kept (v < m or v is NaN), +inf
//          where no edge is valid; dist = sqrt(that).
// eps is the JAX body's 1e-300 guard, which rounds to 0 in float32: there
// a zero-length valid edge gives 0/0 and a NaN distance, as XLA gives;
// in float64 it gives the distance to the point a.  Each multiply, add
// and subtract is rounded on its own (-fmad=false), divides and the sqrt
// are IEEE, so the outputs are bit-equal to the plain version's.
//
// What bounds it on an H100: operations.  Per (point, geometry, valid
// edge) two compares; per straddling one py - ay, by - ay, the divide,
// bx - ax, a multiply, an add and the compare; per (point, geometry,
// valid edge) of the distance 18 operations and the divide (ap, the dot
// product, the guard, the clip, the projection, d and d2, the min), and
// a sqrt per pair.  chip_smoke.py counts the straddling edges from the
// run's own points and edges.  At 2^20 points x the 281 taxi zones of 64
// slots that is some 4e11 float64 operations, 24 ms at 17e12 a second.
//
// Design: a block per (tile of 256 points, geometry), one thread a
// point; the block stages the geometry's edges in shared memory, 256 at
// a time, and every thread walks them in slot order from there (one
// broadcast read per edge).  Neighbouring threads write neighbouring
// points' outputs, G apart: a write is one sector, and the writes are a
// few percent of the time at these widths.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static __device__ float value() { return 0.0f; }
};
template <>
struct Eps<double> {
  static __device__ double value() { return 1e-300; }
};

// IEEE square root by type (sqrtf is correctly rounded without
// --use_fast_math)
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

template <typename T, bool COUNT, bool DIST>
__global__ void __launch_bounds__(kThreads)
    query_kernel(const T* __restrict__ pts, const T* __restrict__ a,
                 const T* __restrict__ b, const bool* __restrict__ mask,
                 long long N, long long G, int E, long long tiles,
                 int* __restrict__ count, T* __restrict__ dist) {
  __shared__ T sax[kChunk], say[kChunk], sbx[kChunk], sby[kChunk];
  __shared__ bool sm[kChunk];
  const long long tile = blockIdx.x % tiles;
  const long long g = blockIdx.x / tiles;
  const long long n = tile * kThreads + threadIdx.x;
  const bool active = n < N;
  const T px = active ? __ldg(pts + 2 * n) : T(0);
  const T py = active ? __ldg(pts + 2 * n + 1) : T(0);
  const T* ag = a + g * E * 2;
  const T* bg = b + g * E * 2;
  const bool* mg = mask + g * E;
  const T zero = T(0), one = T(1), eps = Eps<T>::value();
  int cnt = 0;
  T dmin = T(INFINITY);
  for (int c0 = 0; c0 < E; c0 += kChunk) {
    const int len = min(kChunk, E - c0);
    __syncthreads();
    if (threadIdx.x < len) {
      const int e = c0 + threadIdx.x;
      sax[threadIdx.x] = __ldg(ag + 2 * e);
      say[threadIdx.x] = __ldg(ag + 2 * e + 1);
      sbx[threadIdx.x] = __ldg(bg + 2 * e);
      sby[threadIdx.x] = __ldg(bg + 2 * e + 1);
      sm[threadIdx.x] = mg[e];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < len; ++k) {
      if (!sm[k]) continue;
      const T ax = sax[k], ay = say[k], bx = sbx[k], by = sby[k];
      if (COUNT && ((ay <= py) != (by <= py))) {
        const T t = (py - ay) / (by == ay ? one : by - ay);
        const T xi = ax + t * (bx - ax);
        cnt += px < xi;
      }
      if (DIST) {
        const T abx = bx - ax, aby = by - ay;
        const T apx = px - ax, apy = py - ay;
        const T denom = abx * abx + aby * aby;
        T t = (apx * abx + apy * aby) / (denom + eps);
        if (t == t) t = t < zero ? zero : (t > one ? one : t);
        const T dx = px - (ax + t * abx);
        const T dy = py - (ay + t * aby);
        const T d2 = dx * dx + dy * dy;
        if (d2 < dmin || d2 != d2) dmin = d2;
      }
    }
  }
  if (!active) return;
  if (COUNT) count[n * G + g] = cnt;
  if (DIST) dist[n * G + g] = root(dmin);
}

template <typename T>
int launch(const T* pts, const T* a, const T* b, const bool* mask,
           long long N, long long G, int E, int* count, T* dist,
           cudaStream_t stream) {
  const long long tiles = (N + kThreads - 1) / kThreads;
  const long long blocks = tiles * G;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  if (count && dist)
    query_kernel<T, true, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        pts, a, b, mask, N, G, E, tiles, count, dist);
  else if (count)
    query_kernel<T, true, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        pts, a, b, mask, N, G, E, tiles, count, dist);
  else if (dist)
    query_kernel<T, false, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        pts, a, b, mask, N, G, E, tiles, count, dist);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// points [N, 2], a and b [G, E, 2] and dist [N, G] of one type, mask
// [G, E] bool, count [N, G] int32, all contiguous on the device; count or
// dist may be null (not both); ceil(N / 256) * G below 2^31 (the wrapper
// checks them).  Launches on `stream` and returns the launch's CUDA
// error.
int edge_point_query_f32_launch(const float* pts, const float* a,
                                const float* b, const bool* mask,
                                long long N, long long G, int E, int* count,
                                float* dist, void* stream) {
  if (N <= 0 || G <= 0) return 0;
  return launch<float>(pts, a, b, mask, N, G, E, count, dist,
                       (cudaStream_t)stream);
}

int edge_point_query_f64_launch(const double* pts, const double* a,
                                const double* b, const bool* mask,
                                long long N, long long G, int E, int* count,
                                double* dist, void* stream) {
  if (N <= 0 || G <= 0) return 0;
  return launch<double>(pts, a, b, mask, N, G, E, count, dist,
                        (cudaStream_t)stream);
}

const char* edge_point_query_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Edge-crossing matrix of two padded edge blocks for Hopper (sm_90a): for
// every (g1, g2) geometry pair, whether any valid edge of g1 crosses or
// touches any valid edge of g2, in float32 or float64.
//
// Replaces the XLA body of the JAX package's
// mosaic_tpu/core/geometry/predicates.py :84 edges_cross_matrix over :63
// segments_intersect, which polygons_intersect (:105) and
// polygon_contains_polygon (:116) call.  It has no Pallas form.  The
// plain PyTorch version is ops/edges_cross.py edges_cross_ref.
//
// Per edge pair (a1 b1 of g1, a2 b2 of g2), with orient(p, q, r) =
// (q.x-p.x)*(r.y-p.y) - (q.y-p.y)*(r.x-p.x):
//   d1 = orient(a2, b2, a1), d2 = orient(a2, b2, b1),
//   d3 = orient(a1, b1, a2), d4 = orient(a1, b1, b2);
//   proper = (d1 > 0) != (d2 > 0) && (d3 > 0) != (d4 > 0) and no d is 0;
//   touch  = an endpoint r of one segment with its d == 0 inside the
//            other segment's bbox (min <= r <= max on both axes, the min
//            and max NaN-propagating);
//   hit    = proper || touch.
// The orientations round each subtract and multiply on their own
// (-fmad=false), so a shared edge, or a vertex on the other's edge,
// gives the exact zero the touch test needs wherever the plain version
// gets it, and the booleans are bit-equal to the plain version's.
//
// What bounds it on an H100: operations.  A pair whose answer is false
// needs every valid edge pair of it tested; one whose answer is true
// needs at least one.  A test needs 26: the three coordinate differences
// a1 - a2, b1 - a2, b2 - a1 (6; the edges' own vectors once an edge),
// four orientations of two multiplies and a subtract (12) and their
// eight sign and zero tests.  chip_smoke.py counts both kinds of pairs
// and their valid edges from the run's own data.
//
// Design: a warp per (g1, g2) pair, 8 pairs (consecutive g2, one g1) a
// block; the lanes take the pair's E1 x E2 slot pairs 32 at a time and
// the warp stops at the first round in which a lane hits (__any_sync), as
// the JAX body's any() allows.  The edges come through the read-only
// cache: g1's are shared by the block's 8 warps, and g2's by the warps
// of every block of the same g2 tile.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T nmin(T x, T y) {
  return (x < y || x != x) ? x : y;
}

template <typename T>
__device__ __forceinline__ T nmax(T x, T y) {
  return (x > y || x != x) ? x : y;
}

template <typename T>
__device__ __forceinline__ T orient(T px, T py, T qx, T qy, T rx, T ry) {
  return (qx - px) * (ry - py) - (qy - py) * (rx - px);
}

template <typename T>
__device__ __forceinline__ bool on_seg(T px, T py, T qx, T qy, T rx, T ry,
                                       T d) {
  return d == T(0) && nmin(px, qx) <= rx && rx <= nmax(px, qx) &&
         nmin(py, qy) <= ry && ry <= nmax(py, qy);
}

template <typename T>
__device__ bool segments_intersect(T a1x, T a1y, T b1x, T b1y, T a2x, T a2y,
                                   T b2x, T b2y) {
  const T d1 = orient(a2x, a2y, b2x, b2y, a1x, a1y);
  const T d2 = orient(a2x, a2y, b2x, b2y, b1x, b1y);
  const T d3 = orient(a1x, a1y, b1x, b1y, a2x, a2y);
  const T d4 = orient(a1x, a1y, b1x, b1y, b2x, b2y);
  const T z = T(0);
  const bool proper = ((d1 > z) != (d2 > z)) && ((d3 > z) != (d4 > z)) &&
                      d1 != z && d2 != z && d3 != z && d4 != z;
  return proper || on_seg(a2x, a2y, b2x, b2y, a1x, a1y, d1) ||
         on_seg(a2x, a2y, b2x, b2y, b1x, b1y, d2) ||
         on_seg(a1x, a1y, b1x, b1y, a2x, a2y, d3) ||
         on_seg(a1x, a1y, b1x, b1y, b2x, b2y, d4);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    cross_kernel(const T* __restrict__ a1, const T* __restrict__ b1,
                 const bool* __restrict__ m1, const T* __restrict__ a2,
                 const T* __restrict__ b2, const bool* __restrict__ m2,
                 long long G1, long long G2, int E1, int E2, long long tiles,
                 bool* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long g1 = blockIdx.x / tiles;
  const long long g2 = (blockIdx.x % tiles) * kWarps + (threadIdx.x >> 5);
  if (g2 >= G2) return;                    // the whole warp leaves
  const T* p1 = a1 + g1 * E1 * 2;
  const T* q1 = b1 + g1 * E1 * 2;
  const bool* v1 = m1 + g1 * E1;
  const T* p2 = a2 + g2 * E2 * 2;
  const T* q2 = b2 + g2 * E2 * 2;
  const bool* v2 = m2 + g2 * E2;
  const long long total = (long long)E1 * E2;
  bool found = false;
  for (long long base = 0; base < total; base += 32) {
    const long long k = base + lane;
    bool hit = false;
    if (k < total) {
      const int i = (int)(k / E2), j = (int)(k % E2);
      if (v1[i] && v2[j])
        hit = segments_intersect(
            __ldg(p1 + 2 * i), __ldg(p1 + 2 * i + 1), __ldg(q1 + 2 * i),
            __ldg(q1 + 2 * i + 1), __ldg(p2 + 2 * j), __ldg(p2 + 2 * j + 1),
            __ldg(q2 + 2 * j), __ldg(q2 + 2 * j + 1));
    }
    if (__any_sync(kFull, hit)) {
      found = true;
      break;
    }
  }
  if (lane == 0) out[g1 * G2 + g2] = found;
}

template <typename T>
int launch(const T* a1, const T* b1, const bool* m1, const T* a2,
           const T* b2, const bool* m2, long long G1, long long G2, int E1,
           int E2, bool* out, cudaStream_t stream) {
  const long long tiles = (G2 + kWarps - 1) / kWarps;
  const long long blocks = tiles * G1;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  cross_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      a1, b1, m1, a2, b2, m2, G1, G2, E1, E2, tiles, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a1, b1 [G1, E1, 2] and a2, b2 [G2, E2, 2] of one type, m1 [G1, E1] and
// m2 [G2, E2] bool, out [G1, G2] bool, all contiguous on the device;
// ceil(G2 / 8) * G1 below 2^31 (the wrapper checks them).  Launches on
// `stream` and returns the launch's CUDA error.
int edges_cross_f32_launch(const float* a1, const float* b1, const bool* m1,
                           const float* a2, const float* b2, const bool* m2,
                           long long G1, long long G2, int E1, int E2,
                           bool* out, void* stream) {
  if (G1 <= 0 || G2 <= 0) return 0;
  return launch<float>(a1, b1, m1, a2, b2, m2, G1, G2, E1, E2, out,
                       (cudaStream_t)stream);
}

int edges_cross_f64_launch(const double* a1, const double* b1,
                           const bool* m1, const double* a2,
                           const double* b2, const bool* m2, long long G1,
                           long long G2, int E1, int E2, bool* out,
                           void* stream) {
  if (G1 <= 0 || G2 <= 0) return 0;
  return launch<double>(a1, b1, m1, a2, b2, m2, G1, G2, E1, E2, out,
                        (cudaStream_t)stream);
}

const char* edges_cross_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

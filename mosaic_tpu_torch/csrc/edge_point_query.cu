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
// Why the design below keeps that: a masked slot adds 0 to the count and
// +inf to the minimum, which changes neither (inf < m is false, and inf
// is no NaN), so walking only the valid slots, in slot order, gives the
// same values.  The count is an integer sum and the NaN-sticky minimum
// does not depend on the order either.  The terms that depend on the
// edge alone (ab, denom + eps, the straddle divisor) are rounded once
// per edge by the same operations as the plain version's, and py - ay is
// the same rounded value in both branches.
//
// What bounds it on an H100: operations.  Per (point, geometry, valid
// edge) two compares; per straddling one py - ay, by - ay, the divide,
// bx - ax, a multiply, an add and the compare; per (point, geometry,
// valid edge) of the distance 18 operations and the divide (ap, the dot
// product, the guard, the clip, the projection, d and d2, the min), and
// a sqrt per pair.  chip_smoke.py counts the straddling edges from the
// run's own points and edges.  At 2^20 points x the 281 taxi zones
// (4,456 valid edges) that is some 1.3e11 float64 operations, 7.8 ms at
// 17e12 a second; the 3.5 GB of outputs take about 1.1 ms at 3.35 TB/s.
//
// Design: a block owns an output tile of kTilePts points x kTileGeoms
// consecutive geometries (grid: the geometry tiles of one point tile
// next to each other, so a row of the outputs is written by neighbouring
// blocks at about one time).  A warp takes one geometry of the tile at a
// time (the next one from a counter in shared memory, as geometries
// differ in their valid edges) and its lanes kPts points each, so every
// edge read from shared memory serves 32 x kPts points by broadcast.
// The warp stages the geometry's slots 32 at a time: each lane reads one
// mask byte, a ballot compacts the valid slots, and their lanes read the
// coordinates and store the edge's terms (struct of 8, 16-byte loads) in
// the warp's part of shared memory.  The results go to a shared tile
// and leave as whole rows: 32 consecutive geometries of a point, 128
// bytes of counts and 256 of float64 distances, each written once.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPts = 2;                  // points a lane
constexpr int kTilePts = 32 * kPts;      // points a block
constexpr int kTileGeoms = 32;           // geometries a block
constexpr unsigned kFull = 0xffffffffu;

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

// An edge's terms, each rounded once as the plain version rounds it:
// a, by, ab = b - a, den = abx*abx + aby*aby + eps and the straddle's
// divisor sdiv = (by == ay ? 1 : by - ay).  Eight values, so a lane
// reads it in 16-byte pieces.
template <typename T>
struct alignas(16) EdgeTerms {
  T ax, ay, by, abx, aby, den, sdiv, pad;
};

template <typename T>
__device__ __forceinline__ void load_terms(const EdgeTerms<T>* s, T& ax,
                                           T& ay, T& by, T& abx, T& aby,
                                           T& den, T& sdiv);

template <>
__device__ __forceinline__ void load_terms<double>(
    const EdgeTerms<double>* s, double& ax, double& ay, double& by,
    double& abx, double& aby, double& den, double& sdiv) {
  const double2* v = reinterpret_cast<const double2*>(s);
  const double2 v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
  ax = v0.x, ay = v0.y, by = v1.x, abx = v1.y, aby = v2.x, den = v2.y;
  sdiv = v3.x;
}

template <>
__device__ __forceinline__ void load_terms<float>(
    const EdgeTerms<float>* s, float& ax, float& ay, float& by, float& abx,
    float& aby, float& den, float& sdiv) {
  const float4* v = reinterpret_cast<const float4*>(s);
  const float4 v0 = v[0], v1 = v[1];
  ax = v0.x, ay = v0.y, by = v0.z, abx = v0.w, aby = v1.x, den = v1.y;
  sdiv = v1.z;
}

template <typename T, bool COUNT, bool DIST>
__global__ void __launch_bounds__(kThreads)
    query_tile_kernel(const T* __restrict__ pts, const T* __restrict__ a,
                      const T* __restrict__ b, const bool* __restrict__ mask,
                      long long N, long long G, int E, int gtiles,
                      int* __restrict__ count, T* __restrict__ dist) {
  __shared__ EdgeTerms<T> sedge[kWarps][32];
  __shared__ int scount[COUNT ? kTilePts : 1][kTileGeoms + 1];
  __shared__ T sdist[DIST ? kTilePts : 1][kTileGeoms + 1];
  __shared__ int next_geom;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g0 = (long long)(blockIdx.x % gtiles) * kTileGeoms;
  const long long n0 = (long long)(blockIdx.x / gtiles) * kTilePts;
  const int ng = (int)min((long long)kTileGeoms, G - g0);
  const T zero = T(0), one = T(1), eps = Eps<T>::value();
  T px[kPts], py[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const long long n = n0 + lane + 32 * k;
    px[k] = n < N ? __ldg(pts + 2 * n) : zero;
    py[k] = n < N ? __ldg(pts + 2 * n + 1) : zero;
  }
  if (threadIdx.x == 0) next_geom = kWarps;
  __syncthreads();
  EdgeTerms<T>* mine = sedge[warp];
  for (int gi = warp; gi < ng;) {
    const long long g = g0 + gi;
    const T* ag = a + g * E * 2;
    const T* bg = b + g * E * 2;
    const bool* mg = mask + g * E;
    int cnt[kPts];
    T dmin[kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) cnt[k] = 0, dmin[k] = T(INFINITY);
    for (int s0 = 0; s0 < E; s0 += 32) {
      const int e = s0 + lane;
      const bool valid = e < E && mg[e];
      const unsigned ballot = __ballot_sync(kFull, valid);
      if (valid) {
        EdgeTerms<T> t;
        const T ax = __ldg(ag + 2 * e), ay = __ldg(ag + 2 * e + 1);
        const T bx = __ldg(bg + 2 * e), by = __ldg(bg + 2 * e + 1);
        t.ax = ax, t.ay = ay, t.by = by;
        t.abx = bx - ax, t.aby = by - ay;
        t.den = (t.abx * t.abx + t.aby * t.aby) + eps;
        t.sdiv = by == ay ? one : t.aby;
        t.pad = zero;
        mine[__popc(ballot & ((1u << lane) - 1u))] = t;
      }
      __syncwarp();
      const int nv = __popc(ballot);
      for (int j = 0; j < nv; ++j) {
        T ax, ay, by, abx, aby, den, sdiv;
        load_terms(mine + j, ax, ay, by, abx, aby, den, sdiv);
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          const T apy = py[k] - ay;
          if (COUNT && ((ay <= py[k]) != (by <= py[k]))) {
            const T t = apy / sdiv;
            const T xi = ax + t * abx;
            cnt[k] += px[k] < xi;
          }
          if constexpr (DIST) {
            const T apx = px[k] - ax;
            T t = (apx * abx + apy * aby) / den;
            if (t == t) t = t < zero ? zero : (t > one ? one : t);
            const T dx = px[k] - (ax + t * abx);
            const T dy = py[k] - (ay + t * aby);
            const T d2 = dx * dx + dy * dy;
            if (d2 < dmin[k] || d2 != d2) dmin[k] = d2;
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      if constexpr (COUNT) scount[lane + 32 * k][gi] = cnt[k];
      if constexpr (DIST) sdist[lane + 32 * k][gi] = root(dmin[k]);
    }
    int nxt = 0;
    if (lane == 0) nxt = atomicAdd(&next_geom, 1);
    gi = __shfl_sync(kFull, nxt, 0);
  }
  __syncthreads();
  // whole rows: a warp writes one point's run of ng geometries
  for (int i = threadIdx.x; i < kTilePts * kTileGeoms; i += kThreads) {
    const int r = i / kTileGeoms, c = i % kTileGeoms;
    const long long n = n0 + r;
    if (c >= ng || n >= N) continue;
    if constexpr (COUNT) count[n * G + g0 + c] = scount[r][c];
    if constexpr (DIST) dist[n * G + g0 + c] = sdist[r][c];
  }
}

template <typename T, bool COUNT, bool DIST>
int launch_one(const T* pts, const T* a, const T* b, const bool* mask,
               long long N, long long G, int E, int* count, T* dist,
               cudaStream_t stream) {
  const long long gtiles = (G + kTileGeoms - 1) / kTileGeoms;
  const long long blocks = (N + kTilePts - 1) / kTilePts * gtiles;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  query_tile_kernel<T, COUNT, DIST><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      pts, a, b, mask, N, G, E, (int)gtiles, count, dist);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* pts, const T* a, const T* b, const bool* mask,
           long long N, long long G, int E, int* count, T* dist,
           cudaStream_t stream) {
  if (count && dist)
    return launch_one<T, true, true>(pts, a, b, mask, N, G, E, count, dist,
                                     stream);
  if (count)
    return launch_one<T, true, false>(pts, a, b, mask, N, G, E, count, dist,
                                      stream);
  if (dist)
    return launch_one<T, false, true>(pts, a, b, mask, N, G, E, count, dist,
                                      stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// points [N, 2], a and b [G, E, 2] and dist [N, G] of one type, mask
// [G, E] bool, count [N, G] int32, all contiguous on the device; count or
// dist may be null (not both); ceil(N / 64) * ceil(G / 32) below 2^31
// (the wrapper checks them).  Launches on `stream` and returns the
// launch's CUDA error.
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

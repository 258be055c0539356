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
// Why the design below keeps that.  (1) A masked slot never hits, and
// the answer is an OR, so testing only the valid edge pairs, in any
// order, and stopping at a pair's first hit gives the same booleans.
// (2) The edge vectors v = b - a are the plain version's own rounded
// differences, computed once an edge.  (3) d3 is computed as
// v1y*(a1x-a2x) - v1x*(a1y-a2y) where the plain version computes
// v1x*(a2y-a1y) - v1y*(a2x-a1x).  Round-to-nearest is odd-symmetric, so
// RN(a2 - a1) = -RN(a1 - a2) and RN(v * -u) = -RN(v * u); the two
// products are therefore the same magnitudes P and Q with both signs
// flipped, and RN(-P - (-Q)) = RN(Q - P), the same real difference
// rounded once.  Where a1 and a2 share a coordinate the difference is
// +0 on one side and -0 on the other; that changes at most the sign of
// a zero product or of a zero d3 (an infinite or NaN factor makes NaN on
// both sides), and every test of a d compares it with 0, which -0 and +0
// pass alike.  (4) When no d is 0 the touch tests are false and the
// answer is the four sign tests; when one is 0 the proper test is false
// and the answer is the four touch tests; so the proper test alone over
// every pair, and the touch tests over the pairs of an item in which
// some d was 0, OR to the same answer.  (5) Which pairs take which form
// of the test does not change it, so zero-length edges may go apart
// with the whole test.  No filter skips a pair: two
// nearly collinear segments with disjoint bboxes can pass the proper test
// on rounding noise, and the plain version answers true for them.
//
// What bounds it on an H100: operations.  A pair whose answer is false
// needs every valid edge pair of it tested; one whose answer is true
// needs at least one.  A test needs 26: the three coordinate differences
// a1 - a2, b1 - a2, b2 - a1 (6; the edges' own vectors once an edge),
// four orientations of two multiplies and a subtract (12) and their
// eight sign and zero tests.  chip_smoke.py counts both kinds of pairs
// and their valid edges from the run's own data.
//
// Design: a block owns T1 x T2 geometry pairs (T chosen by the wrapper,
// ops/edges_cross.py cross_tile, so that a tile's slots fit the block's
// buffers).  It compacts the valid edges of its T1 g1 geometries (up to
// kSlots1 slots a pass, a block-wide ballot scan in slot order) into
// shared memory with their vectors and their geometry, and likewise its
// T2 g2 geometries (kSlots2 slots a pass) with each geometry's run.
// Zero-length edges (b - a == 0) go to the back of the buffer: they make
// two d exactly 0 against every edge, so the proper test is false and
// only the touch tests can hit (one such edge in each of the counties:
// 11.55% of their tests, tools/k12_k13_compare.py --census).  Their
// pairs with every edge of the other side take the whole test, the
// lanes over the longer list.
// The rest: a warp takes work items (a chunk of 32 consecutive g1 edges,
// one g2 geometry); its lanes hold the chunk's edges in registers, one
// each, so a chunk spans several g1 geometries and few lanes idle; they
// walk g2's edges, each read by all lanes at once from shared memory,
// with 32-bit indices and no division in the loop, and take the proper
// test alone, without a branch.  A lane that met a zero d (a shared
// vertex or a collinear edge: 0.018% of the counties' other tests) has
// its item walked again with the touch tests, unless its answer is in;
// a branch to them inside the loop doubled its time on the card.  A
// ballot a step ORs the hits; the warp stops once every g1 geometry of
// its chunk has hit g2 (or had before), the early exit the JAX body's
// any() allows.  The answers gather in a shared T1 x T2 tile of bytes,
// written out row by row.  Tiles past kSlots slots (E above them) take
// several passes over their slots, the answers ORed.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlots1 = 512;             // g1 slots a pass
constexpr int kSlots2 = 512;             // g2 slots a pass
constexpr int kMaxTile = 64;             // geometries a tile, each side
constexpr unsigned kFull = 0xffffffffu;

// An edge: its ends and its vector b - a (16-byte aligned in float64,
// 8 in float32, read in pairs of values).
template <typename T>
struct alignas(2 * sizeof(T)) Seg {
  T ax, ay, bx, by, vx, vy;
};

template <typename T>
struct Vec2;
template <>
struct Vec2<double> {
  using type = double2;
};
template <>
struct Vec2<float> {
  using type = float2;
};

template <typename T>
__device__ __forceinline__ Seg<T> load_seg(const Seg<T>* s) {
  using V = typename Vec2<T>::type;
  const V* v = reinterpret_cast<const V*>(s);
  const V p = v[0], q = v[1], r = v[2];
  return Seg<T>{p.x, p.y, q.x, q.y, r.x, r.y};
}

template <typename T>
__device__ __forceinline__ T nmin(T x, T y) {
  return (x < y || x != x) ? x : y;
}

template <typename T>
__device__ __forceinline__ T nmax(T x, T y) {
  return (x > y || x != x) ? x : y;
}

template <typename T>
__device__ __forceinline__ bool on_seg(T px, T py, T qx, T qy, T rx, T ry,
                                       T d) {
  return d == T(0) && nmin(px, qx) <= rx && rx <= nmax(px, qx) &&
         nmin(py, qy) <= ry && ry <= nmax(py, qy);
}

// The four orientations of g1's edge p (a1 b1) and g2's edge q (a2 b2)
template <typename T>
__device__ __forceinline__ void orient4(const Seg<T>& p, const Seg<T>& q,
                                        T (&d)[4]) {
  const T ux = p.ax - q.ax, uy = p.ay - q.ay;  // a1 - a2
  const T wx = p.bx - q.ax, wy = p.by - q.ay;  // b1 - a2
  const T zx = q.bx - p.ax, zy = q.by - p.ay;  // b2 - a1
  d[0] = q.vx * uy - q.vy * ux;
  d[1] = q.vx * wy - q.vy * wx;
  d[2] = p.vy * ux - p.vx * uy;                // see (3) above
  d[3] = p.vx * zy - p.vy * zx;
}

template <typename T>
__device__ __forceinline__ bool no_zero(const T (&d)[4]) {
  const T z = T(0);
  return (d[0] != z) & (d[1] != z) & (d[2] != z) & (d[3] != z);
}

// the proper crossing where no d is 0
template <typename T>
__device__ __forceinline__ bool crosses(const T (&d)[4]) {
  const T z = T(0);
  return ((d[0] > z) != (d[1] > z)) & ((d[2] > z) != (d[3] > z));
}

// the touch tests, false unless some d is 0
template <typename T>
__device__ __forceinline__ bool touches(const Seg<T>& p, const Seg<T>& q,
                                        const T (&d)[4]) {
  return on_seg(q.ax, q.ay, q.bx, q.by, p.ax, p.ay, d[0]) ||
         on_seg(q.ax, q.ay, q.bx, q.by, p.bx, p.by, d[1]) ||
         on_seg(p.ax, p.ay, p.bx, p.by, q.ax, q.ay, d[2]) ||
         on_seg(p.ax, p.ay, p.bx, p.by, q.bx, q.by, d[3]);
}

// Compacts the valid slots among [f0, f0 + len) of a tile's slots (its
// geometries' slots in a row, E a geometry, from geometry 0 at a, b, m),
// in slot order, into seg: the edges of nonzero length from the front,
// the zero-length ones (b - a == 0) from the back, seg[S - 1] first; own
// gets each one's geometry at the same place.  start (if given) gets,
// for each geometry t the range touches, the position of its first
// nonzero-length edge at start[t - f0 / E], and their count after the
// last.  S / kThreads slots a thread; ends with a __syncthreads.
// Returns the counts (nonzero length, zero length).
template <typename T, int S>
__device__ int2 stage(const T* __restrict__ a, const T* __restrict__ b,
                      const bool* __restrict__ m, int E, int f0, int len,
                      Seg<T>* seg, unsigned char* own, int* start,
                      int* scan) {
  constexpr int R = S / kThreads;
  static_assert(R * kWarps <= 32, "one warp scans the warp counts");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Seg<T> e[R];
  bool line[R], point[R];
  int pre[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = r * kThreads + threadIdx.x;
    const int slot = f0 + f;
    const bool valid = f < len && m[slot];
    if (valid) {
      const T ax = __ldg(a + 2 * slot), ay = __ldg(a + 2 * slot + 1);
      const T bx = __ldg(b + 2 * slot), by = __ldg(b + 2 * slot + 1);
      e[r] = Seg<T>{ax, ay, bx, by, bx - ax, by - ay};
    }
    point[r] = valid && e[r].vx == T(0) && e[r].vy == T(0);
    line[r] = valid && !point[r];
    const unsigned bl = __ballot_sync(kFull, line[r]);
    const unsigned bp = __ballot_sync(kFull, point[r]);
    // both counts in one word: a pass holds fewer than 2^16 slots
    pre[r] = __popc(bl & below) | (__popc(bp & below) << 16);
    if (lane == 0) scan[r * kWarps + warp] = __popc(bl) | (__popc(bp) << 16);
  }
  __syncthreads();
  if (warp == 0) {
    const int x = lane < R * kWarps ? scan[lane] : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane < R * kWarps) scan[lane] = incl - x;
    if (lane == 31) scan[32] = incl;
  }
  __syncthreads();
  const int total = scan[32];
  const int t0 = f0 / E;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = r * kThreads + threadIdx.x;
    const int slot = f0 + f;
    const int pos = scan[r * kWarps + warp] + pre[r];
    const int at = line[r] ? (pos & 0xffff) : S - 1 - (pos >> 16);
    if (line[r] || point[r]) {
      seg[at] = e[r];
      own[at] = (unsigned char)(slot / E);
    }
    if (start && f < len && (f == 0 || slot % E == 0))
      start[slot / E - t0] = pos & 0xffff;
  }
  if (start && threadIdx.x == 0)
    start[(f0 + len - 1) / E - t0 + 1] = total & 0xffff;
  __syncthreads();
  return make_int2(total & 0xffff, total >> 16);
}

// Every pair of g1's edges s1[x0, x1) and g2's edges s2[y0, y1), the
// whole test: the warps take the edges of one side, their lanes those of
// the other (g1's when LANES_G1), so a list of a few zero-length edges
// meets a long list with every lane busy; a hit sets its cell.
template <typename T, bool LANES_G1>
__device__ void cross_lists(const Seg<T>* s1, const unsigned char* o1,
                            int x0, int x1, const Seg<T>* s2,
                            const unsigned char* o2, int y0, int y1,
                            volatile unsigned char* res, int T2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = LANES_G1 ? y1 - y0 : x1 - x0;
  const int nl = LANES_G1 ? x1 - x0 : y1 - y0;
  for (int w = warp; w < nw; w += kWarps)
    for (int l = lane; l < nl; l += 32) {
      const int x = x0 + (LANES_G1 ? l : w), y = y0 + (LANES_G1 ? w : l);
      const Seg<T> p = load_seg(s1 + x), q = load_seg(s2 + y);
      T d[4];
      orient4(p, q, d);
      if ((no_zero(d) & crosses(d)) | touches(p, q, d))
        res[o1[x] * T2 + o2[y]] = 1;
    }
}

template <typename T>
constexpr int smem_bytes() {
  return (kSlots1 + kSlots2) * ((int)sizeof(Seg<T>) + 1) +
         (kMaxTile + 2) * 4 + 34 * 4 + kMaxTile * kMaxTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cross_tile_kernel(const T* __restrict__ a1, const T* __restrict__ b1,
                      const bool* __restrict__ m1, const T* __restrict__ a2,
                      const T* __restrict__ b2, const bool* __restrict__ m2,
                      long long G1, long long G2, int E1, int E2, int T1,
                      int T2, int tiles2, bool* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Seg<T>* seg1 = reinterpret_cast<Seg<T>*>(smem);
  Seg<T>* seg2 = seg1 + kSlots1;
  unsigned char* own1 = reinterpret_cast<unsigned char*>(seg2 + kSlots2);
  unsigned char* own2 = own1 + kSlots1;
  int* start2 = reinterpret_cast<int*>(own2 + kSlots2);
  int* scan = start2 + kMaxTile + 2;
  volatile unsigned char* res =
      reinterpret_cast<unsigned char*>(scan + 34);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g1 = (long long)(blockIdx.x / tiles2) * T1;
  const long long g2 = (long long)(blockIdx.x % tiles2) * T2;
  const int n1 = (int)min((long long)T1, G1 - g1);
  const int n2 = (int)min((long long)T2, G2 - g2);
  for (int i = threadIdx.x; i < T1 * T2; i += kThreads) res[i] = 0;
  const T* p1 = a1 + g1 * E1 * 2;
  const T* q1 = b1 + g1 * E1 * 2;
  const bool* v1 = m1 + g1 * E1;
  const T* p2 = a2 + g2 * E2 * 2;
  const T* q2 = b2 + g2 * E2 * 2;
  const bool* v2 = m2 + g2 * E2;
  const int slots1 = n1 * E1, slots2 = n2 * E2;
  for (int f1 = 0; f1 < slots1; f1 += kSlots1) {
    __syncthreads();
    const int2 c1 = stage<T, kSlots1>(p1, q1, v1, E1, f1,
                                      min(kSlots1, slots1 - f1), seg1, own1,
                                      nullptr, scan);
    const int chunks = (c1.x + 31) >> 5;
    for (int f2 = 0; f2 < slots2; f2 += kSlots2) {
      __syncthreads();
      const int len2 = min(kSlots2, slots2 - f2);
      const int2 c2 = stage<T, kSlots2>(p2, q2, v2, E2, f2, len2, seg2, own2,
                                        start2, scan);
      // zero-length edges, with every edge of the other side
      cross_lists<T, false>(seg1, own1, kSlots1 - c1.y, kSlots1, seg2, own2,
                            0, c2.x, res, T2);
      cross_lists<T, false>(seg1, own1, kSlots1 - c1.y, kSlots1, seg2, own2,
                            kSlots2 - c2.y, kSlots2, res, T2);
      cross_lists<T, true>(seg1, own1, 0, c1.x, seg2, own2, kSlots2 - c2.y,
                           kSlots2, res, T2);
      // edges of nonzero length: work items (chunk, g2 geometry)
      const int tlo = f2 / E2, nt = (f2 + len2 - 1) / E2 - tlo + 1;
      int cur = -1, own = 0;
      bool active = false;
      unsigned group = 0;
      Seg<T> e{};
      for (int item = warp; item < chunks * nt; item += kWarps) {
        const int c = item / nt, t = item - c * nt;
        if (c != cur) {
          cur = c;
          const int idx = c * 32 + lane;
          active = idx < c1.x;
          e = active ? load_seg(seg1 + idx) : Seg<T>{};
          if (active) own = own1[idx];
          // the lanes of the same g1 geometry
          group = __match_any_sync(kFull, active ? own : 256 + lane);
        }
        const int j0 = start2[t], j1 = start2[t + 1];
        if (j0 == j1) continue;
        volatile unsigned char* cell = res + own * T2 + tlo + t;
        const bool done = !active || *cell;
        if (__all_sync(kFull, done)) continue;
        // The walk takes the proper test alone and notes a lane that met
        // a zero d.  Only then, and only while its geometry's answer is
        // still open, a second walk over the same edges adds the touch
        // tests: they are false without a zero d.  Keeping them out of
        // the first walk's loop halves its time.
        unsigned acc = 0;
        bool zero = false;
        for (int j = j0; j < j1; ++j) {
          T d[4];
          orient4(e, load_seg(seg2 + j), d);
          const bool nz = no_zero(d);
          zero |= !nz;
          acc |= __ballot_sync(kFull, active && nz && crosses(d));
          if (__all_sync(kFull, done || (acc & group))) break;
        }
        if (__any_sync(kFull, active && zero && !done && !(acc & group))) {
          bool hit = false;
          for (int j = j0; j < j1; ++j) {
            const Seg<T> q = load_seg(seg2 + j);
            T d[4];
            orient4(e, q, d);
            hit |= touches(e, q, d);
          }
          acc |= __ballot_sync(kFull, active && hit);
        }
        if (acc & (1u << lane)) *cell = 1;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T1 * T2; i += kThreads) {
    const int r = i / T2, c = i - r * T2;
    if (r < n1 && c < n2) out[(g1 + r) * G2 + g2 + c] = res[i];
  }
}

template <typename T>
int launch(const T* a1, const T* b1, const bool* m1, const T* a2,
           const T* b2, const bool* m2, long long G1, long long G2, int E1,
           int E2, int T1, int T2, bool* out, cudaStream_t stream) {
  // the tiles must fit the buffers: own1 holds a byte, res T1 x T2
  if (T1 < 1 || T2 < 1 || T1 > kMaxTile || T2 > kMaxTile ||
      (T1 > 1 && T1 * E1 > kSlots1) || (T2 > 1 && T2 * E2 > kSlots2) ||
      E1 < 0 || E2 < 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles1 = (G1 + T1 - 1) / T1;
  const long long tiles2 = (G2 + T2 - 1) / T2;
  if (tiles1 * tiles2 >= (1ll << 31) || (long long)E1 * T1 >= (1ll << 31) ||
      (long long)E2 * T2 >= (1ll << 31))
    return (int)cudaErrorInvalidConfiguration;
  constexpr int bytes = smem_bytes<T>();
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return (int)rc;
  static bool sized[64] = {};
  if (device >= 64 || !sized[device]) {
    rc = cudaFuncSetAttribute(cross_tile_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
    if (rc != cudaSuccess) return (int)rc;
    if (device < 64) sized[device] = true;
  }
  cross_tile_kernel<T><<<(unsigned)(tiles1 * tiles2), kThreads, bytes,
                         stream>>>(a1, b1, m1, a2, b2, m2, G1, G2, E1, E2,
                                   T1, T2, (int)tiles2, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a1, b1 [G1, E1, 2] and a2, b2 [G2, E2, 2] of one type, m1 [G1, E1] and
// m2 [G2, E2] bool, out [G1, G2] bool, all contiguous on the device; T1
// and T2 the geometries a tile (ops/edges_cross.py cross_tile with
// kSlots1 and kSlots2).  Launches on `stream` and returns the
// launch's CUDA error.
int edges_cross_f32_launch(const float* a1, const float* b1, const bool* m1,
                           const float* a2, const float* b2, const bool* m2,
                           long long G1, long long G2, int E1, int E2,
                           int T1, int T2, bool* out, void* stream) {
  if (G1 <= 0 || G2 <= 0) return 0;
  return launch<float>(a1, b1, m1, a2, b2, m2, G1, G2, E1, E2, T1, T2, out,
                       (cudaStream_t)stream);
}

int edges_cross_f64_launch(const double* a1, const double* b1,
                           const bool* m1, const double* a2,
                           const double* b2, const bool* m2, long long G1,
                           long long G2, int E1, int E2, int T1, int T2,
                           bool* out, void* stream) {
  if (G1 <= 0 || G2 <= 0) return 0;
  return launch<double>(a1, b1, m1, a2, b2, m2, G1, G2, E1, E2, T1, T2, out,
                        (cudaStream_t)stream);
}

const char* edges_cross_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

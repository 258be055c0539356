// Tessellation's cell classification for Hopper (sm_90a): for every
// (cell, geometry) pair, whether the geometry touches the cell and
// whether the cell is core (wholly inside it), in exact float64.
//
// Replaces two XLA bodies of the JAX package's classify pass,
// mosaic_tpu/core/tessellate.py classify_cells_multi (:282-352):
//   * _parity_block (:330, `tess/parity`): the crossing parity of the
//     cell centre and its K vertices against the geometry's edges,
//       straddle = (ay <= py) != (by <= py)
//       t  = (py - ay) / (by == ay ? 1 : by - ay);  xi = ax + t * (bx - ax)
//       hit = straddle && px < xi;
//   * _pair_check (:102, `tess/pair_check`): for the (cell, edge) pairs
//     whose bounding boxes overlap, whether the edge crosses or touches
//     a cell side (four orientations, proper crossing or an endpoint on
//     the other segment) and whether its start vertex lies inside the
//     convex CCW cell (every side's cross product >= 0).
// Then core = all vertices inside && nothing crossed && no start vertex
// inside; touching = crossed || centre inside || a vertex inside ||
// a start vertex inside || core.  Neither body has a Pallas form.  The
// plain PyTorch version is ops/tess_classify.py classify_pairs_ref.
//
// Bit equality.  Every subtract, multiply and divide is one IEEE
// rounding in numpy's order (explicit __d*_rn; the build also has
// -fmad=false), and the booleans follow from those values, so the
// kernel's booleans equal the plain version's and the JAX package's
// numpy branches.  orient(p, q, r) = (q.x-p.x)*(r.y-p.y) -
// (q.y-p.y)*(r.x-p.x).  The start vertex's cross product is the same
// expression as the side's d3 = orient(v_k, v_k+1, a), and side k's d2
// = orient(a, b, v_k+1) is side k+1's d1, so each is computed once.
//
// What the host's form pads away, and why dropping it changes nothing:
//   * the host pads every geometry's edges to its bucket's width with
//     +inf edges.  A +inf edge has ay = by = +inf, so (ay <= py) ==
//     (by <= py) for every query: it never straddles and adds nothing to
//     a parity; its bbox starts at +inf, so it overlaps no cell's bbox
//     and never reaches the pair check.  The kernel loops over the real
//     edges only;
//   * the host compacts the (cell, edge) pairs whose bboxes overlap
//     before the pair check.  An edge that crosses or touches a side
//     shares a point with it, and an edge whose start vertex lies in the
//     cell has that vertex in the cell's bbox: in real arithmetic each
//     case puts a point in both bboxes, so the filter removes no hit.
//     The kernel keeps the same four compares as a branch in front of
//     the pair check (it skips most edges' orientations), so its
//     booleans are the host's even where rounded orientations could
//     claim a crossing between disjoint nearly collinear segments.
// tests/test_torch_tess_kernels.py checks both facts on seeded and
// degenerate inputs.
//
// Layout: flat CSR, nothing padded.  A geometry's edges are rows
// edge_off[g] .. edge_off[g+1] of edges [E, 4] (ax, ay, bx, by); a
// pair names its geometry and its cell; the cells are a table of
// [U, K] vertices (CCW, rows past the count unread), counts and centres.
// The pairs arrive grouped by geometry, so a block's warps mostly read
// the same edges, which L1 then serves.
//
// What bounds it on an H100: f64 operations.  Per (pair, edge): two
// subtracts and a compare, then per query two compares, and where the
// edge straddles the query a subtract, a divide, a multiply, an add and
// a compare; the bbox test's four min/max and four compares; where the
// bboxes overlap, one orientation per cell vertex and two per cell side,
// with their sign and zero tests.  chip_smoke.py counts these from the
// run's own data.
// Design: one thread a pair, walking the geometry's edges; it keeps the
// pair's K vertices in registers (K <= 10, unrolled), its parity bits
// (one per query) and its hit and inside flags.  A warp a pair, lanes
// over the edges, was the first design: on ~17 edges a pair it left most
// lanes idle and waited on each pair's chain of dependent loads (pair,
// cell, offsets, edges), while a thread a pair keeps 32 pairs' chains in
// flight and reads the warp's shared edges as broadcasts.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 10;
constexpr int kThreads = 256;

__device__ __forceinline__ double orient(double px, double py, double qx,
                                         double qy, double rx, double ry) {
  return __dsub_rn(__dmul_rn(__dsub_rn(qx, px), __dsub_rn(ry, py)),
                   __dmul_rn(__dsub_rn(qy, py), __dsub_rn(rx, px)));
}

// r on segment pq given d = orient(p, q, r): numpy's on_seg
__device__ __forceinline__ bool on_seg(double px, double py, double qx,
                                       double qy, double rx, double ry,
                                       double d) {
  return d == 0.0 && fmin(px, qx) <= rx && rx <= fmax(px, qx) &&
         fmin(py, qy) <= ry && ry <= fmax(py, qy);
}

// One pair's cell: its vertices in registers (K <= 10, unrolled), count,
// centre and bbox; and what its edges have shown so far.
struct Pair {
  double vx[kMaxK], vy[kMaxK];
  double cx, cy, cb0, cb1, cb2, cb3;
  int n;
  unsigned par;                            // bit 0 centre, bit k+1 vertex k
  bool hit, inside;
};

__device__ __forceinline__ void load_pair(Pair& q, const double2* verts,
                                          const int* counts,
                                          const double2* centers,
                                          long long c, int K) {
  q.n = counts[c];
  q.cb0 = q.cb1 = __longlong_as_double(0x7ff0000000000000ll);   // +inf
  q.cb2 = q.cb3 = -q.cb0;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    q.vx[k] = q.vy[k] = 0.0;
    if (k < q.n) {
      const double2 v = verts[c * K + k];
      q.vx[k] = v.x;
      q.vy[k] = v.y;
      q.cb0 = fmin(q.cb0, v.x);
      q.cb1 = fmin(q.cb1, v.y);
      q.cb2 = fmax(q.cb2, v.x);
      q.cb3 = fmax(q.cb3, v.y);
    }
  }
  const double2 ctr = centers[c];
  q.cx = ctr.x;
  q.cy = ctr.y;
  q.par = 0;
  q.hit = q.inside = false;
}

// One edge (ax, ay) -> (bx, by) of the pair's geometry.
__device__ __forceinline__ void edge_step(Pair& q, const double4 E) {
  const double ax = E.x, ay = E.y, bx = E.z, by = E.w;
  const double den = by == ay ? 1.0 : __dsub_rn(by, ay);
  const double dx = __dsub_rn(bx, ax);
#pragma unroll
  for (int j = 0; j <= kMaxK; ++j) {
    if (j <= q.n) {
      const double px = j ? q.vx[j - 1] : q.cx;
      const double py = j ? q.vy[j - 1] : q.cy;
      if ((ay <= py) != (by <= py)) {
        const double t = __ddiv_rn(__dsub_rn(py, ay), den);
        const double xi = __dadd_rn(ax, __dmul_rn(t, dx));
        if (px < xi) q.par ^= 1u << j;
      }
    }
  }
  const bool overlap = q.cb0 <= fmax(ax, bx) && fmin(ax, bx) <= q.cb2 &&
                       q.cb1 <= fmax(ay, by) && fmin(ay, by) <= q.cb3;
  if (!overlap) return;
  double d[kMaxK];                         // orient(a, b, v_k)
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    d[k] = k < q.n ? orient(ax, ay, bx, by, q.vx[k], q.vy[k]) : 0.0;
  bool all_left = true;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < q.n) {
      const bool wrap = k + 1 >= q.n;
      const int k1 = (k + 1) % kMaxK;
      const double ux = q.vx[k], uy = q.vy[k];
      const double wx = wrap ? q.vx[0] : q.vx[k1];
      const double wy = wrap ? q.vy[0] : q.vy[k1];
      const double d1 = d[k];
      const double d2 = wrap ? d[0] : d[k1];
      const double d3 = orient(ux, uy, wx, wy, ax, ay);
      const double d4 = orient(ux, uy, wx, wy, bx, by);
      const bool proper = ((d1 > 0.0) != (d2 > 0.0)) &&
                          ((d3 > 0.0) != (d4 > 0.0)) && d1 != 0.0 &&
                          d2 != 0.0 && d3 != 0.0 && d4 != 0.0;
      const bool touch = on_seg(ax, ay, bx, by, ux, uy, d1) ||
                         on_seg(ax, ay, bx, by, wx, wy, d2) ||
                         on_seg(ux, uy, wx, wy, ax, ay, d3) ||
                         on_seg(ux, uy, wx, wy, bx, by, d4);
      q.hit = q.hit || proper || touch;
      all_left = all_left && d3 >= 0.0;
    }
  }
  q.inside = q.inside || all_left;
}

__device__ __forceinline__ void finish(const Pair& q, long long p,
                                       bool* touching, bool* core) {
  const unsigned vmask = (1u << q.n) - 1u;
  const unsigned vin = (q.par >> 1) & vmask;
  const bool is_core = vin == vmask && !q.hit && !q.inside;
  core[p] = is_core;
  touching[p] = q.hit || (q.par & 1u) || vin != 0 || q.inside || is_core;
}

// One thread a pair, over all its geometry's edges.
__global__ void __launch_bounds__(kThreads)
classify_kernel(const double4* __restrict__ edges,
                const long long* __restrict__ edge_off,
                const long long* __restrict__ pair_geo,
                const long long* __restrict__ pair_cell,
                const double2* __restrict__ verts,
                const int* __restrict__ counts,
                const double2* __restrict__ centers, int K, long long P,
                bool* __restrict__ touching, bool* __restrict__ core) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long g = pair_geo[p];
  Pair q;
  load_pair(q, verts, counts, centers, pair_cell[p], K);
  const long long e1 = edge_off[g + 1];
  for (long long e = edge_off[g]; e < e1; ++e) edge_step(q, edges[e]);
  finish(q, p, touching, core);
}

}  // namespace

extern "C" {

// edges [E, 4] f64 (32-byte aligned), edge_off [G + 1] i64, pair_geo and
// pair_cell [P] i64, verts [U, K, 2] f64 (16-byte aligned), counts [U]
// i32 (each <= K <= 10), centers [U, 2] f64; touching and core [P] bool.
// All on the device; the wrapper checks shapes, types and alignment.
// Launches on `stream` and returns the launch's CUDA error.
int tess_classify_launch(const double* edges, const long long* edge_off,
                         const long long* pair_geo,
                         const long long* pair_cell, const double* verts,
                         const int* counts, const double* centers, int K,
                         long long P, bool* touching, bool* core,
                         void* stream) {
  if (P <= 0) return 0;
  const long long blocks = (P + kThreads - 1) / kThreads;
  classify_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const double4*>(edges), edge_off, pair_geo, pair_cell,
      reinterpret_cast<const double2*>(verts), counts,
      reinterpret_cast<const double2*>(centers), K, P, touching, core);
  return (int)cudaGetLastError();
}

const char* tess_classify_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Tessellation's cell classification for Hopper (sm_90a): for every
// (cell, geometry) pair, whether the geometry touches the cell and
// whether the cell is core (wholly inside it), in exact float64.
//
// Replaces two XLA bodies of the JAX package's classify pass,
// mosaic_tpu/core/tessellate.py classify_cells_multi (:385):
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
// A pair's parity bits are combined across its edges with XOR, and its
// crossed and inside flags with OR: both are order-free, so however the
// lanes split the work, the booleans are the plain version's.
//
// What the host's form pads away, and why dropping it changes nothing:
//   * the host pads every geometry's edges to its bucket's width with
//     +inf edges.  A +inf edge has ay = by = +inf, so (ay <= py) ==
//     (by <= py) for every query: it never straddles and adds nothing to
//     a parity; its bbox starts at +inf, so it overlaps no cell's bbox
//     and never reaches the pair check.  The kernel visits the real
//     edges only;
//   * the host compacts the (cell, edge) pairs whose bboxes overlap
//     before the pair check.  An edge that crosses or touches a side
//     shares a point with it, and an edge whose start vertex lies in the
//     cell has that vertex in the cell's bbox: in real arithmetic each
//     case puts a point in both bboxes, so the filter removes no hit.
//     The kernel compacts the same (cell, edge) pairs with the same four
//     compares, so its booleans are the host's even where rounded
//     orientations could claim a crossing between disjoint nearly
//     collinear segments.
// tests/test_torch_tess_kernels.py checks both facts on seeded and
// degenerate inputs, and holds a numpy model of the kernel's lanes and
// queue to the plain version.
//
// Layout: flat CSR, nothing padded.  A geometry's edges are rows
// edge_off[g] .. edge_off[g+1] of edges [E, 4] (ax, ay, bx, by); a
// pair names its geometry and its cell; the cells are a table of
// [U, K] vertices (CCW, rows past the count unread), counts and centres.
//
// What bounds it on an H100: f64 operations.  Per edge of a geometry
// that a pair names, once: bx - ax, its rounded end ax + (bx - ax) and
// its bbox's four min/max; per (pair, edge) the bbox test's four
// compares; per query two compares, where the edge straddles the
// query two more, where the query is not left of both ends two more,
// and where those do not settle it a subtract, a divide, a multiply, an
// add and a compare; where the bboxes overlap
// (5% of the county run's (pair, edge) items), one orientation per cell
// vertex and two per cell side, with their sign and zero tests.
// chip_smoke.py counts these from the run's own data.
//
// Design: W lanes a pair (W in {1, 2, 4, 8, 16, 32}: the wrapper gives
// a lane at least 8 edges of the mean pair, 2 lanes on the county run
// and the taxi zones, 1 on the footprints, and widens the groups of a
// launch too small to fill the card, a warp a pair on the 533-pair
// degenerate set), 32 / W pairs a warp, and every warp on its own (no
// block barrier):
//   * each lane of a pair's group computes the cell's bbox in registers,
//     and the group's first lane writes the cell's centre and vertices
//     to the warp's shared memory;
//   * phase A, a lane an edge of its pair (the group's lanes on
//     neighbouring edges, each edge loaded a step ahead, and the warp's
//     pairs mostly on one geometry's edges, so the loads broadcast): the
//     crossing parity of every query, and the bbox test.  Where the edge
//     straddles a query, the crossing's x lies between the edge's start
//     ax and its rounded end xe = ax + (bx - ax), so a query left of both
//     is a crossing and one at or right of both is none without the
//     divide; the other queries, and the items whose bboxes overlap, go
//     to the warp's queue in shared memory (ballot and popc for the
//     slots);
//   * phase B, whenever the queue holds 32 items and at the end, a lane
//     a queued item: the divides its queries need, the orientations and
//     the crossed and inside flags, combined in the warp's shared memory;
//   * the group's lanes XOR their parity bits together, and the first
//     writes the pair's two booleans.
// The orientations are held in registers sized by the template's KMAX
// (6 for H3 and four-sided cells, 10 for the widest tables), not by the
// widest cell the kernel takes; __launch_bounds__ keeps a thread at 72
// registers at KMAX 6, 28 warps an SM.
// Why: the first design, a thread a pair, took 0.1718 ms on the county
// run (4.7% of its bound, NVIDIA H100 80GB HBM3): 69% of its warp steps
// ran the orientation pass for the 7.5% of lanes whose bboxes overlapped,
// every straddle ran the divide while the warp's other lanes waited, and
// on long edge lists a few threads walked alone (0.3614 ms on the
// 533-pair degenerate set).  Here the divides and the orientations run
// on full warps from a compacted queue, and a small launch spreads a
// pair's edges over up to 32 lanes.  A block-wide form of the same two
// phases (a lane a (pair, edge) item over a block's run of pairs, a block
// barrier a round) was slower: its rounds waited on their barriers and
// on a binary search for each item's pair.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 64;                  // a warp's queue: >= 2 x 32
constexpr unsigned kFull = 0xffffffffu;
// Below this magnitude a straddle's t = (py - ay) / (by - ay) lies in
// [0, 1] and no difference overflows (see the parity step).
constexpr double kTame = 0x1p1000;
// a queued item's bits: its exact queries (0..KMAX) and kOverlap
constexpr unsigned kOverlap = 1u << 15;

__device__ __forceinline__ bool tame(double v) { return fabs(v) < kTame; }

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

// xi = ax + t * (bx - ax), t = (py - ay) / (by == ay ? 1 : by - ay)
__device__ __forceinline__ double crossing_x(double ax, double ay,
                                            double bx, double by,
                                            double py) {
  const double den = by == ay ? 1.0 : __dsub_rn(by, ay);
  const double t = __ddiv_rn(__dsub_rn(py, ay), den);
  return __dadd_rn(ax, __dmul_rn(t, __dsub_rn(bx, ax)));
}

// A warp's pairs in shared memory (slot s: the warp's s-th pair; query 0
// is the cell's centre, query k + 1 its vertex k) and its queue.
template <int KMAX>
struct Warp {
  double qx[32][KMAX + 1], qy[32][KMAX + 1];
  long long e0[32];                        // the pair's first edge
  int n[32];                               // the cell's vertex count
  unsigned par[32];                        // bit q: query q's parity
  unsigned flags[32];                      // bit 0 crossed, bit 1 inside
  int2 q[kRing];                           // (slot | bits << 5, edge)
};

// The pair check of edge E against every side of slot j's cell: the
// crossed and inside flags ORed in.
template <int KMAX>
__device__ __forceinline__ void pair_check(Warp<KMAX>& s, int j,
                                           const double4 E) {
  const double ax = E.x, ay = E.y, bx = E.z, by = E.w;
  const int n = s.n[j];
  const double* vx = &s.qx[j][1];
  const double* vy = &s.qy[j][1];
  double d[KMAX];                          // orient(a, b, v_k)
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    d[k] = k < n ? orient(ax, ay, bx, by, vx[k], vy[k]) : 0.0;
  bool hit = false, all_left = true;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < n) {
      const bool wrap = k + 1 >= n;
      const int k1 = wrap ? 0 : k + 1;
      const double ux = vx[k], uy = vy[k];
      const double wx = vx[k1], wy = vy[k1];
      const double d1 = d[k];
      const double d2 = wrap ? d[0] : d[(k + 1) % KMAX];
      const double d3 = orient(ux, uy, wx, wy, ax, ay);
      const double d4 = orient(ux, uy, wx, wy, bx, by);
      const bool proper = ((d1 > 0.0) != (d2 > 0.0)) &&
                          ((d3 > 0.0) != (d4 > 0.0)) && d1 != 0.0 &&
                          d2 != 0.0 && d3 != 0.0 && d4 != 0.0;
      const bool touch = on_seg(ax, ay, bx, by, ux, uy, d1) ||
                         on_seg(ax, ay, bx, by, wx, wy, d2) ||
                         on_seg(ux, uy, wx, wy, ax, ay, d3) ||
                         on_seg(ux, uy, wx, wy, bx, by, d4);
      hit = hit || proper || touch;
      all_left = all_left && d3 >= 0.0;
    }
  }
  const unsigned f = (hit ? 1u : 0u) | (all_left ? 2u : 0u);
  if (f) atomicOr(&s.flags[j], f);
}

// Phase B on queue entry `at`: the exact crossings of its queries XORed
// into its pair's parity, the pair check where its bboxes overlap.
template <int KMAX>
__device__ __forceinline__ void drain(Warp<KMAX>& s,
                                      const double4* __restrict__ edges,
                                      int at) {
  const int2 en = s.q[at & (kRing - 1)];
  const int j = en.x & 31;
  const unsigned bits = (unsigned)en.x >> 5;
  const double4 E = edges[s.e0[j] + en.y];
  unsigned exact = bits & ~kOverlap, hit = 0;
  while (exact) {
    const int q = __ffs(exact) - 1;
    exact &= exact - 1;
    if (s.qx[j][q] < crossing_x(E.x, E.y, E.z, E.w, s.qy[j][q]))
      hit |= 1u << q;
  }
  if (hit) atomicXor(&s.par[j], hit);
  if (bits & kOverlap) pair_check(s, j, E);
}

// W lanes a pair, 32 / W pairs a warp, kWarps warps a block; at most 72
// registers a thread at KMAX 6, so 7 blocks (28 warps) fit on an SM, and
// 80 at KMAX 10 (6 blocks), where 72 would spill.
template <int KMAX, int W>
__global__ void __launch_bounds__(kThreads, KMAX <= 6 ? 7 : 6)
classify_kernel(const double4* __restrict__ edges,
                const long long* __restrict__ edge_off,
                const long long* __restrict__ pair_geo,
                const long long* __restrict__ pair_cell,
                const double2* __restrict__ verts,
                const int* __restrict__ counts,
                const double2* __restrict__ centers, int K, long long P,
                bool* __restrict__ touching, bool* __restrict__ core) {
  constexpr int G = 32 / W, Q = KMAX + 1;
  __shared__ Warp<KMAX> warps[kWarps];
  const int lane = threadIdx.x & 31;
  Warp<KMAX>& s = warps[threadIdx.x >> 5];
  const int slot = lane / W, gl = lane % W;
  const long long p =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * G + slot;
  const bool live = p < P;

  // ---- the pair's cell: its bbox in registers (every lane of its
  // group), its queries in the warp's shared memory (the group's first
  // lane writes them)
  double b0 = __longlong_as_double(0x7ff0000000000000ll);   // +inf
  double b1 = b0, b2 = -b0, b3 = -b0;
  bool tame_q = true;
  int n = 0, ne = 0;
  long long e0 = 0;
  if (live) {
    const bool owner = gl == 0;
    const long long g = pair_geo[p], c = pair_cell[p];
    e0 = edge_off[g];
    ne = (int)(edge_off[g + 1] - e0);
    n = counts[c];
    const double2 ctr = centers[c];
    tame_q = tame(ctr.y);
    if (owner) {
      s.qx[slot][0] = ctr.x;
      s.qy[slot][0] = ctr.y;
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < n) {
        const double2 v = verts[c * K + k];
        if (owner) {
          s.qx[slot][k + 1] = v.x;
          s.qy[slot][k + 1] = v.y;
        }
        b0 = fmin(b0, v.x);
        b1 = fmin(b1, v.y);
        b2 = fmax(b2, v.x);
        b3 = fmax(b3, v.y);
        tame_q = tame_q && tame(v.y);
      }
    }
    if (owner) {
      s.e0[slot] = e0;
      s.n[slot] = n;
      s.par[slot] = 0;
      s.flags[slot] = 0;
    }
  }
  __syncwarp();

  // ---- phase A, a lane an edge of its pair; phase B, a lane a queued
  // item, whenever the queue holds a warp's worth
  const int iters = __reduce_max_sync(kFull, (ne + W - 1) / W);
  unsigned parity = 0;                     // this lane's settled bits
  int head = 0, tail = 0;
  double4 next = make_double4(0.0, 0.0, 0.0, 0.0);   // loaded a step ahead
  if (live && gl < ne) next = edges[e0 + gl];
  for (int it = 0; it < iters; ++it) {
    const int e = it * W + gl;
    const double4 E = next;
    if (live && e + W < ne) next = edges[e0 + e + W];
    unsigned bits = 0;
    if (live && e < ne) {
      const double ax = E.x, ay = E.y, bx = E.z, by = E.w;
      // Where the edge straddles a query, t lies in [0, 1] (|py - ay| <=
      // |by - ay|, and rounding keeps the order), so t * dx lies between
      // 0 and dx and xi between ax and xe = ax + dx, rounded the same
      // way: px below both is a crossing, px at or above both is none,
      // whatever xi's last bits.  Only a query between them (or with a
      // coordinate past kTame, or NaN, which fails every compare) is
      // queued for the divide.
      const double xe = __dadd_rn(ax, __dsub_rn(bx, ax));
      const bool sure = tame_q && tame(ax) && tame(ay) && tame(bx) &&
                        tame(by);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (q <= n) {
          const double py = s.qy[slot][q];
          if ((ay <= py) != (by <= py)) {
            const double px = s.qx[slot][q];
            if (sure && px < ax && px < xe)
              parity ^= 1u << q;
            else if (!(sure && px >= ax && px >= xe))
              bits |= 1u << q;
          }
        }
      }
      if (b0 <= fmax(ax, bx) && fmin(ax, bx) <= b2 && b1 <= fmax(ay, by) &&
          fmin(ay, by) <= b3)
        bits |= kOverlap;
    }
    const unsigned m = __ballot_sync(kFull, bits != 0);
    if (bits)
      s.q[(tail + __popc(m & ((1u << lane) - 1u))) & (kRing - 1)] =
          make_int2(slot | (int)(bits << 5), e);
    tail += __popc(m);
    __syncwarp();
    if (tail - head >= 32) {
      drain(s, edges, head + lane);
      head += 32;
      __syncwarp();
    }
  }
  if (lane < tail - head) drain(s, edges, head + lane);
  __syncwarp();

  // ---- the pair's booleans: its lanes' settled bits, XORed together
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    parity ^= __shfl_xor_sync(kFull, parity, o);
  if (live && gl == 0) {
    const unsigned vmask = (1u << n) - 1u;
    const unsigned par = parity ^ s.par[slot], f = s.flags[slot];
    const unsigned vin = (par >> 1) & vmask;
    const bool hit = f & 1u, inside = f & 2u;
    const bool is_core = vin == vmask && !hit && !inside;
    core[p] = is_core;
    touching[p] = hit || (par & 1u) || vin != 0 || inside || is_core;
  }
}

template <int KMAX>
int launch_w(int W, const double4* edges, const long long* edge_off,
             const long long* pair_geo, const long long* pair_cell,
             const double2* verts, const int* counts,
             const double2* centers, int K, long long P, bool* touching,
             bool* core, cudaStream_t stream) {
#define TESS_CLASSIFY_W(w)                                                 \
  case w: {                                                                \
    const long long per_block = (long long)kWarps * (32 / w);              \
    classify_kernel<KMAX, w><<<(unsigned)((P + per_block - 1) / per_block), \
                               kThreads, 0, stream>>>(                     \
        edges, edge_off, pair_geo, pair_cell, verts, counts, centers, K,   \
        P, touching, core);                                                \
    return (int)cudaGetLastError();                                        \
  }
  switch (W) {
    TESS_CLASSIFY_W(1)
    TESS_CLASSIFY_W(2)
    TESS_CLASSIFY_W(4)
    TESS_CLASSIFY_W(8)
    TESS_CLASSIFY_W(16)
    TESS_CLASSIFY_W(32)
  }
#undef TESS_CLASSIFY_W
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// edges [E, 4] f64 (32-byte aligned), edge_off [G + 1] i64, pair_geo and
// pair_cell [P] i64, verts [U, K, 2] f64 (16-byte aligned), counts [U]
// i32 (each <= K <= 10), centers [U, 2] f64; touching and core [P] bool;
// W lanes a pair (1, 2, 4, 8, 16 or 32), every geometry's edge count
// below 2^30.  All on the device; the wrapper checks them.  Launches on
// `stream` and returns the launch's CUDA error.
int tess_classify_launch(const double* edges, const long long* edge_off,
                         const long long* pair_geo,
                         const long long* pair_cell, const double* verts,
                         const int* counts, const double* centers, int K,
                         long long P, int W, bool* touching, bool* core,
                         void* stream) {
  if (P <= 0) return 0;
  if (K < 0 || K > 10) return (int)cudaErrorInvalidValue;
  const auto* e4 = reinterpret_cast<const double4*>(edges);
  const auto* v2 = reinterpret_cast<const double2*>(verts);
  const auto* c2 = reinterpret_cast<const double2*>(centers);
  const auto s = (cudaStream_t)stream;
  if (K <= 6)
    return launch_w<6>(W, e4, edge_off, pair_geo, pair_cell, v2, counts, c2,
                       K, P, touching, core, s);
  return launch_w<10>(W, e4, edge_off, pair_geo, pair_cell, v2, counts, c2,
                      K, P, touching, core, s);
}

const char* tess_classify_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

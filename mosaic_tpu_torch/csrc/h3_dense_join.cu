// Dense H3 point-in-polygon join for Hopper (sm_90a), one thread per
// point: origin-local lon/lat degrees -> (zone, uncertain).
//
// Replaces, in one kernel, the Pallas TPU kernel
// mosaic_tpu/ops/pallas_projection.py project_lattice_pallas and the XLA
// join body that consumes its outputs, the inner fn of
// mosaic_tpu/parallel/pip_join.py make_dense_pip_join_fn (:1689-1748).
// The TPU design left the window and pool gathers to XLA because the
// TPU's gather issue rate, not fusion, was its limit.  On Hopper one
// thread gathers its own window entry and chip-pool row from L2 (the
// flagship's entry table is 198 KB and its pool 4.8 MB, against 50 MB of
// L2), so the five projection outputs never leave registers and the
// join's [N, E, 5] intermediates never reach device memory.  The plain
// PyTorch version is ops/dense_join.py dense_join_ref; this kernel gives
// its bits.
//
// Per point:
//   * far test against the window's local extent: far points are zone
//     -1, certain, and skip the rest;
//   * the projection of h3_df.cuh, its outputs kept in registers;
//   * the window test against (face0, a0, b0, W, H) and the entry read;
//     a core cell's zone is the entry itself;
//   * a border cell walks the edges of its group, in the kernel's copy of
//     the pool (ops/dense_join.py join_tables: each edge one float4 load,
//     zone slots apart, trailing pad edges cut): the near-vertex
//     test on every edge, and for edges that straddle the point's
//     latitude the crossing abscissa xi (the only place it matters, so
//     non-straddling edges divide nothing), the near-crossing test and
//     the crossing parity, kept as 32-bit masks over the zone slots.
//     Near the crossing means |px - xi| < eps (the JAX body's band) or
//     a distance below eps from the edge's line, tested as cr^2 < eps^2
//     * (dx^2 + dy^2) with cr = dx * (py - ay) - dy * (px - ax).  The
//     first band alone misses points beside a nearly horizontal edge:
//     there the f32 rounding of py and ay moves xi by |dx / dy| times
//     as much (~1e-5 degrees for a rise of 3e-6 over 2e-3), and the
//     point is certain and wrong.  The second band has no such factor,
//     so the port flags every point the JAX body flags and those too.
//     Slots go 32 to a pass, a pass ends the walk once a slot is odd,
//     and Z has no cap.  The first odd slot picks the zone in gzones;
//   * uncertain = margin < err | facegap < gap | an edge flag | a wide
//     group, cleared for far points.
//
// Bits: the projection as h3_df.cuh says; xi is ax + t * (bx - ax) with
// t = (py - ay) / (by - ay), and cr as above, each op rounded on its own
// as torch's separate ops round them.
//
// What bounds it: the projection's arithmetic, 821 flops per point (an
// FMA counted as two), plus about 4 per pool edge and 16 per straddling
// edge for border points.  Bytes: 8 in and 5 out per point, and the
// entry and pool rows the points reach, each read once from device
// memory and then from L2.  A warp runs as long as its slowest thread:
// the border points' edge walk.

#include <cuda_runtime.h>

#include "h3_df.cuh"

// The join's statics, passed by value.  Same layout as
// ops/dense_join.py _Params.  Outside the unnamed namespace: the C entry
// point takes it, and a type of internal linkage would hide that symbol.
struct JoinParams {
  int face0, a0, b0, W, H;   // the lattice window
  int E, Z;                  // pool row width, zone slots per group
  float err32, gap32, eps32, far_lim;
};

namespace {

using namespace h3df;

constexpr int kThreads = 256;
constexpr int kCoreFlag = 1 << 30;

// First zone slot whose crossing parity is odd against the first `count`
// edges of one group (coordinates `row` [E] float4 ax, ay, bx, by; zone
// slots `slots` [E]), or -1; `flag` is set when a crossing or a vertex
// lies within eps of the point.
__device__ __forceinline__ int border_slot(float px, float py,
                                           const float4* __restrict__ row,
                                           const int* __restrict__ slots,
                                           int count, const JoinParams& q,
                                           bool& flag) {
  flag = false;
  for (int w = 0; w * 32 < q.Z; ++w) {
    unsigned odd = 0u;
    for (int j = 0; j < count; ++j) {
      const float4 ed = __ldg(row + j);
      const float ax = ed.x, ay = ed.y, bx = ed.z, by = ed.w;
      if (w == 0 && fabsf(sub(py, ay)) < q.eps32 &&
          px < add(fmax_(ax, bx), q.eps32))
        flag = true;
      if ((ay <= py) == (by <= py)) continue;          // no straddle
      const float dx = sub(bx, ax), dy = sub(by, ay);
      const float t = __fdiv_rn(sub(py, ay), dy);
      const float xi = add(ax, mul(t, dx));
      if (w == 0) {
        // near the crossing: within eps of it along x, or within eps of
        // the edge's line (cross^2 < eps^2 * length^2, no divide by dy)
        const float cr = sub(mul(dx, sub(py, ay)), mul(dy, sub(px, ax)));
        if (fabsf(sub(px, xi)) < q.eps32 ||
            mul(cr, cr) < mul(mul(q.eps32, q.eps32),
                              add(mul(dx, dx), mul(dy, dy))))
          flag = true;
      }
      if (px < xi) {
        const int zs = __ldg(slots + j);
        const unsigned s = (unsigned)(zs - 32 * w);
        if (zs < q.Z && s < 32u) odd ^= 1u << s;
      }
    }
    if (odd) return 32 * w + __ffs(odd) - 1;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
dense_join_kernel(const float2* __restrict__ xy, int n,
                  const float* __restrict__ table, Consts k, JoinParams q,
                  const int* __restrict__ entry,
                  const float4* __restrict__ edges,
                  const int* __restrict__ eslot,
                  const int* __restrict__ ecount,
                  const int* __restrict__ gzones,
                  const unsigned char* __restrict__ gwide,
                  int* __restrict__ zone_out,
                  unsigned char* __restrict__ unc_out) {
  __shared__ float tbl[kTable];
  load_table(tbl, table);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float2 p = xy[i];
  int zone = -1;
  bool unc = false;
  if (!(fabsf(p.x) > q.far_lim || fabsf(p.y) > q.far_lim)) {
    const Projection r = project_point(p, tbl, k);
    unc = r.margin < q.err32 || r.gap < q.gap32;
    const int ia = r.a - q.a0, ib = r.b - q.b0;
    const bool inw = r.face == q.face0 && ia >= 0 && ia < q.W && ib >= 0 &&
                     ib < q.H;
    const int e = inw ? __ldg(entry + ia * q.H + ib) : -1;
    if (e >= 0 && (e & kCoreFlag)) {
      zone = e & ~kCoreFlag;
    } else if (e >= 0) {
      bool flag;
      const size_t row = (size_t)e * q.E;
      const int slot = border_slot(p.x, p.y, edges + row, eslot + row,
                                   __ldg(ecount + e), q, flag);
      if (slot >= 0) zone = __ldg(gzones + (size_t)e * q.Z + slot);
      unc = unc || flag || __ldg(gwide + e) != 0;
    }
  }
  zone_out[i] = zone;
  unc_out[i] = unc ? 1 : 0;
}

}  // namespace

extern "C" {

// Upload the [20, 3] f32 face centers to this device's constant memory.
// Once per device before the first launch.
int h3_dense_join_set_faces(const float* faces_host) {
  cudaMemcpyToSymbol(c_face, faces_host, sizeof(float) * kFaces * 3);
  return (int)cudaGetLastError();
}

// xy [n, 2] f32, table [2, 20, 9] f32, entry [W*H] i32, edges [G, E, 4]
// f32 (16-byte aligned), eslot [G, E] i32, ecount [G] i32, gzones [G, Z]
// i32, gwide [G] bool and the outputs zone [n] i32, uncertain [n] bool on
// the device; consts_host [13] f32 and params in host memory.  Launches
// on `stream` and returns the launch's CUDA error code.
int h3_dense_join(const float* xy, int n, const float* table,
                  const float* consts_host, const JoinParams* params,
                  const int* entry, const float* edges, const int* eslot,
                  const int* ecount, const int* gzones,
                  const unsigned char* gwide, int* zone,
                  unsigned char* uncertain, void* stream) {
  Consts k;
  for (int i = 0; i < 13; ++i) k.v[i] = consts_host[i];
  int blocks = (n + kThreads - 1) / kThreads;
  dense_join_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(xy), n, table, k, *params, entry,
      reinterpret_cast<const float4*>(edges), eslot, ecount, gzones, gwide,
      zone, uncertain);
  return (int)cudaGetLastError();
}

const char* h3_dense_join_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

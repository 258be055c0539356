// Dense H3 point-in-polygon join for Hopper (sm_90a): origin-local
// lon/lat degrees -> (zone, uncertain).  A thread projects each point;
// the block queues its border points in shared memory, their chip edges
// laid end to end, and its warps then walk those edges with their lanes
// across them, 32 edges a step.
//
// Replaces, in one kernel, the Pallas TPU kernel
// mosaic_tpu/ops/pallas_projection.py project_lattice_pallas and the XLA
// join body that consumes its outputs, the inner fn of
// mosaic_tpu/parallel/pip_join.py make_dense_pip_join_fn (:1689-1748).
// The TPU design left the window and pool gathers to XLA because the
// TPU's gather issue rate, not fusion, was its limit.  On Hopper the
// block gathers its own window entries and chip-pool rows from L2 (the
// flagship's entry table is 198 KB and its edge copy 3.8 MB, against 50
// MB of L2), so the projection's outputs never leave registers and the
// join's [N, E, 5] intermediates never reach device memory.  The plain
// PyTorch version is ops/dense_join.py dense_join_ref; this kernel gives
// its bits.
//
// Phase A, a thread kPoints points in turn:
//   * far test against the window's local extent: far points are zone
//     -1, certain;
//   * the projection of h3_df.cuh, its outputs kept in registers;
//   * the window test against (face0, a0, b0, W, H) and the entry read;
//     an empty or out-of-window cell is zone -1 and a core cell's zone is
//     the entry itself, and these points write both outputs at once;
//   * a border point (its entry a group e) reads its group's edge count
//     and wide flag; with no edge it is zone -1 at once, else it joins
//     the block's queue in shared memory.  A warp takes its queue slots
//     and its points' flat edges with one shared 64-bit atomicAdd
//     (points << 32 | edges; the lanes' offsets by a scan), so point s
//     owns the flat edges [off[s], off[s] + count) and off rises with s.
//     The queue holds the block's points, so it cannot overflow.
// Phase B, after __syncthreads(): warp w walks its share of the flat
// edges, a run of whole 32-edge steps, lane l the step's edge l: one
// coalesced read of the kernel's copy of the pool (ops/dense_join.py
// join_tables: each edge one float4, zone slots apart, trailing pad
// edges cut) covering a few points' rows.  A lane's point is the step's
// first owner plus the points that start in (f0, f0 + l], read as bits
// of one __reduce_or_sync over the next 32 points' offsets (each point
// owns at least one edge, so no two start together).  kUnroll steps'
// loads leave before their edges are tested.  Each edge takes the ops of
// the plain version: the near-vertex test; for an edge that straddles
// the point's latitude the crossing abscissa xi (the only place it
// matters, so non-straddling edges divide nothing), the near-crossing
// test and the crossing parity, bit zs - 32 w of the pass's word.  Near
// the crossing means |px - xi| < eps (the JAX body's band) or a distance
// below eps from the edge's line, tested as cr^2 < eps^2 * (dx^2 + dy^2)
// with cr = dx * (py - ay) - dy * (px - ax).  The first band alone
// misses points beside a nearly horizontal edge: there the f32 rounding
// of py and ay moves xi by |dx / dy| times as much (~1e-5 degrees for a
// rise of 3e-6 over 2e-3), and the point is certain and wrong.  The
// second band has no such factor, so the port flags every point the JAX
// body flags and those too.  Crossings are XORed into the point's word
// and flags ORed into its flag with shared atomics; XOR and OR do not
// depend on order, so the bits are the plain version's for any E.  After
// a barrier a thread a queued point takes the pass's first odd slot,
// reads its zone in gzones and writes both outputs; passes of 32 slots
// go on while a point has none and slots remain, so Z has no cap.
//   * uncertain = margin < err | facegap < gap | an edge flag | a wide
//     group, cleared for far points.
//
// Bits: the projection as h3_df.cuh says; xi is ax + t * (bx - ax) with
// t = (py - ay) / (by - ay), and cr as above, each op rounded on its own
// as torch's separate ops round them.
//
// What bounds it: issue, then latency.  The function needs 821 flops a
// point (an FMA counted as two), plus about 4 a pool edge and 16 a
// straddling edge of a border point: the table's flops bound, 0.0033 ms
// a 2^18-row chunk of the flagship at 67 TFLOP/s.  Under -fmad=false
// those flops issue as about 785 f32 instructions a point (chip_smoke.py
// flops_per_point's `issued`), one a lane a clock, so the projection's
// issue alone takes 0.0061 ms a chunk, twice the flops bound: no design
// of this function reaches more than about half of it.  Phase A is that
// projection, whose dependent chains and table reads hold the SM well
// below its issue peak (K1, the projection alone, takes 0.0107 ms a
// chunk, 1.75 times the issue floor).  The chunk's blocks fit the card
// at once, so they reach the barrier together, and phase B's steps (an
// owner search, a gather from L2, the edge's ops, a shared atomic) then
// have no projection left to hide their latency behind: kUnroll steps a
// warp in flight is what overlaps them.  Bytes: 8 in and 5 out a point,
// and the entry and pool rows the points reach, each read once from
// device memory and then from L2.

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
constexpr int kWarps = kThreads / 32;
// points a thread projects in phase A; the block queues their border
// points together
constexpr int kPoints = 2;
constexpr int kQueue = kThreads * kPoints;
// 32-edge steps whose loads a warp issues before it tests their edges
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCoreFlag = 1 << 30;

// One pool edge (ax, ay, bx, by; zone slot zs) against the point (px,
// py) in the slot pass w: the plain version's ops in its order.  Sets
// `flag` when a vertex or the crossing lies within eps (pass 0 only) and
// flips bit zs - 32 w of `odd` when the edge crosses the point's
// latitude left of it.
__device__ __forceinline__ void edge_step(const float4 ed, int zs, float px,
                                          float py, int w,
                                          const JoinParams& q, bool& flag,
                                          unsigned& odd) {
  const float ax = ed.x, ay = ed.y, bx = ed.z, by = ed.w;
  if (w == 0 && fabsf(sub(py, ay)) < q.eps32 &&
      px < add(fmax_(ax, bx), q.eps32))
    flag = true;
  if ((ay <= py) == (by <= py)) return;              // no straddle
  const float dx = sub(bx, ax), dy = sub(by, ay);
  const float t = __fdiv_rn(sub(py, ay), dy);
  const float xi = add(ax, mul(t, dx));
  if (w == 0) {
    // near the crossing: within eps of it along x, or within eps of the
    // edge's line (cross^2 < eps^2 * length^2, no divide by dy)
    const float cr = sub(mul(dx, sub(py, ay)), mul(dy, sub(px, ax)));
    if (fabsf(sub(px, xi)) < q.eps32 ||
        mul(cr, cr) < mul(mul(q.eps32, q.eps32),
                          add(mul(dx, dx), mul(dy, dy))))
      flag = true;
  }
  const unsigned b = (unsigned)(zs - 32 * w);
  if (px < xi && zs < q.Z && b < 32u) odd ^= 1u << b;
}

// Read-only loads issued where they stand: volatile, so the compiler
// neither sinks the zone slot's load into the branch that uses it nor
// holds a step's loads back behind the tests of the step before.
__device__ __forceinline__ float4 load_nc(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ int load_nc(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The block's queue of border points, filled in phase A.
struct Queue {
  unsigned long long tally;   // points queued << 32 | their flat edges
  int point[kQueue];
  float2 p[kQueue];
  int group[kQueue];
  int off[kQueue];            // the point's first flat edge
  unsigned word[kQueue];      // crossing parity of the pass's 32 slots
  int unc[kQueue];            // 1: margin, face gap or wide; 2: an edge;
                              // 4: written
};

__global__ void __launch_bounds__(kThreads, 2048 / kQueue)
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
  __shared__ Queue qu;
  if (threadIdx.x == 0) qu.tally = 0ull;
  load_table(tbl, table);              // ends in __syncthreads()
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // ---- phase A: a thread a point, kPoints in turn
#pragma unroll 1
  for (int rep = 0; rep < kPoints; ++rep) {
    const int i = (blockIdx.x * kPoints + rep) * kThreads + threadIdx.x;
    bool border = false;
    float2 p = make_float2(0.0f, 0.0f);
    int e = -1, cnt = 0;
    bool unc = false;
    if (i < n) {
      p = xy[i];
      int zone = -1;
      if (!(fabsf(p.x) > q.far_lim || fabsf(p.y) > q.far_lim)) {
        const Projection r = project_point(p, tbl, k);
        unc = r.margin < q.err32 || r.gap < q.gap32;
        const int ia = r.a - q.a0, ib = r.b - q.b0;
        const bool inw = r.face == q.face0 && ia >= 0 && ia < q.W &&
                         ib >= 0 && ib < q.H;
        e = inw ? __ldg(entry + ia * q.H + ib) : -1;
        if (e >= 0 && (e & kCoreFlag)) zone = e & ~kCoreFlag;
        if (e >= 0 && !(e & kCoreFlag)) {
          unc = unc || __ldg(gwide + e) != 0;
          cnt = __ldg(ecount + e);
          border = cnt > 0;          // a group with no edge: no slot odd
        }
      }
      if (!border) {
        zone_out[i] = zone;
        unc_out[i] = unc ? 1 : 0;
      }
    }
    const unsigned ballot = __ballot_sync(kFull, border);
    if (!ballot) continue;
    // the warp's queue slots and flat edges: one shared atomicAdd, the
    // lanes' offsets by a scan
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned total = (unsigned)__shfl_sync(kFull, incl, 31);
    unsigned long long base = 0ull;
    if (lane == 0)
      base = atomicAdd(&qu.tally,
                       (unsigned long long)__popc(ballot) << 32 | total);
    base = __shfl_sync(kFull, base, 0);
    if (border) {
      const int s = (int)(base >> 32) + __popc(ballot & ((1u << lane) - 1u));
      qu.point[s] = i;
      qu.p[s] = p;
      qu.group[s] = e;
      qu.off[s] = (int)(unsigned)base + incl - cnt;
      qu.word[s] = 0u;
      qu.unc[s] = unc ? 1 : 0;
    }
  }
  __syncthreads();

  // ---- phase B: the warps walk the queue's flat edges, each warp a run
  // of whole 32-edge steps, lane l the step's edge l
  const int nq = (int)(qu.tally >> 32);
  const int nf = (int)(unsigned)qu.tally;
  const int per = ((nf + kWarps - 1) / kWarps + 31) & ~31;
  const int f_begin = warp * per;
  const int f_end = min(nf, f_begin + per);
  int owner0 = 0;                      // the point owning f_begin
  {
    int lo = 0, hi = nq;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (qu.off[mid] <= f_begin) lo = mid + 1; else hi = mid;
    }
    owner0 = lo - 1;
  }
  for (int w = 0;; ++w) {              // passes of 32 zone slots
    int sb = owner0;                   // the owner of the step's edge 0
    for (int f0 = f_begin; f0 < f_end; f0 += 32 * kUnroll) {
      int su[kUnroll];
      bool act[kUnroll];
      float4 ed[kUnroll];
      int zs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // lane l's owner: sb plus the points that start in (fu, fu + l]
        const int fu = f0 + 32 * u;
        const int nxt = sb + 1 + lane;
        unsigned bit = 0u;
        if (nxt < nq) {
          const int d = qu.off[nxt] - fu;
          if (d >= 1 && d <= 32) bit = 1u << (d - 1);
        }
        const unsigned starts = __reduce_or_sync(kFull, bit);
        const int s = sb + __popc(starts & ((1u << lane) - 1u));
        sb += __popc(starts);
        su[u] = s;
        act[u] = fu + lane < f_end && !(qu.unc[s] & 4);
        ed[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        zs[u] = 0;
        if (act[u]) {
          const size_t at =
              (size_t)qu.group[s] * q.E + (fu + lane - qu.off[s]);
          ed[u] = load_nc(edges + at);
          zs[u] = load_nc(eslot + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!act[u]) continue;
        const float2 pt = qu.p[su[u]];
        bool flag = false;
        unsigned odd = 0u;
        edge_step(ed[u], zs[u], pt.x, pt.y, w, q, flag, odd);
        if (odd) atomicXor(&qu.word[su[u]], odd);
        if (flag) atomicOr(&qu.unc[su[u]], 2);
      }
    }
    __syncthreads();
    // a thread a queued point: the pass's first odd slot picks the zone,
    // and a point is written (and marked 4) once it has one or no slot
    // is left
    const bool last = 32 * (w + 1) >= q.Z;
    int open = 0;
    for (int s = threadIdx.x; s < nq; s += kThreads) {
      const int u = qu.unc[s];
      if (u & 4) continue;
      const unsigned word = qu.word[s];
      qu.word[s] = 0u;
      if (word || last) {
        const int i_out = qu.point[s];
        zone_out[i_out] =
            word ? __ldg(gzones + (size_t)qu.group[s] * q.Z + 32 * w +
                         __ffs(word) - 1)
                 : -1;
        unc_out[i_out] = (u & 3) != 0 ? 1 : 0;
        qu.unc[s] = u | 4;
      } else {
        open = 1;
      }
    }
    if (!__syncthreads_or(open)) break;
  }
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
  const int blocks = (n + kQueue - 1) / kQueue;
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

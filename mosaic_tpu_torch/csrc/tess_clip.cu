// Tessellation's border-chip clip for Hopper (sm_90a): Sutherland-Hodgman
// of a polygon ring against every half-plane of a convex CCW cell, for
// every (ring, cell) task, in exact float64.
//
// Replaces the XLA body of the JAX package's clip pass,
// mosaic_tpu/core/tessellate.py _clip_bucket_jitted (:488-577,
// `tess/clip`), whose numpy branch is _sh_halfplane under
// convex_clip_tasks.  Per plane (p0 the cell's vertex k, p1 the next,
// ev = p1 - p0), per subject vertex c and its successor n:
//   d_cur = ev.x*(c.y-p0.y) - ev.y*(c.x-p0.x), d_nxt likewise for n;
//   emit c when d_cur >= 0, and the crossing when (d_cur >= 0) !=
//   (d_nxt >= 0): t = denom != 0 ? d_cur/denom : 0 (denom = d_cur -
//   d_nxt), inter = c + t*(n - c).
// Emitted vertices keep the subject's order.  It has no Pallas form.  The
// plain PyTorch version is ops/tess_clip.py clip_tasks_ref.
//
// Bit equality: every subtract, multiply and divide is one IEEE rounding
// in numpy's order (explicit __d*_rn; the build also has -fmad=false),
// and each task's result depends on its own ring and cell only, so the
// kernel's vertices equal the plain version's and numpy's bit for bit,
// however the host batched or padded the tasks and however many lanes
// take a task.  d_nxt of vertex i is d_cur of vertex i + 1: the same
// expression on the same inputs gives the same bits, so a thread that
// walks the ring carries it over, and lanes recompute it.
//
// Layout: flat CSR.  Ring r is rows ring_off[r] .. ring_off[r+1] of
// ring_xy [V, 2] (open: no repeated closing vertex); a task names its
// ring and its cell in a table of [U, K] vertices and counts.  The
// kernel runs over jobs, each a task and a capacity C: job j writes at
// most C + 1 vertices from out_off[j], the clipped ring closed by its
// first vertex, and its open vertex count, or -1 when a plane's result
// exceeded C.  A convex ring of V vertices gains at most one vertex a
// plane, so C = V + K + 1 always holds it; a concave ring can emit one
// crossing per edge and overflow, and the wrapper relaunches this kernel
// on the overflowed tasks at twice their capacity until none overflows.
//
// What bounds it on an H100: its bytes, ahead of its f64 instructions:
// per (task, plane, subject vertex) one 5-flop side and its compare, per
// crossing a subtract, a test, the divide and two multiply-adds
// (chip_smoke.py counts them from the run's data).
//
// Design: a group of W lanes a job, W in {1, 4, 32} chosen by the
// wrapper per launch from the capacities.  The job's cell vertices are
// loaded once into shared memory, the ring copied into the second of the
// job's two ping-pong buffers, and the planes alternate between them.
// The buffers hold Cs vertices each in dynamic shared memory (Cs the
// launch's largest capacity, or what a 100 KB budget allows); a job of
// larger capacity uses its own two buffers in global scratch, which the
// wrapper allocates.  __launch_bounds__ holds
// a thread to 64 registers, so shared memory alone sets the jobs in
// flight.
//   * W = 1, a thread a job (64 a block): the thread walks each plane's
//     ring once, carrying d_nxt into the next vertex's d_cur; slot s's
//     vertex i sits at (i * 64 + s), so a warp's lanes read neighbouring
//     words;
//   * W = 4 or 32, lanes over the subject's vertices (256 threads a
//     block, 256 / W jobs): each plane's emit positions come from a
//     prefix sum of the lanes' emit counts (0-2) over the group, a
//     segmented shuffle scan (width W).
// The wrapper launches the tasks whose buffers fit in shared memory at 4
// lanes a job apart from the longer rings, which take a warp a job (on
// 4 lanes a long ring is a long chain of rounds).  The first launch
// takes a thread a job where every capacity is small (the footprints'
// boxes), else 4 lanes (the counties' and zones' rings); 8 and 16 lanes
// lost to 4 on every measured set.  A job's buffers
// in shared memory bound the jobs in flight on an SM (about 260 at the
// counties' capacity of 24), and each job is a chain of dependent
// steps: its loads, then plane after plane, each with its divides.
// Why: the first design, a warp a job, took 0.0965 ms on the county run
// (4.6% of its bound, NVIDIA H100 80GB HBM3): 15 of its 32 lanes idle on
// the counties' 17-vertex rings and 28 on the footprints' 4-vertex ones,
// a chain of dependent global loads before each job, the cell's
// vertices read again every plane, and a 5-step scan and a warp barrier
// on every plane.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int W>
struct Shape {
  static constexpr int threads = W == 1 ? 64 : 256;
  static constexpr int slots = threads / W;      // jobs a block
  // blocks an SM at 64 registers a thread, as __launch_bounds__ asks
  static constexpr int min_blocks = 65536 / 64 / threads;
};

// ev.x*(c.y-p0.y) - ev.y*(c.x-p0.x)
__device__ __forceinline__ double side(double evx, double evy, double2 p0,
                                       double2 c) {
  return __dsub_rn(__dmul_rn(evx, __dsub_rn(c.y, p0.y)),
                   __dmul_rn(evy, __dsub_rn(c.x, p0.x)));
}

// the crossing of c -> n with the plane, given their sides dc and dn
__device__ __forceinline__ double2 crossing(double2 c, double2 n, double dc,
                                            double dn) {
  const double denom = __dsub_rn(dc, dn);
  const double t = denom != 0.0 ? __ddiv_rn(dc, denom) : 0.0;
  return make_double2(__dadd_rn(c.x, __dmul_rn(t, __dsub_rn(n.x, c.x))),
                      __dadd_rn(c.y, __dmul_rn(t, __dsub_rn(n.y, c.y))));
}

template <int W>
__global__ void __launch_bounds__(Shape<W>::threads, Shape<W>::min_blocks)
clip_kernel(const double2* __restrict__ ring_xy,
            const long long* __restrict__ ring_off,
            const long long* __restrict__ jobs, long long J,
            const long long* __restrict__ task_ring,
            const long long* __restrict__ task_cell,
            const double2* __restrict__ cverts,
            const int* __restrict__ ccounts, int K,
            const int* __restrict__ cap,
            const long long* __restrict__ out_off,
            const long long* __restrict__ scratch_off,
            double2* __restrict__ scratch, double2* __restrict__ out_xy,
            int* __restrict__ out_count, int Cs) {
  extern __shared__ double2 smem[];
  constexpr int kSlots = Shape<W>::slots;
  const int slot = threadIdx.x / W, lane = threadIdx.x % W;
  const long long j = (long long)blockIdx.x * kSlots + slot;
  if (j >= J) return;                      // uniform across the group
  // the group's lanes, for its shuffles and barriers
  const unsigned gmask =
      W == 32 ? kFull
              : ((1u << (W & 31)) - 1u) << ((threadIdx.x & 31) & ~(W - 1));
  const long long t = jobs[j];
  const long long r = task_ring[t], c = task_cell[t];
  const int C = cap[j];
  const long long r0 = ring_off[r];
  int n = (int)(ring_off[r + 1] - r0);
  const int cc = ccounts[c];
  // the cell's vertices, loaded once: vertex k at cv[k * kSlots]
  double2* const cv = smem + 2 * Cs * kSlots + slot;
  for (int k = lane; k < cc; k += W) cv[k * kSlots] = cverts[c * K + k];

  // the two buffers, element i at buf[b][i * st]
  double2* buf[2];
  int st = 1;
  if (C <= Cs) {
    if (W == 1) {
      buf[0] = smem + slot;
      buf[1] = smem + Cs * kSlots + slot;
      st = kSlots;
    } else {
      buf[0] = smem + 2 * Cs * slot;
      buf[1] = buf[0] + Cs;
    }
  } else {
    buf[0] = scratch + scratch_off[j];
    buf[1] = buf[0] + C;
  }
  bool overflow = n > C;
  if (!overflow) {
    const double2* ring = ring_xy + r0;
#pragma unroll 4
    for (int i = lane; i < n; i += W) buf[1][i * st] = ring[i];
  }
  if (W > 1) __syncwarp(gmask);
  const double2* src = buf[1];

  for (int k = 0; k < cc && !overflow; ++k) {
    const double2 p0 = cv[k * kSlots];
    const double2 p1 = cv[(k + 1 >= cc ? 0 : k + 1) * kSlots];
    const double evx = __dsub_rn(p1.x, p0.x);
    const double evy = __dsub_rn(p1.y, p0.y);
    double2* dst = buf[k & 1];
    int m = 0;                             // vertices emitted
    if (W == 1) {
      if (n > 0) {
        const double2 first = src[0];
        const double d0 = side(evx, evy, p0, first);
        double2 cur = first;
        double dc = d0;
        for (int i = 0; i < n; ++i) {
          const bool last = i + 1 >= n;
          double2 nxt = first;
          double dn = d0;
          if (!last) {
            nxt = src[(i + 1) * st];
            dn = side(evx, evy, p0, nxt);
          }
          const bool in_c = dc >= 0.0;
          if (in_c) {
            if (m < C) dst[m * st] = cur;
            ++m;
          }
          if (in_c != (dn >= 0.0)) {
            if (m < C) dst[m * st] = crossing(cur, nxt, dc, dn);
            ++m;
          }
          cur = nxt;
          dc = dn;
        }
      }
    } else {
      for (int i0 = 0; i0 < n; i0 += W) {
        const int i = i0 + lane;
        double2 cur = make_double2(0.0, 0.0), nxt = cur;
        double dc = 0.0, dn = 0.0;
        int emit_v = 0, emit_i = 0;
        if (i < n) {
          cur = src[i];
          nxt = src[i + 1 >= n ? 0 : i + 1];
          dc = side(evx, evy, p0, cur);
          dn = side(evx, evy, p0, nxt);
          emit_v = dc >= 0.0;
          emit_i = (dc >= 0.0) != (dn >= 0.0);
        }
        const int cnt = emit_v + emit_i;
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < W; o <<= 1) {
          const int y = __shfl_up_sync(gmask, incl, o, W);
          if (lane >= o) incl += y;
        }
        const int pos = m + incl - cnt;
        if (emit_v && pos < C) dst[pos] = cur;
        if (emit_i && pos + emit_v < C)
          dst[pos + emit_v] = crossing(cur, nxt, dc, dn);
        m += __shfl_sync(gmask, incl, W - 1, W);
      }
      __syncwarp(gmask);
    }
    n = m;
    overflow = n > C;
    src = dst;
  }
  if (overflow) {
    if (lane == 0) out_count[j] = -1;
    return;
  }
  double2* out = out_xy + out_off[j];
  for (int i = lane; i < n; i += W) out[i] = src[i * st];
  if (lane == 0) {
    out_count[j] = n;
    if (n >= 1) out[n] = src[0];
  }
}

template <int W>
int launch(const double* ring_xy, const long long* ring_off,
           const long long* jobs, long long J, const long long* task_ring,
           const long long* task_cell, const double* cverts,
           const int* ccounts, int K, const int* cap,
           const long long* out_off, const long long* scratch_off,
           double* scratch, double* out_xy, int* out_count, int Cs,
           cudaStream_t stream) {
  constexpr int kSlots = Shape<W>::slots;
  const size_t bytes = (size_t)kSlots * (2 * Cs + K) * sizeof(double2);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clip_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (J + kSlots - 1) / kSlots;
  clip_kernel<W><<<(unsigned)blocks, Shape<W>::threads, bytes, stream>>>(
      reinterpret_cast<const double2*>(ring_xy), ring_off, jobs, J,
      task_ring, task_cell, reinterpret_cast<const double2*>(cverts),
      ccounts, K, cap, out_off, scratch_off,
      reinterpret_cast<double2*>(scratch),
      reinterpret_cast<double2*>(out_xy), out_count, Cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ring_xy [V, 2] f64 and cverts [U, K, 2] f64 (16-byte aligned),
// ring_off [R + 1] i64, task_ring and task_cell [T] i64, ccounts [U]
// i32 (each <= K <= 10); per job j < J: jobs [J] i64 (a task), cap [J]
// i32 (>= 1), out_off [J] i64 (C + 1 rows each in out_xy), scratch_off
// [J] i64 (2 C rows in scratch, read only where C > Cs); out_count [J]
// i32.  W lanes a job (1, 4 or 32); Cs vertices a buffer in
// shared memory (Shape<W>::slots * (2 Cs + K) * 16 bytes, at most
// 227 KB).
// All on the device; the wrapper checks them.  Launches on `stream` and
// returns the launch's CUDA error.
int tess_clip_launch(const double* ring_xy, const long long* ring_off,
                     const long long* jobs, long long J,
                     const long long* task_ring, const long long* task_cell,
                     const double* cverts, const int* ccounts, int K,
                     const int* cap, const long long* out_off,
                     const long long* scratch_off, double* scratch,
                     double* out_xy, int* out_count, int W, int Cs,
                     void* stream) {
  if (J <= 0) return 0;
  if (K < 0 || K > 10 || Cs < 0) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
#define TESS_CLIP_W(w)                                                     \
  case w:                                                                  \
    return launch<w>(ring_xy, ring_off, jobs, J, task_ring, task_cell,     \
                     cverts, ccounts, K, cap, out_off, scratch_off,        \
                     scratch, out_xy, out_count, Cs, s);
  switch (W) {
    TESS_CLIP_W(1)
    TESS_CLIP_W(4)
    TESS_CLIP_W(32)
  }
#undef TESS_CLIP_W
  return (int)cudaErrorInvalidValue;
}

const char* tess_clip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

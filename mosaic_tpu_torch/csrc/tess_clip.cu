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
// however the host batched or padded the tasks.  d_nxt of vertex i is
// recomputed, not shuffled in: the same expression gives the same bits.
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
// per (task, plane, subject vertex) one 5-flop side and its compare (the
// kernel computes d_nxt again, as above, but the function needs each
// side once), per crossing a subtract, a test, the divide and two
// multiply-adds (chip_smoke.py counts them from the run's data).  Design: one
// warp per job, lanes over the subject's vertices, 32 at a time; each
// plane's emit positions come from a warp prefix sum of the lanes' emit
// counts (0-2), and the planes ping-pong between two buffers in shared
// memory (kSmemVerts vertices each a warp; a job of larger capacity uses
// its own two buffers in global scratch, which the wrapper allocates).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kSmemVerts = 64;
constexpr unsigned kFull = 0xffffffffu;

// ev.x*(c.y-p0.y) - ev.y*(c.x-p0.x)
__device__ __forceinline__ double side(double evx, double evy, double2 p0,
                                       double2 c) {
  return __dsub_rn(__dmul_rn(evx, __dsub_rn(c.y, p0.y)),
                   __dmul_rn(evy, __dsub_rn(c.x, p0.x)));
}

__global__ void __launch_bounds__(kWarps * 32)
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
            int* __restrict__ out_count) {
  __shared__ double2 smem[kWarps][2][kSmemVerts];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * kWarps + w;
  if (j >= J) return;                      // uniform across the warp
  const long long t = jobs[j];
  const long long r = task_ring[t], c = task_cell[t];
  const int C = cap[j];
  double2* const buf0 = C <= kSmemVerts ? smem[w][0]
                                         : scratch + scratch_off[j];
  double2* const buf1 = C <= kSmemVerts ? smem[w][1] : buf0 + C;
  const double2* src = ring_xy + ring_off[r];
  int n = (int)(ring_off[r + 1] - ring_off[r]);
  const int cc = ccounts[c];
  const double2* cv = cverts + c * K;
  bool overflow = n > C;
  for (int k = 0; k < cc && !overflow; ++k) {
    const double2 p0 = cv[k];
    const double2 p1 = cv[k + 1 >= cc ? 0 : k + 1];
    const double evx = __dsub_rn(p1.x, p0.x);
    const double evy = __dsub_rn(p1.y, p0.y);
    double2* dst = (k & 1) ? buf1 : buf0;
    int base = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
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
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int pos = base + incl - cnt;
      if (emit_v && pos < C) dst[pos] = cur;
      if (emit_i && pos + emit_v < C) {
        const double denom = __dsub_rn(dc, dn);
        const double tt = denom != 0.0 ? __ddiv_rn(dc, denom) : 0.0;
        dst[pos + emit_v] = make_double2(
            __dadd_rn(cur.x, __dmul_rn(tt, __dsub_rn(nxt.x, cur.x))),
            __dadd_rn(cur.y, __dmul_rn(tt, __dsub_rn(nxt.y, cur.y))));
      }
      base += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    n = base;
    overflow = n > C;
    src = dst;
  }
  if (overflow) {
    if (lane == 0) out_count[j] = -1;
    return;
  }
  double2* out = out_xy + out_off[j];
  for (int i = lane; i < n; i += 32) out[i] = src[i];
  if (lane == 0) {
    out_count[j] = n;
    if (n >= 1) out[n] = src[0];
  }
}

}  // namespace

extern "C" {

// ring_xy [V, 2] f64 and cverts [U, K, 2] f64 (16-byte aligned),
// ring_off [R + 1] i64, task_ring and task_cell [T] i64, ccounts [U]
// i32; per job j < J: jobs [J] i64 (a task), cap [J] i32 (>= the ring's
// length), out_off [J] i64 (C + 1 rows each in out_xy), scratch_off [J]
// i64 (2 C rows in scratch, read only where C > 64); out_count [J] i32.
// All on the device; the wrapper checks them.  Launches on `stream` and
// returns the launch's CUDA error.
int tess_clip_launch(const double* ring_xy, const long long* ring_off,
                     const long long* jobs, long long J,
                     const long long* task_ring, const long long* task_cell,
                     const double* cverts, const int* ccounts, int K,
                     const int* cap, const long long* out_off,
                     const long long* scratch_off, double* scratch,
                     double* out_xy, int* out_count, void* stream) {
  if (J <= 0) return 0;
  const long long blocks = (J + kWarps - 1) / kWarps;
  clip_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const double2*>(ring_xy), ring_off, jobs, J,
      task_ring, task_cell, reinterpret_cast<const double2*>(cverts),
      ccounts, K, cap, out_off, scratch_off,
      reinterpret_cast<double2*>(scratch),
      reinterpret_cast<double2*>(out_xy), out_count);
  return (int)cudaGetLastError();
}

int tess_clip_smem_verts() { return kSmemVerts; }

const char* tess_clip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

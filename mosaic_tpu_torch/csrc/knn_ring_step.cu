// SpatialKNN's ring step for Hopper (sm_90a): for every left row, scan
// the lattice cells of one hex ring of its face's window and fold their
// pool points into the row's running top-(k+1).
//
// Replaces the XLA body of the JAX package's ring march,
// mosaic_tpu/models/knn.py SpatialKNN._make_step's `step` (:285-316, a
// lax.scan over the ring's offsets).  It has no Pallas form.  The plain
// PyTorch version is ops/knn_ring.py ring_step_ref, the scan written out.
//
// Per row and per offset (da, db) of the ring whose mask is set:
//   ia = a + da - a0, ib = b + db - b0 (int32, the row's face window);
//   inside the W x H window, slot = entry[eoff + ia * H + ib], else -1;
//   for j < cap: p = pool[slot, j], dx = p.x - x, dy = p.y - y,
//   d2 = dx * dx + dy * dy; bad = slot < 0 | d2 > thr2;
//   a good candidate is (d2, slot * cap + j), a bad one (inf, -1).
// The reference keeps lax.top_k(-d2, k + 1) of [the running list, the
// offset's cap candidates]: the k + 1 smallest, ties to the lower
// position, so the running list before the new candidates and these in
// order j.  Here each candidate enters the sorted list by a strict `<`,
// after every equal entry, which gives the same list; a bad candidate,
// (inf, -1), never enters a list that holds only numbers, so it is
// skipped.  A 1e9-padded pool point is not bad: it keeps its finite
// d2 (~2e18) and its live code, as in the reference.  Every f32 step is
// one rounding in the reference's order (explicit _rn intrinsics, the
// build has -fmad=false), so the kernel equals the plain version bit
// for bit.
//
// What bounds it on an H100: bytes.  A row reads its point, its seven
// window scalars and its list, and writes the list; the ring's window
// entries and pool rows are gathered, mostly from L2 (config 4's windows
// at res 4 are a few MB).  The arithmetic, 5 flops per pool point, is
// small.  Design: one thread per row, the list in registers (KMAX the
// smallest of 8, 16, 32, 64 that holds k + 1; positions past k + 1 start
// at (inf, -1) and are not written back: a candidate that reaches them
// never moves up again, so the first k + 1 are the reference's list);
// the offsets are uniform across the block and read through the
// read-only cache.

#include <cuda_runtime.h>

#include <cmath>

namespace {

struct Row {
  const float2* pts;
  const int *al, *bl, *a0r, *b0r, *wr, *hr, *eoffr;
};

template <int KMAX>
__global__ void __launch_bounds__(256)
    ring_kernel(const int* __restrict__ entry,
                const float2* __restrict__ pool, Row rows, long long n,
                const float* __restrict__ top_d2_in,
                const int* __restrict__ top_code_in,
                float* __restrict__ top_d2_out,
                int* __restrict__ top_code_out,
                const int2* __restrict__ offs,
                const unsigned char* __restrict__ omask, int n_off,
                int cap, int k1, float thr2) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float L[KMAX];
  int C[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    L[t] = t < k1 ? top_d2_in[row * k1 + t] : INFINITY;
    C[t] = t < k1 ? top_code_in[row * k1 + t] : -1;
  }
  const float2 p = rows.pts[row];
  const int a = rows.al[row] - rows.a0r[row];
  const int b = rows.bl[row] - rows.b0r[row];
  const int w = rows.wr[row], h = rows.hr[row], eoff = rows.eoffr[row];

  for (int o = 0; o < n_off; ++o) {
    if (!__ldg(omask + o)) continue;
    const int2 off = __ldg(offs + o);
    const int ia = a + off.x;
    const int ib = b + off.y;
    if (ia < 0 || ia >= w || ib < 0 || ib >= h) continue;
    const int slot = __ldg(entry + eoff + ia * h + ib);
    if (slot < 0) continue;
    for (int j = 0; j < cap; ++j) {
      const float2 q = __ldg(pool + (long long)slot * cap + j);
      const float dx = __fsub_rn(q.x, p.x);
      const float dy = __fsub_rn(q.y, p.y);
      const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (d > thr2 || !(d < L[KMAX - 1])) continue;
      L[KMAX - 1] = d;
      C[KMAX - 1] = slot * cap + j;
#pragma unroll
      for (int t = KMAX - 1; t > 0; --t) {
        if (L[t] < L[t - 1]) {
          const float tl = L[t];
          L[t] = L[t - 1];
          L[t - 1] = tl;
          const int tc = C[t];
          C[t] = C[t - 1];
          C[t - 1] = tc;
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    if (t < k1) {
      top_d2_out[row * k1 + t] = L[t];
      top_code_out[row * k1 + t] = C[t];
    }
  }
}

template <int KMAX>
int launch(const int* entry, const float* pool, const Row& rows,
           long long n, const float* td_in, const int* tc_in, float* td_out,
           int* tc_out, const int* offs, const unsigned char* omask,
           int n_off, int cap, int k1, float thr2, cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  ring_kernel<KMAX><<<(unsigned)blocks, 256, 0, stream>>>(
      entry, reinterpret_cast<const float2*>(pool), rows, n, td_in, tc_in,
      td_out, tc_out, reinterpret_cast<const int2*>(offs), omask, n_off, cap,
      k1, thr2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// entry [E] i32; pool [C, cap, 2] f32; pts [n, 2] f32 (face-origin
// local); al, bl, a0r, b0r, wr, hr, eoffr [n] i32; top_d2_in/out [n, k1]
// f32 and top_code_in/out [n, k1] i32 (in and out distinct); offs
// [n_off, 2] i32 and omask [n_off] u8; all on the device, pts and pool
// 8-byte aligned.  1 <= k1 <= 64 (the wrapper checks).  Launches on
// `stream` and returns the launch's CUDA error.
int knn_ring_step_launch(const int* entry, const float* pool,
                         const float* pts, const int* al, const int* bl,
                         const int* a0r, const int* b0r, const int* wr,
                         const int* hr, const int* eoffr, long long n,
                         const float* top_d2_in, const int* top_code_in,
                         float* top_d2_out, int* top_code_out,
                         const int* offs, const unsigned char* omask,
                         int n_off, int cap, int k1, float thr2,
                         void* stream) {
  if (n <= 0) return 0;
  const Row rows{reinterpret_cast<const float2*>(pts), al, bl, a0r, b0r,
                 wr, hr, eoffr};
  cudaStream_t s = (cudaStream_t)stream;
  if (k1 <= 8)
    return launch<8>(entry, pool, rows, n, top_d2_in, top_code_in,
                     top_d2_out, top_code_out, offs, omask, n_off, cap, k1,
                     thr2, s);
  if (k1 <= 16)
    return launch<16>(entry, pool, rows, n, top_d2_in, top_code_in,
                      top_d2_out, top_code_out, offs, omask, n_off, cap, k1,
                      thr2, s);
  if (k1 <= 32)
    return launch<32>(entry, pool, rows, n, top_d2_in, top_code_in,
                      top_d2_out, top_code_out, offs, omask, n_off, cap, k1,
                      thr2, s);
  return launch<64>(entry, pool, rows, n, top_d2_in, top_code_in, top_d2_out,
                    top_code_out, offs, omask, n_off, cap, k1, thr2, s);
}

const char* knn_ring_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// SpatialKNN's all-pairs top-k for Hopper (sm_90a): for every left row
// of a block, the kc right points of smallest squared planar distance,
// ascending, ties to the lower right index.
//
// Replaces the XLA body of the JAX package's brute pass,
// mosaic_tpu/models/knn.py _brute_device_topk's `kern` (:485-489):
//   dx = lc[:, None, 0] - rc[None, :, 0]; dy likewise;
//   negd2, idx = lax.top_k(-(dx * dx + dy * dy), kc).
// It has no Pallas form.  The plain PyTorch version is ops/knn_brute.py
// brute_topk_ref: the same distance matrix, then a stable sort.
//
// The right side arrives once per transform as f64 [m, 2]; each block's
// centered f32 copy is formed here, rc = __double2float_rn(r - c) from
// the f64 center c, which is IEEE subtraction and round-to-nearest: the
// same bits as numpy's (right_xy - center).astype(float32), so the host's
// f32 error bound, which reads numpy's copy, holds for the kernel's.
// Every f32 step is one rounding in the reference's order (explicit _rn
// intrinsics; the build also has -fmad=false), so the kernel equals the
// plain version bit for bit.  The reference's XLA:CPU build contracts
// dx * dx + dy * dy into fma(dx, dx, dy * dy), one ulp away at most;
// the port does not (tests/test_torch_knn.py states the rule).
//
// Order: (d2, index) ascending, NaN after every number, as a stable sort
// puts it; padding is (NaN, INT_MAX), after every real candidate.
//
// What bounds it on an H100: at config 4's block (8,192 left rows x
// 3,000 right points, kc = 13) the arithmetic, 5 flops a pair, about
// 1.8 us at the f32 peak; its bytes (the left rows, the right side and
// the outputs, ~1.0 MB) take 0.3 us.  Design:
//   * one warp per left row, WARPS rows per block; the block stages the
//     centered right side through shared memory in tiles of kTile
//     points, each point converted once per block;
//   * each lane scans its stride of the tile (indices ascending) and
//     keeps a sorted register list of its KMAX best (KMAX the smallest
//     of 16, 32, 64 that holds kc); a candidate enters by an unrolled
//     bubble from the tail;
//   * the warp then merges: kc rounds of a shuffle argmin over the lanes'
//     list heads, the owning lane popping its head; lane 0 stores.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 2048;              // right points per shared tile

// (d, i) strictly before (e, j): numbers ascending, NaN last, ties and
// NaN pairs by index
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  const bool dn = isnan(d), en = isnan(e);
  if (dn || en) return !dn || (en && i < j);
  return d < e || (d == e && i < j);
}

template <int KMAX, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    brute_kernel(const float2* __restrict__ lc, long long B,
                 const double2* __restrict__ right, int m, double cx,
                 double cy, int kc, float* __restrict__ d2_out,
                 int* __restrict__ idx_out) {
  extern __shared__ float2 tile[];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = row < B;
  const float2 p = live ? lc[row] : make_float2(0.f, 0.f);

  float L[KMAX];
  int I[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    L[t] = __int_as_float(0x7fffffff);   // NaN padding
    I[t] = INT_MAX;
  }

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tn = min(kTile, m - t0);
    __syncthreads();                     // the previous tile is consumed
    for (int s = threadIdx.x; s < tn; s += WARPS * 32) {
      const double2 r = right[t0 + s];
      tile[s] = make_float2(__double2float_rn(__dsub_rn(r.x, cx)),
                            __double2float_rn(__dsub_rn(r.y, cy)));
    }
    __syncthreads();
    if (!live) continue;
    for (int s = lane; s < tn; s += 32) {
      const float2 r = tile[s];
      const float dx = __fsub_rn(p.x, r.x);
      const float dy = __fsub_rn(p.y, r.y);
      const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const int j = t0 + s;
      if (before(d, j, L[KMAX - 1], I[KMAX - 1])) {
        L[KMAX - 1] = d;
        I[KMAX - 1] = j;
#pragma unroll
        for (int t = KMAX - 1; t > 0; --t) {
          if (before(L[t], I[t], L[t - 1], I[t - 1])) {
            const float tl = L[t];
            L[t] = L[t - 1];
            L[t - 1] = tl;
            const int ti = I[t];
            I[t] = I[t - 1];
            I[t - 1] = ti;
          }
        }
      }
    }
  }
  if (!live) return;

  // kc <= m, so the lanes hold at least kc real candidates between them
  // and every winner below is real, its index unique
  for (int r = 0; r < kc; ++r) {
    float d = L[0];
    int i = I[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      if (before(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    if (lane == 0) {
      d2_out[row * kc + r] = d;
      idx_out[row * kc + r] = i;
    }
    if (I[0] == i) {                     // this lane's head won: pop it
#pragma unroll
      for (int t = 0; t < KMAX - 1; ++t) {
        L[t] = L[t + 1];
        I[t] = I[t + 1];
      }
      L[KMAX - 1] = __int_as_float(0x7fffffff);
      I[KMAX - 1] = INT_MAX;
    }
  }
}

template <int KMAX, int WARPS>
int launch(const float* lc, long long B, const double* right, int m,
           double cx, double cy, int kc, float* d2, int* idx,
           cudaStream_t stream) {
  const long long blocks = (B + WARPS - 1) / WARPS;
  const size_t smem = (size_t)min(m, kTile) * sizeof(float2);
  brute_kernel<KMAX, WARPS><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      reinterpret_cast<const float2*>(lc), B,
      reinterpret_cast<const double2*>(right), m, cx, cy, kc, d2, idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lc [B, 2] f32 (the block's left rows minus its center), right [m, 2]
// f64 (the whole right side, uncentered), center (cx, cy) f64; writes
// d2 [B, kc] f32 and idx [B, kc] i32, all on the device, 8- and 16-byte
// aligned.  1 <= kc <= min(m, 64) (the wrapper checks).  Launches on
// `stream` and returns the launch's CUDA error.
int knn_brute_topk_launch(const float* lc, long long B, const double* right,
                          int m, double cx, double cy, int kc, float* d2,
                          int* idx, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (kc <= 16) return launch<16, 16>(lc, B, right, m, cx, cy, kc, d2, idx, s);
  if (kc <= 32) return launch<32, 8>(lc, B, right, m, cx, cy, kc, d2, idx, s);
  return launch<64, 4>(lc, B, right, m, cx, cy, kc, d2, idx, s);
}

const char* knn_brute_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

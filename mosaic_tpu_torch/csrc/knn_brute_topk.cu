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
// Order: one 64-bit key per candidate, (d2 bits << 32) | index.  Every
// d2 is +0, positive, +inf or NaN, so its f32 bits ascend with it as an
// unsigned integer once every NaN is made 0x7fffffff (above +inf's
// 0x7f800000); the key then orders (d2, index) ascending with NaN last,
// as a stable sort does, in one unsigned compare, and no two candidates
// of a row share a key.  A NaN distance comes out as 0x7fffffff.
//
// What bounds it on an H100: at config 4's block (8,192 left rows x
// 3,000 right points, kc = 13) the arithmetic, 5 flops a pair, about
// 1.8 us at the f32 peak; its bytes (the left rows, the right side and
// the outputs, ~1.0 MB) take 0.3 us.  The issued instructions per pair
// set the pace, so the design spends as few as it can on the selection:
//   * one warp per left row, WARPS rows per block; the block stages the
//     centered right side through shared memory in tiles of kTile
//     points, each point converted once per block, and each lane reads
//     one 8-byte point a pair (consecutive lanes, no bank conflict);
//   * the row's kept keys form one sorted warp list of `width` keys,
//     key i in slot i / 32 of lane i % 32 (T slots a lane, width <=
//     32 T), and tau, the list's last key, is known to every lane;
//   * the first 32 points fill the list by one bitonic sort of their
//     keys across the warp (15 shuffle steps, not 32 insertions);
//   * after that each lane takes U points at a time (their shared-memory
//     loads in flight together) and a candidate is wanted only if its
//     distance is not above tau's in f32 (one compare a pair; the
//     64-bit key is formed only for the few that pass); one warp vote
//     skips the U points when none is, which after the first few
//     hundred points is nearly always: about kc ln(m / kc) insertions a
//     row (~70 at config 4);
//   * a ballot collects the wanted lanes; each wanted key, if still
//     below tau, enters by one warp step: every lane holds key i and,
//     by one shuffle up, key i - 1, so it keeps its key if that is below
//     c, takes c if key i - 1 is below c, else key i - 1; then tau is
//     read back from its lane.  The step's latency is two shuffles;
//   * the lanes store the list, 32 consecutive keys a slot.
// A list wider than 32 x 32 = 1,024 keys takes passes: pass p is one
// launch that keeps the next `width` keys strictly after the key that
// pass p - 1 stored last (read back from the outputs), so the passes
// concatenate to the stable sort's first kc (ops/knn_brute.py loops).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 2048;              // right points per shared tile
constexpr int U = 4;                     // points a lane takes at a time
constexpr unsigned long long kPad = ~0ull;

__device__ __forceinline__ unsigned long long make_key(float d, int j) {
  const unsigned bits = isnan(d) ? 0x7fffffffu : __float_as_uint(d);
  return ((unsigned long long)bits << 32) | (unsigned)j;
}

// T slots a lane: the warp list holds up to 32 T keys
template <int T, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    brute_kernel(const float2* __restrict__ lc, long long B,
                 const double2* __restrict__ right, int m, double cx,
                 double cy, int kc, int col0, int width,
                 float* __restrict__ d2_out, int* __restrict__ idx_out) {
  extern __shared__ float2 tile[];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = row < B;
  const float2 p = live ? lc[row] : make_float2(0.f, 0.f);
  float* const d2_row = d2_out + row * kc;
  int* const idx_row = idx_out + row * kc;
  // the least key this pass may keep: above the previous pass's last;
  // lo_d, its distance, filters in f32 (-inf on the first pass)
  unsigned long long lo = 0;
  float lo_d = -INFINITY;
  if (live && col0 > 0) {
    lo = make_key(d2_row[col0 - 1], idx_row[col0 - 1]) + 1;
    lo_d = d2_row[col0 - 1];
  }

  unsigned long long L[T];
#pragma unroll
  for (int t = 0; t < T; ++t) L[t] = kPad;
  const int tail_slot = (width - 1) >> 5, tail_lane = (width - 1) & 31;
  unsigned long long tau = kPad;
  float tau_d = __uint_as_float(0xffffffffu);   // NaN: no filter yet
  auto read_tau = [&]() {
    unsigned long long v = L[0];
#pragma unroll
    for (int t = 1; t < T; ++t)
      if (t == tail_slot) v = L[t];
    tau = __shfl_sync(kFull, v, tail_lane);
    tau_d = __uint_as_float((unsigned)(tau >> 32));
  };

  auto dist = [&](int s) {
    const float2 r = tile[s];
    const float dx = __fsub_rn(p.x, r.x);
    const float dy = __fsub_rn(p.y, r.y);
    return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  };
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tn = min(kTile, m - t0);
    __syncthreads();                     // the previous tile is consumed
    for (int s = threadIdx.x; s < tn; s += WARPS * 32) {
      const double2 r = right[t0 + s];
      tile[s] = make_float2(__double2float_rn(__dsub_rn(r.x, cx)),
                            __double2float_rn(__dsub_rn(r.y, cy)));
    }
    __syncthreads();
    if (!live) continue;                 // warp-uniform
    int s0 = 0;
    if (t0 == 0) {
      // the first 32 points: one bitonic sort of their keys across the
      // warp fills slot 0 (keys below lo, and missing points, as pads)
      unsigned long long x = lane < tn ? make_key(dist(lane), lane) : kPad;
      if (x < lo) x = kPad;
#pragma unroll
      for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
          const unsigned long long o = __shfl_xor_sync(kFull, x, j);
          const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
          x = keep_min ? (o < x ? o : x) : (o < x ? x : o);
        }
      }
      L[0] = x;
      read_tau();
      s0 = 32;
    }
    for (; s0 < tn; s0 += 32 * U) {
      // U points a lane, their loads in flight together; f32 pre-filter:
      // d not above tau's distance and not below lo's (a NaN on either
      // side passes); the exact key decides below
      float d[U];
      bool w[U];
      bool any = false;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + 32 * u + lane;
        d[u] = s < tn ? dist(s) : 0.f;
        w[u] = s < tn && !(d[u] < lo_d);
        any |= w[u] && !(d[u] > tau_d);
      }
      if (!__any_sync(kFull, any)) continue;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        unsigned want = __ballot_sync(kFull, w[u] && !(d[u] > tau_d));
        while (want) {
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const unsigned long long c = make_key(
              __shfl_sync(kFull, d[u], src), t0 + s0 + 32 * u + src);
          if (!(c < tau) || c < lo) continue;   // warp-uniform
          // key i stays if below c; the first key not below c gives way
          // to c; the rest move up one place (key i takes key i - 1:
          // slot t's lane 0 takes slot t - 1's lane 31; old values, so
          // slots go from the top down)
#pragma unroll
          for (int t = T - 1; t >= 0; --t) {
            unsigned long long up = __shfl_up_sync(kFull, L[t], 1);
            if (t > 0) {
              const unsigned long long carry =
                  __shfl_sync(kFull, L[t - 1], 31);
              if (lane == 0) up = carry;
            }
            if (!(L[t] < c)) L[t] = (t == 0 && lane == 0) || up < c ? c : up;
          }
          read_tau();
        }
      }
    }
  }
  if (!live) return;

  // this pass admits m - col0 >= width keys, so every stored key is real
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = t * 32 + lane;
    if (i < width) {
      d2_row[col0 + i] = __uint_as_float((unsigned)(L[t] >> 32));
      idx_row[col0 + i] = (int)(unsigned)(L[t] & 0xffffffffu);
    }
  }
}

template <int T, int WARPS>
int launch(const float* lc, long long B, const double* right, int m,
           double cx, double cy, int kc, int col0, int width, float* d2,
           int* idx, cudaStream_t stream) {
  const long long blocks = (B + WARPS - 1) / WARPS;
  const size_t smem = (size_t)min(m, kTile) * sizeof(float2);
  brute_kernel<T, WARPS><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      reinterpret_cast<const float2*>(lc), B,
      reinterpret_cast<const double2*>(right), m, cx, cy, kc, col0, width,
      d2, idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lc [B, 2] f32 (the block's left rows minus its center), right [m, 2]
// f64 (the whole right side, uncentered), center (cx, cy) f64; d2 [B, kc]
// f32 and idx [B, kc] i32, all on the device, 8- and 16-byte aligned.
// One pass: writes columns [col0, col0 + width) of d2 and idx, the
// width keys after column col0 - 1's (which it reads when col0 > 0).
// 1 <= width <= 1024 and col0 + width <= kc <= m (the wrapper checks).
// Launches on `stream` and returns the launch's CUDA error.
int knn_brute_topk_launch(const float* lc, long long B, const double* right,
                          int m, double cx, double cy, int kc, int col0,
                          int width, float* d2, int* idx, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (width <= 32)
    return launch<1, 16>(lc, B, right, m, cx, cy, kc, col0, width, d2, idx, s);
  if (width <= 64)
    return launch<2, 16>(lc, B, right, m, cx, cy, kc, col0, width, d2, idx, s);
  if (width <= 128)
    return launch<4, 16>(lc, B, right, m, cx, cy, kc, col0, width, d2, idx, s);
  if (width <= 256)
    return launch<8, 8>(lc, B, right, m, cx, cy, kc, col0, width, d2, idx, s);
  if (width <= 512)
    return launch<16, 8>(lc, B, right, m, cx, cy, kc, col0, width, d2, idx, s);
  return launch<32, 8>(lc, B, right, m, cx, cy, kc, col0, width, d2, idx, s);
}

const char* knn_brute_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// H3 cell assignment for Hopper (sm_90a): absolute lon/lat degrees ->
// (int64 cell id, margin in planar degrees), one thread per point.
//
// Replaces the JAX package's device cell step,
// mosaic_tpu/core/index/h3/jaxkernel.py latlng_to_cell_jax_margin (XLA
// code that the H3 grid's point_to_cell_jax_margin hook calls; it has no
// Pallas form).  The plain PyTorch version of the same function is
// ops/cell.py latlng_to_cell_margin_ref, which keeps this kernel's order
// of operations.  Per point:
//   * the hook's f32 round trip: degrees -> radians -> degrees ->
//     radians, each one multiply by a constant rounded to f32;
//   * f32 sinf/cosf (never __sinf: the build has no --use_fast_math),
//     lifted to df with a zero low part;
//   * the df gnomonic projection shared with the projection kernels
//     (h3_df.cuh project_xyz);
//   * aperture-7 aggregation of the axial lattice point from res down to
//     0 (floor division by 7, as the JAX package's _round_div7), the
//     base-cell lookup, and the digit rotation with the pentagon seam
//     and relabel, into a 64-bit id built with shifts (mode bits at 59);
//   * the hex margin scaled to radians (0 where the nearest face is
//     ambiguous), then to degrees.
//
// What bounds it on an H100: arithmetic issue, as for the projection
// kernel (h3_df.cuh): 439 f32 operations per point as chip_smoke.py
// counts them from the plain version (an exact product as 3, a sin or
// cos as 1), plus ~10 integer operations and 2-3 table reads per
// resolution level, against 20 bytes moved per point (8 in, 8 + 4
// out).  Design:
//   * one binary serves every resolution: res, the unused-digit fill and
//     the margin scale are arguments; the aperture variant of each level
//     (H3 pairs the rotated one with even resolutions) is a branch on the
//     level, uniform across the warp;
//   * the cell tables (base cell, rotation and pentagon extra per res-0
//     ijk of each face, the digit rotation table, pentagon flags and
//     seams, the axial-difference digits; 1,915 int32) are read with a
//     different index on every lane, so they sit in shared memory with
//     the basis table, loaded once per block from one device buffer that
//     is uploaded once per device; the face centers are in __constant__
//     (uniform index);
//   * the digits are packed into 64-bit words as they are made, so no
//     per-thread array spills to local memory;
//   * every table index is clamped into its table, as the plain version
//     clamps it.

#include <cuda_runtime.h>

#include <cstdint>

#include "h3_df.cuh"

namespace {

using namespace h3df;

constexpr int kThreads = 256;

// int32 table offsets in the concatenated buffer (torchkernel.py
// CELL_TABLES order and sizes)
constexpr int kBase = 0;
constexpr int kRot = kBase + 540;
constexpr int kExtra = kRot + 540;
constexpr int kRotDigit = kExtra + 540;
constexpr int kIsPent = kRotDigit + 42;
constexpr int kPentSeam = kIsPent + 122;
constexpr int kDigitOfDiff = kPentSeam + 122;
constexpr int kCellTable = kDigitOfDiff + 9;

constexpr float kRadPerDeg = (float)(3.14159265358979323846 / 180.0);
constexpr float kDegPerRad = (float)(180.0 / 3.14159265358979323846);

struct Scalars {
  int res;
  long long fill;       // unused digits res+1..15, each 7
  float margin_scale;   // lattice units -> radians at res, f32
  float gap_eps;        // FACEGAP_EPS, f32
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int round_div7(int p) {
  return floor_div(2 * p + 7, 14);
}

// tables[off + clamp(i, 0, size - 1)]
__device__ __forceinline__ int at(const int* t, int off, int size, int i) {
  return t[off + min(max(i, 0), size - 1)];
}

__device__ __forceinline__ int digit_shift(int r) { return 3 * (15 - r); }

__global__ void __launch_bounds__(kThreads)
cell_kernel(const float2* __restrict__ xy, int n,
            const float* __restrict__ table,
            const int* __restrict__ cell_table, Consts k, Scalars s,
            long long* __restrict__ cells_out,
            float* __restrict__ margin_out) {
  __shared__ float tbl[kTable];
  __shared__ int ct[kCellTable];
  for (int i = threadIdx.x; i < kCellTable; i += blockDim.x)
    ct[i] = cell_table[i];
  load_table(tbl, table);        // ends in __syncthreads()
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // the hook's f32 round trip, then f32 sin/cos as df with lo = 0
  float2 p = xy[i];
  float lng = mul(mul(mul(p.x, kRadPerDeg), kDegPerRad), kRadPerDeg);
  float lat = mul(mul(mul(p.y, kRadPerDeg), kDegPerRad), kRadPerDeg);
  DF sin_lat{sinf(lat), 0.0f}, cos_lat{cosf(lat), 0.0f};
  DF sin_lng{sinf(lng), 0.0f}, cos_lng{cosf(lng), 0.0f};
  Projection pr = project_xyz(df_mul(cos_lat, cos_lng),
                              df_mul(cos_lat, sin_lng), sin_lat, tbl, k);

  // aperture-7 aggregation res -> 0; digit r lands at its id position
  int ai = pr.a, bi = pr.b;
  unsigned long long raw = 0;
  for (int rv = s.res; rv >= 1; --rv) {
    int ua, ub, ca, cb;
    if (rv % 2 == 0) {           // rotated variant (tables.py _down_rot)
      ua = round_div7(2 * ai + bi);
      ub = round_div7(3 * bi - ai);
      ca = 3 * ua - ub;
      cb = ua + 2 * ub;
    } else {
      ua = round_div7(3 * ai - bi);
      ub = round_div7(ai + 2 * bi);
      ca = 2 * ua + ub;
      cb = -ua + 3 * ub;
    }
    int d = at(ct, kDigitOfDiff, 9, (ai - ca + 1) * 3 + (bi - cb + 1));
    raw |= (unsigned long long)d << digit_shift(rv);
    ai = ua;
    bi = ub;
  }

  // res-0 normalized ijk and base-cell entry
  int mn = min(min(ai, bi), 0);
  int entry = ((pr.face * 3 + (ai - mn)) * 3 + (bi - mn)) * 3 - mn;
  int base = at(ct, kBase, 540, entry);
  int r0 = at(ct, kRot, 540, entry);

  // rotate digits to canonical orientation; first non-zero digit
  unsigned long long rot = 0;
  int lead = 0;
  for (int rv = 1; rv <= s.res; ++rv) {
    int d = (int)((raw >> digit_shift(rv)) & 7);
    d = at(ct, kRotDigit, 42, r0 * 7 + d);
    if (lead == 0 && d != 0) lead = d;
    rot |= (unsigned long long)d << digit_shift(rv);
  }
  // pentagon seam re-expression, then the published pentagon labels
  bool is_pent = at(ct, kIsPent, 122, base) == 1;
  bool seam_hit = is_pent && lead == at(ct, kPentSeam, 122, base) &&
                  lead != 0;
  int extra = seam_hit ? at(ct, kExtra, 540, entry) : 0;
  int lead_f = at(ct, kRotDigit, 42, extra * 7 + lead);
  int relabel = (is_pent && (lead_f == 1 || lead_f == 5)) ? 1 : 0;
  long long h = (1LL << 59) | ((long long)s.res << 52) | s.fill |
                ((long long)base << 45);
  for (int rv = 1; rv <= s.res; ++rv) {
    int d = (int)((rot >> digit_shift(rv)) & 7);
    d = at(ct, kRotDigit, 42, extra * 7 + d);
    d = at(ct, kRotDigit, 42, relabel * 7 + d);
    h |= (long long)d << digit_shift(rv);
  }
  cells_out[i] = h;

  float m = mul(pr.margin, s.margin_scale);
  if (pr.gap < s.gap_eps) m = 0.0f;
  margin_out[i] = mul(m, kDegPerRad);
}

}  // namespace

extern "C" {

// Upload the [20, 3] f32 face centers to this device's constant memory.
// Once per device before the first launch.
int h3_cell_set_faces(const float* faces_host) {
  cudaMemcpyToSymbol(c_face, faces_host, sizeof(float) * kFaces * 3);
  return (int)cudaGetLastError();
}

// xy [n, 2] f32 on the device; table [2, 20, 9] f32 (basis at res) and
// cell_table [1915] i32 on the device; consts_host [13] f32 in host
// memory (only the 1/sin60 and sin60 entries are read); outputs [n] on
// the device.  Launches on `stream` and returns the launch's CUDA error.
int h3_latlng_to_cell(const float* xy, int n, const float* table,
                      const int* cell_table, const float* consts_host,
                      int res, long long fill, float margin_scale,
                      float gap_eps, long long* cells, float* margin,
                      void* stream) {
  Consts k;
  for (int i = 0; i < 13; ++i) k.v[i] = consts_host[i];
  Scalars s{res, fill, margin_scale, gap_eps};
  int blocks = (n + kThreads - 1) / kThreads;
  cell_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(xy), n, table, cell_table, k, s,
      cells, margin);
  return (int)cudaGetLastError();
}

const char* h3_cell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

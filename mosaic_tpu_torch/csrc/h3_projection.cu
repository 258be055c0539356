// H3 lattice projection for Hopper (sm_90a): origin-local lon/lat degrees
// -> (face, axial a, axial b, hex margin, face gap), one thread per point.
//
// Replaces the Pallas TPU kernel mosaic_tpu/ops/pallas_projection.py
// project_lattice_pallas (kernel body _make_kernel.kernel).  The plain
// PyTorch version of the same function is ops/projection.py
// project_lattice_ref; this kernel keeps its order of operations so the
// two agree bit for bit.
//
// Arithmetic: double-single (df) f32.  The Dekker error terms only survive
// when every multiply and add is rounded on its own, so every step below is
// an explicit __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn (never
// contracted to FMA), the build passes -fmad=false, and rounding is rintf
// (half to even, as jnp.round and torch.round).
//
// What bounds it on an H100: arithmetic.  The function needs 821 flops per
// point (an FMA counted as two; chip_smoke.py counts them from the plain
// version) against 28 bytes moved per point (8 in, 20 out): some 29 flops
// per byte, above the card's ~20 f32 flops per byte of HBM bandwidth.  This
// kernel issues 1361 f32 operations per point: each of its 36 exact
// products is a 17-operation Dekker split where one mul and one FMA would
// do.  Design:
//   * one thread per point; the [N, 2] input is read as float2 in place
//     and the five outputs are written as separate coalesced arrays;
//   * the res-specific [2, 20, 9] hi/lo gnomonic basis table sits in shared
//     memory, loaded once per block — the row index (the point's face)
//     differs between threads, and divergent __constant__ reads serialize;
//   * the 20 face-center vectors sit in __constant__: the face loop reads
//     them with a uniform index, which the constant cache broadcasts;
//   * the origin's df sin/cos and the other df constants arrive as kernel
//     arguments, computed on the host in f64, so one binary serves every
//     resolution and origin (the Pallas kernel bakes them in and
//     recompiles per (res, origin)).

#include <cuda_runtime.h>

namespace {

constexpr int kFaces = 20;
constexpr int kTable = 2 * kFaces * 9;   // hi then lo, [face][9]
constexpr int kThreads = 256;

__constant__ float c_face[kFaces * 3];

// df constants, f32: (hi, lo) of pi/180, sin/cos lat0, sin/cos lon0,
// 1/sin60, then sin60 rounded to f32.
struct Consts {
  float v[13];
};

struct DF {
  float hi, lo;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ DF two_sum(float a, float b) {
  float s = add(a, b);
  float bb = sub(s, a);
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

__device__ __forceinline__ DF fast_two_sum(float a, float b) {
  float s = add(a, b);
  return {s, sub(b, sub(s, a))};
}

__device__ __forceinline__ DF two_prod(float a, float b) {
  float p = mul(a, b);
  float ca = mul(4097.0f, a);
  float ahi = sub(ca, sub(ca, a));
  float alo = sub(a, ahi);
  float cb = mul(4097.0f, b);
  float bhi = sub(cb, sub(cb, b));
  float blo = sub(b, bhi);
  float err = add(add(add(sub(mul(ahi, bhi), p), mul(ahi, blo)),
                      mul(alo, bhi)),
                  mul(alo, blo));
  return {p, err};
}

__device__ __forceinline__ DF df_add(DF x, DF y) {
  DF s = two_sum(x.hi, y.hi);
  return fast_two_sum(s.hi, add(s.lo, add(x.lo, y.lo)));
}

__device__ __forceinline__ DF df_neg(DF x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ DF df_sub(DF x, DF y) { return df_add(x, df_neg(y)); }

__device__ __forceinline__ DF df_mul(DF x, DF y) {
  DF p = two_prod(x.hi, y.hi);
  return fast_two_sum(p.hi, add(p.lo, add(mul(x.hi, y.lo), mul(x.lo, y.hi))));
}

__device__ __forceinline__ DF df_div(DF x, DF y) {
  float q1 = __fdiv_rn(x.hi, y.hi);
  DF r = df_sub(x, df_mul(y, DF{q1, 0.0f}));
  float q2 = __fdiv_rn(add(r.hi, r.lo), y.hi);
  return fast_two_sum(q1, q2);
}

__device__ __forceinline__ DF df_scale(DF x, float c) {
  return {mul(x.hi, c), mul(x.lo, c)};
}

__device__ __forceinline__ DF poly_sin(DF d) {
  const DF one{1.0f, 0.0f};
  DF d2 = df_mul(d, d);
  DF t = df_sub(one, df_scale(d2, (float)(1.0 / 20.0)));
  t = df_sub(one, df_mul(df_scale(d2, (float)(1.0 / 6.0)), t));
  return df_mul(d, t);
}

__device__ __forceinline__ DF poly_cos(DF d) {
  const DF one{1.0f, 0.0f};
  DF d2 = df_mul(d, d);
  DF t = df_sub(one, df_scale(d2, (float)(1.0 / 30.0)));
  t = df_sub(one, df_mul(df_scale(d2, (float)(1.0 / 12.0)), t));
  return df_sub(one, df_mul(df_scale(d2, 0.5f), t));
}

// (sin, cos) of origin + d degrees: origin enters as exact df constants,
// the small-angle part by df Taylor series.
__device__ __forceinline__ void trig_local(float d, DF pi180, DF s0, DF c0,
                                           DF& sn, DF& cs) {
  DF rad = df_mul(DF{d, 0.0f}, pi180);
  DF s_d = poly_sin(rad);
  DF c_d = poly_cos(rad);
  sn = df_add(df_mul(s0, c_d), df_mul(c0, s_d));
  cs = df_sub(df_mul(c0, c_d), df_mul(s0, s_d));
}

__device__ __forceinline__ DF dot3(DF X, DF Y, DF Z, const float* tbl,
                                   int face, int k) {
  const float* hi = tbl + face * 9;
  const float* lo = tbl + kFaces * 9 + face * 9;
  DF acc = df_mul(X, DF{hi[k], lo[k]});
  acc = df_add(acc, df_mul(Y, DF{hi[k + 1], lo[k + 1]}));
  return df_add(acc, df_mul(Z, DF{hi[k + 2], lo[k + 2]}));
}

// nearest integer and the df residual collapsed to f32
__device__ __forceinline__ void df_round(DF v, float& r, float& frac) {
  float r0 = rintf(v.hi);
  float f0 = add(sub(v.hi, r0), v.lo);
  float adj = sub(f0 > 0.5f ? 1.0f : 0.0f, f0 < -0.5f ? 1.0f : 0.0f);
  r = add(r0, adj);
  frac = sub(f0, adj);
}

__device__ __forceinline__ float fmax_(float a, float b) { return a > b ? a : b; }

__global__ void __launch_bounds__(kThreads)
project_kernel(const float2* __restrict__ xy, int n,
               const float* __restrict__ table, Consts k,
               int* __restrict__ face_out, int* __restrict__ a_out,
               int* __restrict__ b_out, float* __restrict__ margin_out,
               float* __restrict__ gap_out) {
  __shared__ float tbl[kTable];
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float2 p = xy[i];
  const DF pi180{k.v[0], k.v[1]};
  DF sin_lat, cos_lat, sin_lng, cos_lng;
  trig_local(p.y, pi180, DF{k.v[2], k.v[3]}, DF{k.v[4], k.v[5]},
             sin_lat, cos_lat);
  trig_local(p.x, pi180, DF{k.v[6], k.v[7]}, DF{k.v[8], k.v[9]},
             sin_lng, cos_lng);
  DF X = df_mul(cos_lat, cos_lng);
  DF Y = df_mul(cos_lat, sin_lng);
  DF Z = sin_lat;

  // 20-face running argmax on the hi parts, plain f32 three-term dots
  float best = -2.0f, second = -2.0f;
  int face = 0;
#pragma unroll
  for (int f = 0; f < kFaces; ++f) {
    float d = add(add(mul(X.hi, c_face[3 * f]), mul(Y.hi, c_face[3 * f + 1])),
                  mul(Z.hi, c_face[3 * f + 2]));
    bool better = d > best;
    second = better ? best : fmax_(second, d);
    face = better ? f : face;
    best = better ? d : best;
  }
  float gap = sub(best, second);

  // gnomonic projection on the chosen face: three df dots, two df divisions
  DF u = dot3(X, Y, Z, tbl, face, 0);
  DF px = df_div(dot3(X, Y, Z, tbl, face, 3), u);
  DF py = df_div(dot3(X, Y, Z, tbl, face, 6), u);

  // cube rounding in the 60°-basis axial frame (q, r) = (a - b, b)
  DF rf = df_mul(py, DF{k.v[10], k.v[11]});
  DF qf = df_sub(px, df_scale(rf, 0.5f));
  DF sf = df_sub(df_neg(qf), rf);
  float rq, fq, rr, fr, rs, fs;
  df_round(qf, rq, fq);
  df_round(rf, rr, fr);
  df_round(sf, rs, fs);
  float dq = fabsf(fq), dr = fabsf(fr), ds = fabsf(fs);
  bool fix_q = (dq > dr) && (dq > ds);
  bool fix_r = !fix_q && (dr > ds);
  float rq2 = fix_q ? sub(-rr, rs) : rq;
  float rr2 = fix_r ? sub(-rq2, rs) : rr;
  fq = add(fq, sub(rq, rq2));
  fr = add(fr, sub(rr, rr2));

  // distance to the hex Voronoi boundary: the residual projected on the
  // three neighbour axes (0°, 60°, 120°); boundary at 0.5
  const float sin60 = k.v[12];
  float vx = add(fq, mul(0.5f, fr));
  float vy = mul(sin60, fr);
  float h = mul(0.5f, vx);
  float sv = mul(sin60, vy);
  float proj = fmax_(fabsf(vx), fmax_(fabsf(add(h, sv)), fabsf(sub(h, sv))));

  face_out[i] = face;
  a_out[i] = (int)add(rq2, rr2);
  b_out[i] = (int)rr2;
  margin_out[i] = fmax_(sub(0.5f, proj), 0.0f);
  gap_out[i] = gap;
}

}  // namespace

extern "C" {

// Upload the [20, 3] f32 face centers to this device's constant memory.
// Once per device before the first launch.
int h3_projection_set_faces(const float* faces_host) {
  cudaMemcpyToSymbol(c_face, faces_host, sizeof(float) * kFaces * 3);
  return (int)cudaGetLastError();
}

// xy [n, 2] f32 on the device; table [2, 20, 9] f32 on the device;
// consts_host [13] f32 in host memory; outputs [n] on the device.
// Launches on `stream` and returns the launch's CUDA error code.
int h3_project_lattice(const float* xy, int n, const float* table,
                       const float* consts_host, int* face, int* a, int* b,
                       float* margin, float* gap, void* stream) {
  Consts k;
  for (int i = 0; i < 13; ++i) k.v[i] = consts_host[i];
  int blocks = (n + kThreads - 1) / kThreads;
  project_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(xy), n, table, k, face, a, b, margin,
      gap);
  return (int)cudaGetLastError();
}

const char* h3_projection_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

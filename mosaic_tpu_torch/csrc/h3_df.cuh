// Double-single (df) f32 arithmetic and the per-point H3 lattice
// projection, shared by the port's three projection kernels:
// h3_projection.cu (the projection alone), h3_dense_join.cu (the
// projection fused with the dense PIP join body) and h3_cell.cu (cell
// ids of absolute points, which enters at project_xyz).
//
// Bits.  The plain PyTorch version (ops/projection.py
// project_lattice_ref over ops/twofloat.py) rounds every add, multiply
// and divide on its own, and these helpers keep its order of operations,
// so kernel and plain version agree bit for bit.  Every step is an
// explicit __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn and the build
// passes -fmad=false: a contraction the compiler chose would change the
// bits.  Rounding to integers is rintf (half to even, as torch.round).
//
// The one deliberate FMA is the error term of two_prod.  For f32 a and b
// with exponents summing to -103 or more (so nothing underflows) and a
// product that does not overflow, the residual a*b - fl(a*b) is exactly
// representable in f32, and both the Dekker/Veltkamp split of the plain
// version and fma(a, b, -p) compute it exactly: the split from four
// exact partial products, the FMA by rounding the exact a*b - p once,
// which leaves it unchanged.  So the two give the same bits, and an
// exact product costs one mul and one FMA where the split issued 17
// operations.  __fmaf_rn is emitted as an FMA under -fmad=false as well.
// The projection's products stay inside those limits except the square
// of a point's angle from the origin when that angle is below ~1e-14
// degrees (a point on the origin's meridian or parallel up to f64
// rounding); chip_smoke.py holds the outputs bit-equal on its inputs.
//
// What bounds the projection now: arithmetic issue.  The function needs
// 821 flops per point (an FMA counted as two) against 28 bytes moved
// (8 in, 20 out), some 29 flops per byte against the card's ~20 f32
// flops per byte of HBM bandwidth.  Uncontracted adds and multiplies
// each take an issue slot, so the kernel issues about 821 f32
// instructions per point, plus compares, selects and the shared-memory
// reads of the basis table.

#pragma once

#include <cuda_runtime.h>

namespace h3df {

constexpr int kFaces = 20;
constexpr int kTable = 2 * kFaces * 9;   // hi then lo, [face][9]

// df constants, f32: (hi, lo) of pi/180, sin/cos lat0, sin/cos lon0,
// 1/sin60, then sin60 rounded to f32.  Passed to a kernel by value.
struct Consts {
  float v[13];
};

struct DF {
  float hi, lo;
};

// The 20 face-center vectors: read with a uniform index, which the
// constant cache broadcasts.  Each kernel library holds its own copy,
// set once per device by its *_set_faces entry point.
__constant__ float c_face[kFaces * 3];

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fmax_(float a, float b) { return a > b ? a : b; }

__device__ __forceinline__ DF two_sum(float a, float b) {
  float s = add(a, b);
  float bb = sub(s, a);
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

__device__ __forceinline__ DF fast_two_sum(float a, float b) {
  float s = add(a, b);
  return {s, sub(b, sub(s, a))};
}

// p + err == a * b exactly: the same bits as the plain version's
// Veltkamp split (see the note at the top of this file)
__device__ __forceinline__ DF two_prod(float a, float b) {
  float p = __fmul_rn(a, b);
  return {p, __fmaf_rn(a, b, -p)};
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

// Copy the [2, 20, 9] basis table into the block's shared memory.  The
// row a thread reads (its point's face) differs between threads, and
// divergent __constant__ reads serialize.  Ends in __syncthreads().
__device__ __forceinline__ void load_table(float* tbl,
                                           const float* __restrict__ table) {
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
}

struct Projection {
  int face, a, b;
  float margin, gap;
};

// The projection of a unit-sphere point (X, Y, Z) in df -> (face, axial
// a, axial b, hex margin, face gap).  `tbl` is the basis table in shared
// memory; only k.v[10..12] (1/sin60 in df, sin60) are read.
__device__ __forceinline__ Projection project_xyz(DF X, DF Y, DF Z,
                                                  const float* tbl,
                                                  const Consts& k) {
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

  return {face, (int)add(rq2, rr2), (int)rr2, fmax_(sub(0.5f, proj), 0.0f),
          gap};
}

// One point's projection: origin-local lon/lat degrees -> (face, axial
// a, axial b, hex margin, face gap).  `tbl` is the basis table in
// shared memory.
__device__ __forceinline__ Projection project_point(float2 p,
                                                    const float* tbl,
                                                    const Consts& k) {
  const DF pi180{k.v[0], k.v[1]};
  DF sin_lat, cos_lat, sin_lng, cos_lng;
  trig_local(p.y, pi180, DF{k.v[2], k.v[3]}, DF{k.v[4], k.v[5]},
             sin_lat, cos_lat);
  trig_local(p.x, pi180, DF{k.v[6], k.v[7]}, DF{k.v[8], k.v[9]},
             sin_lng, cos_lng);
  return project_xyz(df_mul(cos_lat, cos_lng), df_mul(cos_lat, sin_lng),
                     sin_lat, tbl, k);
}

}  // namespace h3df

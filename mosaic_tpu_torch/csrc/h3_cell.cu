// H3 cell assignment for Hopper (sm_90a): absolute lon/lat degrees ->
// (int64 cell id, margin in planar degrees), one point per thread in a
// grid of at most the blocks the card holds at once.
//
// Replaces the JAX package's device cell step,
// mosaic_tpu/core/index/h3/jaxkernel.py latlng_to_cell_jax_margin (XLA
// code that the H3 grid's point_to_cell_jax_margin hook calls; it has no
// Pallas form).  The plain PyTorch version of the same function is
// ops/cell.py latlng_to_cell_margin_ref; this kernel gives its bits.  Per
// point:
//   * the hook's f32 round trip: degrees -> radians -> degrees ->
//     radians, each one multiply by a constant rounded to f32;
//   * f32 sine and cosine (sincosf, which gives sinf's and cosf's bits:
//     h3_cell_sincos_mismatches counts the inputs where it does not, and
//     chip_smoke.py requires 0 of all 2^32), lifted to df with a zero low
//     part;
//   * the df gnomonic projection shared with the projection kernels
//     (h3_df.cuh project_xyz);
//   * aperture-7 aggregation of the axial lattice point from res down to
//     0 (floor division by 7, as the JAX package's _round_div7), the
//     base-cell lookup, and the digit rotation with the pentagon seam
//     and relabel, into a 64-bit id built with shifts (mode bits at 59);
//   * the hex margin scaled to radians (0 where the nearest face is
//     ambiguous), then to degrees.
//
// What bounds it on an H100: instruction issue.  Per point it needs the
// projection's 439 f32 operations as chip_smoke.py counts them (an exact
// product as 3 flops, a sin or cos as 1) and, at res 9, 296 integer
// operations (chip_smoke.py's count of this kernel's integer steps: 20
// a level of the aggregation, 7 a digit of the rotation, 53 once),
// against 20 bytes moved (8 in, 8 + 4 out).  So the design spends as few
// instructions as it can outside the projection:
//   * at most one grid of resident blocks, so the 2.5 KB of tables are
//     staged once per resident block, not once per 256 points; a thread
//     a point (two points a thread were no faster at the main path's
//     2^18-point chunks, which fill the card about once);
//   * the resolution compiled in (one instance per res 0-15, chosen at
//     launch), so the digit loops unroll and every shift is a constant;
//     at most 32 registers, so an SM holds 2,048 threads;
//   * the cell tables packed on the host (ops/cell.py cell_words): per
//     res-0 ijk entry one word (base cell, its rotation, its pentagon
//     extra rotation, the base cell's pentagon flag and seam digit), and
//     per (rotation, extra rotation, relabel) one word composing the
//     three digit rotations, 3 bits per digit 0-7, so a digit costs one
//     shift and mask instead of three table reads; 612 words in shared
//     memory, with the basis table; the axial-difference digits are one
//     register word (9 x 3 bits);
//   * the lead digit without a loop: rotation keeps digit 0 fixed, so it
//     is the rotation of the first raw digit the rotation does not send
//     to 0, found by __clzll on the packed raw digits;
//   * round_div7 as an unsigned division by 7 of a biased value, exact
//     for every int32 input.
// Every table index is clamped into its table, as the plain version
// clamps it.

#include <cuda_runtime.h>

#include <cstdint>

#include "h3_df.cuh"

namespace {

using namespace h3df;

constexpr int kThreads = 256;
// at most 32 registers a thread, so the SM holds 2,048 threads
constexpr int kBlocksPerSm = 8;
// ops/cell.py cell_words: N_ENTRIES entry words, then N_ROT_WORDS
// rotation words indexed ((r0 * 6) + extra) * 2 + relabel
constexpr int kEntries = 540;
constexpr int kRotWords = 72;
constexpr int kCellWords = kEntries + kRotWords;

constexpr float kRadPerDeg = (float)(3.14159265358979323846 / 180.0);
constexpr float kDegPerRad = (float)(180.0 / 3.14159265358979323846);

// the low bit of each digit field of levels 1..15 (bit 3 * (15 - r))
constexpr unsigned long long kDigitLow = 0x0000049249249249ULL;

struct Scalars {
  unsigned digit_of_diff;   // 9 x 3 bits: axial diff (da+1)*3+(db+1) -> digit
  long long fill;           // unused digits res+1..15, each 7
  float margin_scale;       // lattice units -> radians at res, f32
  float gap_eps;            // FACEGAP_EPS, f32
};

// floor((2p + 7) / 14) for every int32 p, 2p + 7 wrapping as int32 does:
// floor(x / 14) = floor(floor(x / 2) / 7), and floor(x / 2) lies in
// [-2^30, 2^30), so adding 7 * 2^28 makes it non-negative for an
// unsigned division by the constant 7
__device__ __forceinline__ int round_div7(int p) {
  const int y = (int)(2u * (unsigned)p + 7u) >> 1;
  return (int)(((unsigned)y + 0x70000000u) / 7u) - 0x10000000;
}

__device__ __forceinline__ int digit_shift(int r) { return 3 * (15 - r); }

// The cell id and margin of one point at resolution R.
template <int R>
__device__ __forceinline__ void cell_of(float x, float y, const float* tbl,
                                        const int* ent,
                                        const unsigned* rotw,
                                        const Consts& k, const Scalars& s,
                                        long long& id, float& margin) {
  // the hook's f32 round trip, then f32 sin/cos as df with lo = 0
  const float lng = mul(mul(mul(x, kRadPerDeg), kDegPerRad), kRadPerDeg);
  const float lat = mul(mul(mul(y, kRadPerDeg), kDegPerRad), kRadPerDeg);
  float sl, cl, sg, cg;
  sincosf(lat, &sl, &cl);
  sincosf(lng, &sg, &cg);
  const DF cos_lat{cl, 0.0f};
  const Projection pr = project_xyz(df_mul(cos_lat, DF{cg, 0.0f}),
                                    df_mul(cos_lat, DF{sg, 0.0f}),
                                    DF{sl, 0.0f}, tbl, k);

  // aperture-7 aggregation R -> 0; raw digit r lands at its id position
  int ai = pr.a, bi = pr.b;
  unsigned long long raw = 0;
#pragma unroll
  for (int rv = R; rv >= 1; --rv) {
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
    const int at = min(max((ai - ca + 1) * 3 + (bi - cb + 1), 0), 8);
    raw |= (unsigned long long)((s.digit_of_diff >> (3 * at)) & 7u)
           << digit_shift(rv);
    ai = ua;
    bi = ub;
  }

  // res-0 normalized ijk -> the entry word
  const int mn = min(min(ai, bi), 0);
  const int entry = ((pr.face * 3 + (ai - mn)) * 3 + (bi - mn)) * 3 - mn;
  const int w = ent[min(max(entry, 0), kEntries - 1)];
  const int base = w & 127, r0 = (w >> 7) & 7;
  const bool pent = (w >> 13) & 1;

  // the lead digit: the r0 rotation of the first raw digit it does not
  // send to 0 (digit 0 always; digit 7, which no lattice point makes,
  // where the clamped table sends it there)
  const unsigned rot0 = rotw[r0 * 12];
  unsigned long long live = (raw | (raw >> 1) | (raw >> 2)) & kDigitLow;
  if (((rot0 >> 21) & 7u) == 0) live &= ~(raw & (raw >> 1) & (raw >> 2));
  int lead = 0;
  if (live) {
    const int at = 63 - __clzll((long long)live);
    lead = (rot0 >> (3 * (int)((raw >> at) & 7u))) & 7u;
  }
  // pentagon seam re-expression, then the published pentagon labels
  const bool seam_hit = pent && lead != 0 && lead == ((w >> 14) & 7);
  const int extra = seam_hit ? (w >> 10) & 7 : 0;
  const int lead_f = (rotw[extra * 2] >> (3 * lead)) & 7u;
  const int relabel = (pent && (lead_f == 1 || lead_f == 5)) ? 1 : 0;
  const unsigned rot = rotw[(r0 * 6 + extra) * 2 + relabel];
  long long h = (1LL << 59) | ((long long)R << 52) | s.fill |
                ((long long)base << 45);
#pragma unroll
  for (int rv = 1; rv <= R; ++rv) {
    const int sh = digit_shift(rv);
    const unsigned d = (unsigned)(raw >> sh) & 7u;
    h |= (long long)((rot >> (3 * d)) & 7u) << sh;
  }
  id = h;

  float m = mul(pr.margin, s.margin_scale);
  if (pr.gap < s.gap_eps) m = 0.0f;
  margin = mul(m, kDegPerRad);
}

// One point per thread, in a grid of at most the blocks the card holds
// at once (a grid-stride loop past that); the resolution compiled in.
template <int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
cell_kernel(const float2* __restrict__ xy, int n,
            const float* __restrict__ table,
            const int* __restrict__ cell_words, Consts k, Scalars s,
            long long* __restrict__ cells_out,
            float* __restrict__ margin_out) {
  __shared__ float tbl[kTable];
  __shared__ int ent[kEntries];
  __shared__ unsigned rotw[kRotWords];
  for (int i = threadIdx.x; i < kCellWords; i += blockDim.x) {
    const int v = cell_words[i];
    if (i < kEntries)
      ent[i] = v;
    else
      rotw[i - kEntries] = (unsigned)v;
  }
  load_table(tbl, table);        // ends in __syncthreads()
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float2 p = xy[i];
    cell_of<R>(p.x, p.y, tbl, ent, rotw, k, s, cells_out[i], margin_out[i]);
  }
}

// The points where sincosf's bits differ from sinf's or cosf's, over
// every f32 bit pattern (NaN results equal when both are NaN).
__global__ void sincos_check_kernel(unsigned long long* mismatches) {
  unsigned long long local = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long u = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       u < (1ULL << 32); u += stride) {
    const float x = __uint_as_float((unsigned)u);
    float s, c;
    sincosf(x, &s, &c);
    const float s1 = sinf(x), c1 = cosf(x);
    const bool same_s = __float_as_uint(s) == __float_as_uint(s1) ||
                        (s != s && s1 != s1);
    const bool same_c = __float_as_uint(c) == __float_as_uint(c1) ||
                        (c != c && c1 != c1);
    local += (same_s && same_c) ? 0 : 1;
  }
  if (local) atomicAdd(mismatches, local);
}

// The blocks of cell_kernel the current device holds at once (the same
// at every resolution: kBlocksPerSm bounds the registers), found once
// per device.
int resident_blocks() {
  static int blocks[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& b = blocks[dev & 63];
  if (b == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cell_kernel<9>,
                                                  kThreads, 0);
    b = sms * (per_sm > 0 ? per_sm : 1);
  }
  return b;
}

template <int R>
void launch(const float2* xy, int n, const float* table,
            const int* cell_words, const Consts& k, const Scalars& s,
            long long* cells, float* margin, cudaStream_t stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  const int resident = resident_blocks();
  if (blocks > resident) blocks = resident;
  cell_kernel<R><<<blocks, kThreads, 0, stream>>>(xy, n, table, cell_words,
                                                  k, s, cells, margin);
}

}  // namespace

extern "C" {

// Upload the [20, 3] f32 face centers to this device's constant memory.
// Once per device before the first launch.
int h3_cell_set_faces(const float* faces_host) {
  cudaMemcpyToSymbol(c_face, faces_host, sizeof(float) * kFaces * 3);
  return (int)cudaGetLastError();
}

// xy [n, 2] f32 on the device, 8-byte aligned; table [2, 20, 9] f32
// (basis at res) and cell_words [612] i32 (ops/cell.py cell_words) on the
// device; consts_host [13] f32 in host memory (only the 1/sin60 and
// sin60 entries are read); outputs [n] on the device; res 0..15.
// Launches on `stream` and returns the launch's CUDA error
// (cudaErrorInvalidValue for another res).
int h3_latlng_to_cell(const float* xy, int n, const float* table,
                      const int* cell_words, const float* consts_host,
                      int res, unsigned digit_of_diff, long long fill,
                      float margin_scale, float gap_eps, long long* cells,
                      float* margin, void* stream) {
  Consts k;
  for (int i = 0; i < 13; ++i) k.v[i] = consts_host[i];
  const Scalars s{digit_of_diff, fill, margin_scale, gap_eps};
  const float2* p = reinterpret_cast<const float2*>(xy);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (res) {
#define H3_CELL_RES(r) \
  case r: launch<r>(p, n, table, cell_words, k, s, cells, margin, st); break;
    H3_CELL_RES(0) H3_CELL_RES(1) H3_CELL_RES(2) H3_CELL_RES(3)
    H3_CELL_RES(4) H3_CELL_RES(5) H3_CELL_RES(6) H3_CELL_RES(7)
    H3_CELL_RES(8) H3_CELL_RES(9) H3_CELL_RES(10) H3_CELL_RES(11)
    H3_CELL_RES(12) H3_CELL_RES(13) H3_CELL_RES(14) H3_CELL_RES(15)
#undef H3_CELL_RES
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Count into *mismatches (zeroed by the caller) the f32 inputs where
// sincosf differs from sinf or cosf.  Launches on `stream`.
int h3_cell_sincos_mismatches(unsigned long long* mismatches,
                              void* stream) {
  sincos_check_kernel<<<4 * resident_blocks(), kThreads, 0,
                        (cudaStream_t)stream>>>(mismatches);
  return (int)cudaGetLastError();
}

const char* h3_cell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// The overlay's chip-pair probe for Hopper (sm_90a): for every B chip
// row, every A chip row of the same cell, the f32 ST_Intersects test of
// the two chips and its hazard flag, one warp per B row.
//
// Replaces the XLA body of the JAX package's single-device overlay,
// mosaic_tpu/parallel/overlay.py _chip_pair_test (:182) under
// _local_sorted_join (:245, the dense [GA, GB] result) and
// _local_pair_join (:367, the ragged row-pair keys).  It has no Pallas
// form.  The plain PyTorch version of the same function is
// ops/overlay_pairs.py chip_pair_test_ref with local_sorted_join_ref and
// local_pair_join_ref, which keep this kernel's order of operations.
//
// The wrapper sorts the A rows by cell (invalid rows last) and finds
// each B row's [start, upper) range among them; the kernel walks the
// whole range, so no duplicate cap and no retry exist.  Per (B row, A
// row) match:
//   * the four orientations of every edge pair, a proper crossing when
//     both pairs of signs differ, and the hazard band: an endpoint within
//     eps of the other edge's line (|orient| / length, the length floored
//     at 1e-30);
//   * each chip's first vertex against the other chip by crossing parity
//     (half-open straddle, t = (py - ay) / (by - ay), xi = ax + t (bx -
//     ax)), near when |px - xi| < eps on a straddling edge or when
//     |py - ay| < eps left of the edge's max x + eps;
//   * hit = crossing or either vertex inside; hazard = any band flag.
// Every f32 step is the XLA body's, one rounding per operation (the
// build has -fmad=false), so the kernel equals the plain version bit for
// bit.  An edge is padding when |ax| > 1e8 (the 1e9 sentinel): padding
// takes part in no test, so the kernel drops it when it loads a row.
//
// Two outputs from the one kernel:
//   * dense (mode 0): hits[ga, gb] = 1 and hazards[ga, gb] = 1, plain
//     stores of 1, so the result is the same whatever order the warps
//     run in; geometry ids outside [0, ga) x [0, gb) are dropped, as the
//     XLA scatter's mode="drop" drops them;
//   * pairs (mode 1): key = id_a * row_mult + id_b for every match that
//     hits or is flagged, through one atomic counter into a buffer of
//     `cap` keys; the counter ends at the exact total, so a caller whose
//     buffer was short relaunches once with cap = total.
//
// What bounds it on an H100: neither bytes nor arithmetic at the
// overlay's sizes.  A match reads two chip rows (E x 16 bytes each, from
// L2 mostly: a B row is reused over its whole range and A rows of one
// cell are read by every B row of that cell) and does ~25 f32 operations
// per padded edge pair.  Design:
//   * one warp per B row: the B row's real edges and lengths sit in
//     shared memory for the whole range, each A row's are loaded beside
//     them, compacted by a ballot so the lanes cover only real edge pairs
//     (about 6 x 4 of the 16 x 16 padded ones on city footprints);
//   * the lanes split the edge pairs of the four orientation tests and
//     the band, reduced with __any_sync; the two containment tests split
//     the edges, with the crossing parity from __popc(__ballot_sync(...))
//     and near from __any_sync;
//   * lane 0 stores the result; nothing is reduced across warps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPadAbove = 1e8f;

struct Out {
  int mode;                      // 0 dense, 1 pairs
  int* hits;                     // dense [ga, gb]
  int* hazards;
  long long ga, gb;
  long long* keys;               // pairs [cap]
  long long cap;
  unsigned long long* count;
  long long row_mult;
};

__device__ __forceinline__ float orient(float px, float py, float qx,
                                        float qy, float rx, float ry) {
  return (qx - px) * (ry - py) - (qy - py) * (rx - px);
}

// The real edges of one row, in order, into dst with their lengths
// (floored at 1e-30); returns how many.  Warp-wide.
__device__ int load_row(const float4* __restrict__ row, int cap,
                        float4* dst, float* len, int lane) {
  int n = 0;
  for (int base = 0; base < cap; base += 32) {
    int k = base + lane;
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    bool real = false;
    if (k < cap) {
      e = row[k];
      real = !(fabsf(e.x) > kPadAbove);
    }
    unsigned m = __ballot_sync(kFull, real);
    if (real) {
      int pos = n + __popc(m & ((1u << lane) - 1u));
      dst[pos] = e;
      float dx = e.z - e.x, dy = e.w - e.y;
      len[pos] = fmaxf(sqrtf(dx * dx + dy * dy), 1e-30f);
    }
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// Crossing parity of (px, py) against n edges, and the near flag.
// Warp-wide; every lane gets both answers.
__device__ void contains(float px, float py, const float4* e, int n,
                         float eps, int lane, bool* inside, bool* near) {
  int hits = 0;
  bool nr = false;
  for (int k = lane; k < n; k += 32) {
    float4 ed = e[k];
    bool straddle = (ed.y <= py) != (ed.w <= py);
    float t = (py - ed.y) / (ed.w == ed.y ? 1.0f : ed.w - ed.y);
    float xi = ed.x + t * (ed.z - ed.x);
    if (straddle && px < xi) ++hits;
    nr |= straddle && fabsf(px - xi) < eps;
    nr |= fabsf(py - ed.y) < eps && px < fmaxf(ed.x, ed.z) + eps;
  }
  *inside = __popc(__ballot_sync(kFull, hits & 1)) & 1;
  *near = __any_sync(kFull, nr);
}

__global__ void overlay_kernel(const float4* __restrict__ edges_a,
                               const long long* __restrict__ order,
                               const long long* __restrict__ id_a,
                               int ea_cap,
                               const float4* __restrict__ edges_b,
                               const long long* __restrict__ id_b,
                               int eb_cap,
                               const long long* __restrict__ start,
                               const long long* __restrict__ upper,
                               long long nb, float eps, Out out) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int width = ea_cap + eb_cap;
  float4* sb = smem + wib * width;
  float4* sa = sb + eb_cap;
  float* lb = reinterpret_cast<float*>(smem + wpb * width) + wib * width;
  float* la = lb + eb_cap;

  const long long row = (long long)blockIdx.x * wpb + wib;
  if (row >= nb) return;                 // warp-uniform
  const long long lo = start[row], hi = upper[row];
  if (lo >= hi) return;
  const float4* brow = edges_b + row * eb_cap;
  const float4 b0 = brow[0];             // B's first vertex, padding or not
  const int nbe = load_row(brow, eb_cap, sb, lb, lane);
  const long long gb_id = id_b[row];

  for (long long s = lo; s < hi; ++s) {
    const long long ra = order[s];
    const float4* arow = edges_a + ra * ea_cap;
    const float4 a0 = arow[0];
    const int nae = load_row(arow, ea_cap, sa, la, lane);

    bool cross = false, tiny = false;
    const int pairs = nae * nbe;
    for (int p = lane; p < pairs; p += 32) {
      const int i = p / nbe, k = p - i * nbe;
      const float4 e1 = sa[i], e2 = sb[k];
      const float d1 = orient(e2.x, e2.y, e2.z, e2.w, e1.x, e1.y);
      const float d2 = orient(e2.x, e2.y, e2.z, e2.w, e1.z, e1.w);
      const float d3 = orient(e1.x, e1.y, e1.z, e1.w, e2.x, e2.y);
      const float d4 = orient(e1.x, e1.y, e1.z, e1.w, e2.z, e2.w);
      cross |= ((d1 > 0.f) != (d2 > 0.f)) && ((d3 > 0.f) != (d4 > 0.f));
      tiny |= (fminf(fabsf(d1), fabsf(d2)) / lb[k] < eps) ||
              (fminf(fabsf(d3), fabsf(d4)) / la[i] < eps);
    }
    cross = __any_sync(kFull, cross);
    tiny = __any_sync(kFull, tiny);
    bool ina, na, inb, nbr;
    contains(a0.x, a0.y, sb, nbe, eps, lane, &ina, &na);
    contains(b0.x, b0.y, sa, nae, eps, lane, &inb, &nbr);
    const bool hit = cross || ina || inb;
    const bool hazard = tiny || na || nbr;

    if (lane == 0) {
      const long long ga_id = id_a[ra];
      if (out.mode == 0) {
        if (ga_id >= 0 && ga_id < out.ga && gb_id >= 0 && gb_id < out.gb) {
          const long long at = ga_id * out.gb + gb_id;
          if (hit) out.hits[at] = 1;
          if (hazard) out.hazards[at] = 1;
        }
      } else if (hit || hazard) {
        const unsigned long long slot = atomicAdd(out.count, 1ULL);
        if ((long long)slot < out.cap)
          out.keys[slot] = ga_id * out.row_mult + gb_id;
      }
    }
    __syncwarp();                        // sa is reloaded next round
  }
}

}  // namespace

extern "C" {

// edges_a [na, ea_cap, 4] f32, order [na] (A rows by cell), id_a [na];
// edges_b [nb, eb_cap, 4] f32, id_b [nb], start/upper [nb] (the range of
// sorted A positions to test; upper == start skips the row); all on the
// device, 16-byte aligned edges.  mode 0 writes hits/hazards [ga, gb]
// (zeroed by the caller); mode 1 writes keys [cap] and adds to *count
// (zeroed by the caller).  Shared memory: warps_per_block * (ea_cap +
// eb_cap) * 20 bytes, at most 48 KB.  Launches on `stream` and returns
// the launch's CUDA error.
int overlay_pairs_launch(const float* edges_a, const long long* order,
                         const long long* id_a, int ea_cap,
                         const float* edges_b, const long long* id_b,
                         int eb_cap, const long long* start,
                         const long long* upper, long long nb, float eps,
                         int warps_per_block, int mode, int* hits,
                         int* hazards, long long ga, long long gb,
                         long long* keys, long long cap, long long* count,
                         long long row_mult, void* stream) {
  Out out{mode, hits, hazards, ga, gb, keys, cap,
          reinterpret_cast<unsigned long long*>(count), row_mult};
  const long long blocks = (nb + warps_per_block - 1) / warps_per_block;
  const size_t smem =
      (size_t)warps_per_block * (ea_cap + eb_cap) * (sizeof(float4) + 4);
  overlay_kernel<<<(unsigned)blocks, 32 * warps_per_block, smem,
                   (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(edges_a), order, id_a, ea_cap,
      reinterpret_cast<const float4*>(edges_b), id_b, eb_cap, start, upper,
      nb, eps, out);
  return (int)cudaGetLastError();
}

const char* overlay_pairs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// The overlay's chip-pair probe for Hopper (sm_90a): for every B chip
// row, every A chip row of the same cell, the f32 ST_Intersects test of
// the two chips and its hazard flag; a lane a match, over a flat list of
// the matches.
//
// Replaces the XLA body of the JAX package's single-device overlay,
// mosaic_tpu/parallel/overlay.py _chip_pair_test (:182) under
// _local_sorted_join (:245, the dense [GA, GB] result) and
// _local_pair_join (:367, the ragged row-pair keys).  It has no Pallas
// form.  The plain PyTorch version of the same function is
// ops/overlay_pairs.py chip_pair_test_ref with local_sorted_join_ref and
// local_pair_join_ref, which keep this kernel's order of operations.
//
// The wrapper (ops/overlay_pairs.py match_list) sorts the A rows by cell
// (`order`, invalid rows last), finds each B row's range [start, upper)
// among them (empty for an invalid B row) and takes the exclusive prefix
// sum `offs` of the range lengths over the B rows in their own order:
// match m belongs to the B row j with offs[j] <= m < offs[j + 1] and
// tests A row order[start[j] + m - offs[j]].  Per match:
//   * the four orientations of every real edge pair, a proper crossing
//     when both pairs of signs differ, and the hazard band: an endpoint
//     within eps of the other edge's line (|orient| / length, the length
//     floored at 1e-30);
//   * each chip's first vertex against the other chip by crossing parity
//     (half-open straddle, t = (py - ay) / (by - ay), xi = ax + t (bx -
//     ax)), near when |px - xi| < eps on a straddling edge or when
//     |py - ay| < eps left of the edge's max x + eps;
//   * hit = crossing or either vertex inside; hazard = any band flag.
// Every f32 step is the XLA body's, one rounding per operation (the
// build has -fmad=false), so the kernel equals the plain version bit for
// bit.  The band's quotient |orient| / length is first taken as |orient|
// times the reciprocal length, whose relative error is below 2e-7: only
// when that lands within 2^-20 of eps is the rounded quotient itself
// computed and compared, so the flag is the plain version's.  An edge is
// padding when |ax| > 1e8 (the 1e9 sentinel): padding takes part in no
// test, so the kernel drops it when it stages a row.
//
// Two outputs from the one kernel:
//   * dense (mode 0): hits[ga, gb] = 1 and hazards[ga, gb] = 1, plain
//     stores of 1, so the result is the same whatever order the groups
//     run in; geometry ids outside [0, ga) x [0, gb) are dropped, as the
//     XLA scatter's mode="drop" drops them;
//   * pairs (mode 1): key = id_a * row_mult + id_b for every match that
//     hits or is flagged, through one atomic counter into a buffer of
//     `cap` keys, one atomicAdd per warp step for all its groups' keys;
//     the counter ends at the exact total, so a caller whose buffer was
//     short relaunches once with cap = total.
//
// What bounds it on an H100: the bytes of the A rows (each read once,
// 272 bytes with its id and sort position; 111 MB on the 2^17-footprint
// overlay, 0.033 ms) and latency: each match needs a random A row, and
// a warp that walks one B row's range a match at a time waits on every
// row in turn (lane groups of 4-16 lanes a match were no better: the
// groups of a warp wait on each other's loads at every warp-wide vote).
// This design:
//   * a pre-pass over the B rows (overlay_prep_b, one thread a row)
//     compacts each row's real edges and computes their directions,
//     lengths and reciprocals once; the B rows are few (the zones'
//     chips) and stay in L2;
//   * a persistent grid; the matches are split evenly over the warps, a
//     warp takes 32 at a time, a lane one: no warp waits on an empty
//     range, and the 32 matches of a step mostly share their B row (a
//     row's matches are consecutive), so its prepped edges reach the
//     lanes as broadcasts;
//   * a warp finds its first B row by a 32-ary search of `offs`; each
//     step a lane finds its row from the 32 range ends after the
//     previous step's last row;
//   * the step's 32 A rows go to shared memory by asynchronous copies
//     (cp.async), 16 lanes a row, all in flight at once, while the next
//     step's rows are located; a row's lane reads it from there.  A rows
//     too wide for a block's shared memory (more than 227 edges on an
//     H100) are read by their lanes from global memory instead;
//   * a lane walks its A row's real edges (each edge's direction and
//     length computed once) against the B row's, 18 f32 operations a
//     pair for the four orientations, and the least band quotient;
//   * pair mode: one warp-aggregated atomicAdd per warp step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPadAbove = 1e8f;
constexpr int kThreads = 64;

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

struct Band {
  float eps, lo, hi;             // eps, and eps (1 -+ 2^-20) in f32
};

// The B rows, and as the pre-pass leaves them: real edges first, each
// as (ax, ay, bx, by) then (bx - ax, by - ay, length, 1/length), and the
// count of real edges.
struct BRows {
  const float4* edges;           // [nb, cap] raw, for the first vertex
  const long long* id;           // [nb]
  const float4* ew;              // [nb, cap, 2]
  const int* count;              // [nb]
  int cap;
};

struct Rows {
  const float4* edges_a;         // [na, ea_cap]
  const long long* order;        // [na] A rows sorted by cell
  const long long* id_a;         // [na]
  int ea_cap, stride;            // a staged A row's float4s: odd, >= cap
  const long long* start;        // [nb] B row j's first sorted A position
  const long long* offs;         // [nb + 1] exclusive prefix sum of ranges
  long long nb;
  BRows b;
};

// |orient| / length < eps, bit for bit as the plain version rounds it:
// the product by the reciprocal decides unless it lands within 2^-20 of
// eps, where the rounded quotient does
__device__ __forceinline__ bool in_band(float x, float len, float rcp,
                                        const Band& b) {
  const float q = x * rcp;
  bool in = q < b.lo;
  if (!in && q < b.hi) in = __fdiv_rn(x, len) < b.eps;
  return in;
}

// (bx - ax, by - ay, length floored at 1e-30, its reciprocal) of an edge,
// as the plain version's _lengths rounds them
__device__ __forceinline__ float4 edge_w(const float4& e) {
  const float dx = e.z - e.x, dy = e.w - e.y;
  const float len = fmaxf(sqrtf(dx * dx + dy * dy), 1e-30f);
  return make_float4(dx, dy, len, __frcp_rn(len));
}

// One edge's share of the crossing parity of (px, py) (half-open
// straddle, the crossing abscissa as the plain version rounds it), and
// whether the point lies within eps of the edge.
__device__ __forceinline__ void edge_test(float px, float py,
                                          const float4& ed, float eps,
                                          bool& odd, bool& near) {
  const bool straddle = (ed.y <= py) != (ed.w <= py);
  if (straddle) {
    const float t = (py - ed.y) / (ed.w - ed.y);
    const float xi = ed.x + t * (ed.z - ed.x);
    odd ^= px < xi;
    near |= fabsf(px - xi) < eps;
  }
  near |= fabsf(py - ed.y) < eps && px < fmaxf(ed.x, ed.z) + eps;
}

// The B row pre-pass: B row j -> its compacted edges and their count.
__global__ void prep_b_kernel(const float4* __restrict__ edges_b,
                              long long nb, int cap, float4* ew,
                              int* count) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nb) return;
  const float4* row = edges_b + j * cap;
  int n = 0;
  for (int k = 0; k < cap; ++k) {
    const float4 ed = row[k];
    if (!(fabsf(ed.x) > kPadAbove)) {
      ew[2 * (j * cap + n)] = ed;
      ew[2 * (j * cap + n) + 1] = edge_w(ed);
      ++n;
    }
  }
  count[j] = n;
}

// The index r in [0, n) with offs[r] <= m < offs[r + 1] (the last such
// r, past any empty range) for a warp-uniform m, by a 32-ary search over
// the warp: the lanes' probes rise with the lane, so the ones at or below
// m are a prefix.  Warp-wide.
__device__ __forceinline__ long long find_row(const long long* offs,
                                              long long n, long long m,
                                              int lane) {
  long long lo = 0, hi = n;              // offs[lo] <= m < offs[hi]
  while (hi - lo > 1) {
    const long long span = hi - lo;
    const long long q = lo + span * (lane + 1) / 33;
    const int c = __popc(__ballot_sync(kFull, __ldg(offs + q) <= m));
    const long long nlo = c > 0 ? lo + span * c / 33 : lo;
    hi = c < 32 ? lo + span * (c + 1) / 33 : hi;
    lo = nlo;
  }
  return lo;
}

// The same search by one lane alone (binary).
__device__ __forceinline__ long long find_row_lane(const long long* offs,
                                                   long long n, long long m) {
  long long lo = 0, hi = n;
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(offs + mid) <= m) lo = mid; else hi = mid;
  }
  return lo;
}

// The four orientations of an A edge e1 (direction w1) against a B edge
// e2 (direction w2): orient(e2.a, e2.b, e1.a), (.., e1.b), orient(e1.a,
// e1.b, e2.a), (.., e2.b), the plain version's roundings.  e2.a - e1.a
// is -(e1.a - e2.a) exactly, up to the sign of a zero, which neither the
// signs tested nor |d| see.
struct Orients {
  float d1, d2, d3, d4;

  __device__ __forceinline__ Orients(const float4& e1, const float4& w1,
                                     const float4& e2, const float4& w2) {
    const float ux = e1.x - e2.x, uy = e1.y - e2.y;
    const float vx = e1.z - e2.x, vy = e1.w - e2.y;
    const float wx = e2.z - e1.x, wy = e2.w - e1.y;
    d1 = w2.x * uy - w2.y * ux;
    d2 = w2.x * vy - w2.y * vx;
    d3 = w1.x * -uy - w1.y * -ux;
    d4 = w1.x * wy - w1.y * wx;
  }
};

// One lane, one match: every real edge pair of the A row at `arow`
// (staged, or in global memory) and prepped B row j, both containment
// tests; (hit, hazard).
// The band's quotients go by their reciprocal products: the least of
// them decides unless it lands within 2^-20 of eps, and then the match's
// pairs are walked again with the rounded quotients.
__device__ __forceinline__ void test_match(const Rows& rw, const Band& band,
                                           const float4* arow, long long j,
                                           bool& hit, bool& hazard) {
  const float4* bj = rw.b.ew + 2 * j * rw.b.cap;
  const int nbe = __ldg(rw.b.count + j);
  const float4 b0 = __ldg(rw.b.edges + j * rw.b.cap);
  bool cross = false, odd_a = false, odd_b = false, near = false;
  float qmin = __int_as_float(0x7f800000);        // +inf
  for (int i = 0; i < rw.ea_cap; ++i) {
    const float4 e1 = arow[i];
    if (fabsf(e1.x) > kPadAbove) continue;
    const float4 w1 = edge_w(e1);
    edge_test(b0.x, b0.y, e1, band.eps, odd_b, near);
    const float4* bp = bj;
    for (int k = 0; k < nbe; ++k, bp += 2) {
      const float4 e2 = __ldg(bp), w2 = __ldg(bp + 1);
      const Orients o(e1, w1, e2, w2);
      cross |= ((o.d1 > 0.f) != (o.d2 > 0.f)) &&
               ((o.d3 > 0.f) != (o.d4 > 0.f));
      qmin = fminf(qmin, fminf(fminf(fabsf(o.d1), fabsf(o.d2)) * w2.w,
                               fminf(fabsf(o.d3), fabsf(o.d4)) * w1.w));
    }
  }
  bool tiny = qmin < band.lo;
  if (!tiny && qmin < band.hi) {
    for (int i = 0; i < rw.ea_cap; ++i) {
      const float4 e1 = arow[i];
      if (fabsf(e1.x) > kPadAbove) continue;
      const float4 w1 = edge_w(e1);
      const float4* bp = bj;
      for (int k = 0; k < nbe; ++k, bp += 2) {
        const float4 e2 = __ldg(bp), w2 = __ldg(bp + 1);
        const Orients o(e1, w1, e2, w2);
        tiny |= in_band(fminf(fabsf(o.d1), fabsf(o.d2)), w2.z, w2.w, band);
        tiny |= in_band(fminf(fabsf(o.d3), fabsf(o.d4)), w1.z, w1.w, band);
      }
    }
  }
  const float2 a0 = make_float2(arow[0].x, arow[0].y);
  const float4* bp = bj;
  for (int k = 0; k < nbe; ++k, bp += 2)
    edge_test(a0.x, a0.y, __ldg(bp), band.eps, odd_a, near);
  hit = cross || odd_a || odd_b;
  hazard = tiny || near;
}

// A 16-byte asynchronous copy from global to shared memory (cp.async,
// around L1), and the wait for all of this thread's copies.
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One warp step's matches: lane l's is m0 + l (past w1: the last one's
// place, inactive); its B row j and its A row ra.
struct Step {
  long long m0, j, ra;
  bool active;
};

// The step from m0, its B rows found from j0, a B row at or before the
// first match's: j0 plus the rows from j0 on whose ranges end at or
// before the lane's match, counted by a binary search over their 32
// ends; a lane past them (32 ranges ending within 32 matches: empty
// rows) searches alone.  Warp-wide.
__device__ __forceinline__ Step locate(const Rows& rw, long long m0,
                                       long long w1, long long j0,
                                       int lane) {
  const long long m = m0 + lane;
  const bool active = m < w1;
  const long long mq = active ? m : w1 - 1;
  const long long end = j0 + lane < rw.nb ? __ldg(rw.offs + j0 + 1 + lane)
                                          : 0x7fffffffffffffffLL;
  int c = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (__shfl_sync(kFull, end, c + step - 1) <= mq) c += step;
  const long long last = __shfl_sync(kFull, end, 31);
  if (c == 31 && last <= mq) c = 32;
  const long long j = c < 32 ? j0 + c : find_row_lane(rw.offs, rw.nb, mq);
  const long long ra = __ldg(rw.order + __ldg(rw.start + j) + mq -
                             __ldg(rw.offs + j));
  return {m0, j, ra, active};
}

// Start copying the step's 32 A rows into `rows`, lane l's at l * stride,
// 16 lanes a row, two rows at once, all in flight together.  Warp-wide.
__device__ __forceinline__ void stage_rows(const Rows& rw, const Step& st,
                                           float4* rows, int lane) {
  for (int t = lane >> 4; t < 32; t += 2) {
    const long long r = __shfl_sync(kFull, st.ra, t);
    for (int k = lane & 15; k < rw.ea_cap; k += 16)
      copy16(rows + t * rw.stride + k, rw.edges_a + r * rw.ea_cap + k);
  }
}

// kStaged: the step's A rows are copied to shared memory; else each lane
// reads its own A row from global memory (rows too wide to stage).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
overlay_kernel(Rows rw, Band band, Out out) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  const long long wid = (long long)blockIdx.x * (blockDim.x / 32) +
                        threadIdx.x / 32;
  // the warp's 32 A rows of a step, lane l's at l * stride (an odd
  // stride: the lanes' reads of their own rows fall in different banks)
  float4* rows = smem + (size_t)(threadIdx.x / 32) * 32 * rw.stride;
  const long long total = __ldg(rw.offs + rw.nb);
  const long long w0 = total * wid / warps, w1 = total * (wid + 1) / warps;
  if (w0 >= w1) return;                        // warp-uniform
  // the warp walks its share of the flat list 32 matches at a time, a
  // lane a match; the next step's rows are located while this one's
  // copies are in flight
  Step st = locate(rw, w0, w1, find_row(rw.offs, rw.nb, w0, lane), lane);
  while (true) {
    if (kStaged) stage_rows(rw, st, rows, lane);
    const bool more = st.m0 + 32 < w1;
    Step nx = st;
    if (more)
      nx = locate(rw, st.m0 + 32, w1, __shfl_sync(kFull, st.j, 31), lane);
    if (kStaged) {
      copies_wait();
      __syncwarp();
    }

    bool hit = false, hazard = false;
    long long ga_id = 0, gb_id = 0;
    if (st.active) {
      ga_id = __ldg(rw.id_a + st.ra);
      gb_id = __ldg(rw.b.id + st.j);
      test_match(rw, band,
                 kStaged ? rows + lane * rw.stride
                         : rw.edges_a + st.ra * rw.ea_cap,
                 st.j, hit, hazard);
    }

    if (out.mode == 0) {
      if ((hit || hazard) && ga_id >= 0 && ga_id < out.ga && gb_id >= 0 &&
          gb_id < out.gb) {
        const long long at = ga_id * out.gb + gb_id;
        if (hit) out.hits[at] = 1;
        if (hazard) out.hazards[at] = 1;
      }
    } else {
      const bool emit = hit || hazard;
      const unsigned em = __ballot_sync(kFull, emit);
      if (em) {
        unsigned long long slot = 0;
        if (lane == 0) slot = atomicAdd(out.count, (unsigned long long)
                                                       __popc(em));
        slot = __shfl_sync(kFull, slot, 0) + __popc(em & ((1u << lane) - 1u));
        if (emit && (long long)slot < out.cap)
          out.keys[slot] = ga_id * out.row_mult + gb_id;
      }
    }
    __syncwarp();                      // the rows are restaged next step
    if (!more) break;
    st = nx;
  }
}

// The odd float4 stride of a staged A row of `cap` edges, and the
// dynamic shared memory of a block.
int row_stride(int cap) { return cap % 2 ? cap : cap + 1; }

size_t smem_bytes(int cap) {
  return (size_t)(kThreads / 32) * 32 * row_stride(cap) * sizeof(float4);
}

// The blocks of `kernel` device `dev` holds at once with `smem` bytes
// each, found once per (kernel, device, smem).
int resident_blocks(const void* kernel, int dev, size_t smem) {
  static const void* last_kernel = nullptr;
  static int last_dev = -1, last_blocks = 0;
  static size_t last_smem = 0;
  if (kernel != last_kernel || dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kThreads, smem);
    last_kernel = kernel;
    last_dev = dev;
    last_smem = smem;
    last_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return last_blocks;
}

}  // namespace

extern "C" {

// The pre-pass: B rows edges_b [nb, cap, 4] f32 -> ew [nb, cap, 2, 4] f32
// and count [nb] i32, all on the device.  Launches on `stream` and
// returns the launch's CUDA error.
int overlay_prep_b(const float* edges_b, int cap, long long nb, float* ew,
                   int* count, void* stream) {
  if (nb > 0)
    prep_b_kernel<<<(unsigned)((nb + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(edges_b), nb, cap,
        reinterpret_cast<float4*>(ew), count);
  return (int)cudaGetLastError();
}

// The probe: A rows edges_a [na, ea_cap, 4] f32, order [na] (A rows by
// cell), id_a [na]; per B row j start [nb] (its first sorted A position)
// and offs [nb + 1] (the exclusive prefix sum of its range lengths); the
// B rows edges_b [nb, eb_cap, 4] f32 and id_b [nb], and the pre-pass's
// ew [nb, eb_cap, 2, 4] and count [nb]; all on the device, 16-byte
// aligned edges.  mode 0 writes hits/hazards [ga, gb] (zeroed by the
// caller); mode 1 writes keys [cap] and adds to *count (zeroed by the
// caller).  The A rows are staged in shared memory when a block's fit
// the device's, else read from global memory.  Launches a persistent
// grid on `stream` and returns the launch's CUDA error.
int overlay_pairs_launch(const float* edges_a, const long long* order,
                         const long long* id_a, int ea_cap,
                         const long long* start, const long long* offs,
                         long long nb, const float* edges_b,
                         const long long* id_b, const float* pew,
                         const int* pcount, int eb_cap, float eps,
                         int mode, int* hits, int* hazards, long long ga,
                         long long gb, long long* keys, long long cap,
                         long long* count, long long row_mult,
                         void* stream) {
  const Rows rw{reinterpret_cast<const float4*>(edges_a), order, id_a,
                ea_cap, row_stride(ea_cap), start, offs, nb,
                BRows{reinterpret_cast<const float4*>(edges_b), id_b,
                      reinterpret_cast<const float4*>(pew), pcount,
                      eb_cap}};
  const Band band{eps, (float)((double)eps * (1.0 - 0x1p-20)),
                  (float)((double)eps * (1.0 + 0x1p-20))};
  const Out out{mode, hits, hazards, ga, gb, keys, cap,
                reinterpret_cast<unsigned long long*>(count), row_mult};
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = smem_bytes(ea_cap);
  if (smem > (size_t)optin) {
    overlay_kernel<false><<<resident_blocks(
        (const void*)overlay_kernel<false>, dev, 0), kThreads, 0, st>>>(
        rw, band, out);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        overlay_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  overlay_kernel<true><<<resident_blocks((const void*)overlay_kernel<true>,
                                         dev, smem), kThreads, smem, st>>>(
      rw, band, out);
  return (int)cudaGetLastError();
}

const char* overlay_pairs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

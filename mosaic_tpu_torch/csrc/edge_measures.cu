// Per-geometry measures of padded edge blocks for Hopper (sm_90a): area,
// length, centroid or bounds of each geometry of an EdgeBlocks batch,
// a [G, E, 2] (a, b) pair of edge endpoints with a [G, E] validity mask,
// in float32 or float64.
//
// Replaces the XLA bodies of the JAX package's
// mosaic_tpu/core/geometry/measures.py :27 area, :37 length, :43
// centroid and :64 bounds, each a masked reduction over a geometry's
// padded edges.  None has a Pallas form.  The plain PyTorch version is
// ops/edge_measures.py edge_measures_ref.
//
// Per geometry, over its E edge slots in order ([x]_e is x where slot e
// is valid and +0 where it is not, the select XLA makes of the JAX
// body's multiply by the bool mask; cross_e = ax*by - ay*bx; len_e =
// sqrt(dx*dx + dy*dy) with d = b - a; every sum starts at 0 and adds
// e = 0, 1, ... in turn):
//   area     = max(0.5 * sum([cross]_e), 0), NaN kept;
//   length   = sum([len]_e);
//   centroid = with w_e = [cross]_e, l_e = [len]_e, A = sum(w_e):
//              sum((a + b) * w_e) / (3 A + eps)      where |A| > 1e-30,
//              else sum((0.5 (a + b)) * l_e) / (L + eps), L the length,
//              where L > 1e-30,
//              else sum([a]_e) / (n + eps), n the valid slots;
//   bounds   = (xmin, ymin, xmax, ymax) over both endpoints of the valid
//              slots in the order a_0, b_0, a_1, b_1, ..., +-inf where none
//              is valid; the running min takes v where v < m or v is NaN
//              (so it keeps the last NaN, else the first of equal minima,
//              which tells -0 from +0), the max likewise.
// eps is the JAX body's 1e-300 guard: 0 in float32, where 1e-300 rounds
// to 0 (so a row with no valid slot has a NaN centroid there, as XLA
// gives), 1e-300 in float64.  The thresholds 1e-30 are rounded to the
// block's type.  A masked slot's endpoints still enter the centroid's
// products (a + b) * w_e and (0.5 (a + b)) * l_e, so a NaN there gives a
// NaN centroid, as in the JAX body.  Each multiply, add and subtract is
// rounded on its own (-fmad=false), the divide and sqrt are IEEE.
//
// Why any lane may compute a slot's terms and the answer stays bit-equal
// to the plain version, which loops over the slots in order:
//  * every per-slot term (w_e, l_e, (a + b) * w_e, (0.5 (a + b)) * l_e,
//    [a]_e, and for the bounds the pair min(a_e, b_e), max(a_e, b_e)
//    below) is a function of slot e alone, computed by the same rounded
//    steps wherever it is computed;
//  * the sums are then added in slot order, one rounded add a slot, from
//    0, by one thread: the same chain of additions as the plain version's;
//  * the bounds' step f(m, v) = (v < m or v is NaN) ? v : m folds a
//    sequence to "its last NaN, else its first minimum", and that is
//    associative: f(f(f(m, a), b)) = f(m, f(a, b)), so a slot's pair can
//    be folded first; a masked slot folds +inf (-inf for the max), which
//    f never takes over m, as the plain version skips the slot;
//  * a masked slot adds +0 to area, length and the centroid's w, l and
//    [a] sums, as the plain version does: so its endpoints are never read
//    for area, length and bounds, and they are read for the centroid,
//    whose products of a masked slot are (a + b) * +0 (NaN for a NaN or
//    infinite end).
//
// What bounds it on an H100: its bytes.  The centroid reads every
// endpoint, the mask and writes its output (2^20 footprints of 8 slots in
// float64: 293.6 MB, 87.6 us at 3.35 TB/s); area, length and bounds need
// only the 32-byte sectors that hold a valid slot's endpoints (the
// footprints' 4 valid slots of 8: about 144 B a row in float64); the
// arithmetic is some 40 operations a slot.
//
// Design: two mappings, picked by the launch from (G, E) (launch_plan in
// ops/edge_measures.py keeps the same rule; the thresholds are where the
// two cross in tools/k11_compare.py --sweep on the H100):
//  * staged tiles, for E <= kStagedSlots and G >= kStagedRows: a block of
//    128 threads owns 128 whole rows.  It copies kChunk (8) slots of each
//    of its rows at a time into shared memory by cp.async, 16-byte
//    (x, y) copies in float64 and 8-byte ones in float32, one slot a lane
//    (a warp covers 4 rows' chunks of consecutive bytes); the mask first
//    (one 8-byte word a row where aligned), then only the valid slots'
//    endpoints for area, length and bounds.  Then each thread walks its
//    own row's slots in order from shared memory.  A slot's position in a
//    row is XOR-swizzled by the row, so that the 32 threads reading slot
//    c of their rows hit every bank once.  Several resident blocks
//    overlap one block's copies with another's sums.
//  * a warp a geometry otherwise (few rows, or many slots): the lanes take
//    32 consecutive slots at a time, read their mask bytes and endpoints
//    (coalesced; predicated on the mask but for the centroid), compute
//    their slots' terms and put them in shared memory; lane q then adds
//    quantity q's 32 terms in slot order, carrying its sum to the next 32
//    slots.  Lane 0 gathers the sums and writes the row.
// Either mapping loads an (x, y) pair in one access where the pointer is
// aligned to it, else x and y apart (a view whose data pointer is offset
// by one coordinate); the mask word falls back to bytes the same way.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;               // a block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads;             // staged: a thread a row
constexpr int kChunk = 8;                   // staged: slots a copy stage
constexpr int kStagedSlots = 32;            // staged iff E <= this ...
constexpr long long kStagedRows = 32768;    // ... and G >= this

enum Measure { kArea = 0, kLength = 1, kCentroid = 2, kBounds = 3 };
enum Path { kStaged = 0, kWarp = 1 };

int plan(long long G, int E) {
  return (E <= kStagedSlots && G >= kStagedRows) ? kStaged : kWarp;
}

// quantities a slot adds to its row: area w; length l; centroid w, l,
// (a+b)w x and y, (0.5(a+b))l x and y, [a] x and y; bounds xmin, ymin,
// xmax, ymax
template <int M>
struct Terms {
  static constexpr int K = M == kCentroid ? 8 : M == kBounds ? 4 : 1;
};

template <typename T>
struct Guard;
template <>
struct Guard<float> {
  static __device__ float eps() { return 0.0f; }
  static __device__ float tiny() { return 1e-30f; }
};
template <>
struct Guard<double> {
  static __device__ double eps() { return 1e-300; }
  static __device__ double tiny() { return 1e-30; }
};

// IEEE square root and absolute value by type (sqrtf is correctly
// rounded without --use_fast_math)
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T keep_min(T m, T v) {
  return (v < m || v != v) ? v : m;
}

template <typename T>
__device__ __forceinline__ T keep_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

// the value each quantity starts from, and what a masked slot adds to
// area, length and bounds (the centroid reads every slot)
template <typename T, int M>
__device__ __forceinline__ T start(int q) {
  if (M == kBounds) return q < 2 ? T(INFINITY) : T(-INFINITY);
  return T(0);
}

// one step of quantity q's fold, in slot order
template <typename T, int M>
__device__ __forceinline__ T fold(int q, T s, T v) {
  if (M == kBounds) return q < 2 ? keep_min(s, v) : keep_max(s, v);
  return s + v;
}

// slot e's terms from its endpoints and mask bit, rounded step by step as
// the plain version rounds them
template <typename T, int M>
__device__ __forceinline__ void slot_terms(T ax, T ay, T bx, T by, bool m,
                                           T* t) {
  const T zero = T(0), half = T(0.5);
  if (M == kBounds) {
    t[0] = m ? keep_min(ax, bx) : start<T, M>(0);
    t[1] = m ? keep_min(ay, by) : start<T, M>(1);
    t[2] = m ? keep_max(ax, bx) : start<T, M>(2);
    t[3] = m ? keep_max(ay, by) : start<T, M>(3);
    return;
  }
  T w = zero, len = zero;
  if (M != kLength) w = m ? ax * by - ay * bx : zero;
  if (M != kArea) {
    const T dx = bx - ax, dy = by - ay;
    len = m ? root(dx * dx + dy * dy) : zero;
  }
  if (M == kArea) {
    t[0] = w;
  } else if (M == kLength) {
    t[0] = len;
  } else {
    t[0] = w;
    t[1] = len;
    t[2] = (ax + bx) * w;
    t[3] = (ay + by) * w;
    t[4] = half * (ax + bx) * len;
    t[5] = half * (ay + by) * len;
    t[6] = m ? ax : zero;
    t[7] = m ? ay : zero;
  }
}

// an (x, y) pair as one access
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// the row's result from its folded quantities and valid slot count; out
// is aligned to an (x, y) pair, so each pair of a row goes out in one store
template <typename T, int M>
__device__ __forceinline__ void finish(const T* s, int n, T* __restrict__ out,
                                       long long g) {
  using P = typename Pair<T>::type;
  const T zero = T(0), half = T(0.5);
  if (M == kArea) {
    const T v = half * s[0];
    out[g] = (v > zero || v != v) ? v : zero;
  } else if (M == kLength) {
    out[g] = s[0];
  } else if (M == kBounds) {
    P* o = reinterpret_cast<P*>(out + 4 * g);
    o[0] = P{s[0], s[1]};
    o[1] = P{s[2], s[3]};
  } else {
    const T A = s[0], L = s[1];
    const T eps = Guard<T>::eps(), tiny = Guard<T>::tiny();
    T cx, cy;
    if (mag(A) > tiny) {
      const T d = T(3) * A + eps;
      cx = s[2] / d;
      cy = s[3] / d;
    } else if (L > tiny) {
      const T d = L + eps;
      cx = s[4] / d;
      cy = s[5] / d;
    } else {
      const T d = T(n) + eps;
      cx = s[6] / d;
      cy = s[7] / d;
    }
    *reinterpret_cast<P*>(out + 2 * g) = P{cx, cy};
  }
}

// ---- loads ---------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// copy slot p's (x, y) to dst: one copy where the pair is aligned to its
// size, else one a coordinate
template <typename T>
__device__ __forceinline__ void copy_slot(T* dst, const T* p, bool pair) {
  constexpr int kSize = (int)sizeof(T);
  if (pair) {
    cp_async<2 * kSize>(dst, p);
  } else {
    cp_async<kSize>(dst, p);
    cp_async<kSize>(dst + 1, p + 1);
  }
}

__device__ __forceinline__ void load_slot(const float* p, bool pair, float& x,
                                          float& y) {
  if (pair) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x = v.x;
    y = v.y;
  } else {
    x = __ldg(p);
    y = __ldg(p + 1);
  }
}

__device__ __forceinline__ void load_slot(const double* p, bool pair,
                                          double& x, double& y) {
  if (pair) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    x = v.x;
    y = v.y;
  } else {
    x = __ldg(p);
    y = __ldg(p + 1);
  }
}

// the mask bytes of w (<= 8) slots from p, slot c in byte c: one 8-byte
// load where aligned
__device__ __forceinline__ unsigned long long load_mask(
    const unsigned char* p, int w) {
  if (w == kChunk && ((uintptr_t)p & 7) == 0)
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  unsigned long long v = 0;
  for (int c = 0; c < w; ++c)
    v |= (unsigned long long)(__ldg(p + c) != 0) << (8 * c);
  return v;
}

// ---- staged tiles --------------------------------------------------------

// slot c of row r within the row's kChunk positions: every 8 rows (16-byte
// slots) or 16 rows (8-byte slots) reading one c cover all 32 banks
template <typename T>
__device__ __forceinline__ int swizzle(int r, int c) {
  return sizeof(T) == 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 7);
}

// this thread's share of the copies of slots [k0, k0 + w) of the tile's
// R rows from g0: a thread copies slot c = t % kChunk of the rows
// t / kChunk + j * kThreads / kChunk, so a warp's copies are 4 rows' runs
// of consecutive bytes, and c's swizzled place is one for all its rows;
// ALL copies every slot, else only the slots whose mask byte in msk is set
template <typename T, bool ALL>
__device__ __forceinline__ void copy_chunk(
    const T* __restrict__ a, const T* __restrict__ b, long long g0, int R,
    int E, int k0, int w, bool pair, T (*ends)[kRows][kChunk][2],
    const unsigned long long* msk) {
  constexpr int kStep = kThreads / kChunk;    // rows between a thread's
  const int c = threadIdx.x % kChunk, r0 = threadIdx.x / kChunk;
  if (c >= w) return;
  const long long first = 2 * ((g0 + r0) * E + k0 + c);
  const long long step = 2LL * kStep * E;
  const int p = swizzle<T>(r0, c);            // swizzle(r0 + kStep j, c)
#pragma unroll
  for (int j = 0; j < kRows / kStep; ++j) {
    const int r = r0 + j * kStep;
    if (r >= R) break;
    if (!ALL && !((msk[r] >> (8 * c)) & 0xff)) continue;
    copy_slot(ends[0][r][p], a + first + j * step, pair);
    copy_slot(ends[1][r][p], b + first + j * step, pair);
  }
}

// staged: the resident blocks an SM the registers must leave room for (the
// shared memory takes 6 blocks of float64 and 12 of float32)
template <typename T>
struct StagedBlocks {
  static constexpr int value = sizeof(T) == 8 ? 6 : 8;
};

template <typename T, int M>
__global__ void __launch_bounds__(kThreads, StagedBlocks<T>::value)
    measures_staged_kernel(const T* __restrict__ a,
                           const T* __restrict__ b,
                           const unsigned char* __restrict__ mask,
                           long long G, int E, bool pair,
                           T* __restrict__ out) {
  constexpr int K = Terms<M>::K;
  __shared__ __align__(16) T ends[2][kRows][kChunk][2];
  __shared__ unsigned long long msk[kRows];
  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * kRows;
  const int R = (int)min((long long)kRows, G - g0);
  T s[K];
#pragma unroll
  for (int q = 0; q < K; ++q) s[q] = start<T, M>(q);
  int n = 0;
  for (int k0 = 0; k0 < E; k0 += kChunk) {
    const int w = min(kChunk, E - k0);
    if (M == kCentroid) {
      // every slot: the copies go out before the mask word is waited on
      copy_chunk<T, true>(a, b, g0, R, E, k0, w, pair, ends, msk);
      if (t < R) msk[t] = load_mask(mask + (g0 + t) * E + k0, w);
    } else {
      // only the valid slots: the mask first
      if (t < R) msk[t] = load_mask(mask + (g0 + t) * E + k0, w);
      __syncthreads();
      copy_chunk<T, false>(a, b, g0, R, E, k0, w, pair, ends, msk);
    }
    cp_async_commit_wait();
    __syncthreads();
    if (t < R) {
      const unsigned long long mw = msk[t];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c >= w) break;
        const bool m = (mw >> (8 * c)) & 0xff;
        n += m;
        T v[K];
        if (M != kCentroid && !m) {
#pragma unroll
          for (int q = 0; q < K; ++q) v[q] = start<T, M>(q);
        } else {
          using P = typename Pair<T>::type;
          const int p = swizzle<T>(t, c);
          const P pa = *reinterpret_cast<const P*>(ends[0][t][p]);
          const P pb = *reinterpret_cast<const P*>(ends[1][t][p]);
          slot_terms<T, M>(pa.x, pa.y, pb.x, pb.y, m, v);
        }
#pragma unroll
        for (int q = 0; q < K; ++q) s[q] = fold<T, M>(q, s[q], v[q]);
      }
    }
    __syncthreads();                  // the next chunk reuses the stage
  }
  if (t < R) finish<T, M>(s, n, out, g0 + t);
}

// ---- a warp a geometry ---------------------------------------------------

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    measures_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const unsigned char* __restrict__ mask, long long G,
                         int E, bool pair, T* __restrict__ out) {
  constexpr int K = Terms<M>::K;
  __shared__ T terms[kWarps][K][33];
  const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * kWarps + wq;
  if (g >= G) return;                 // the whole warp: no block barrier
  const T* ag = a + g * E * 2;
  const T* bg = b + g * E * 2;
  const unsigned char* mg = mask + g * E;
  T s = start<T, M>(lane < K ? lane : 0);     // lane q folds quantity q
  int n = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int cnt = min(32, E - e0);
    const int e = e0 + lane;
    const bool in = lane < cnt;
    const bool m = in && mg[e] != 0;
    T v[K];
    if (!in || (M != kCentroid && !m)) {
#pragma unroll
      for (int q = 0; q < K; ++q) v[q] = start<T, M>(q);
    } else {
      T ax, ay, bx, by;
      load_slot(ag + 2 * e, pair, ax, ay);
      load_slot(bg + 2 * e, pair, bx, by);
      slot_terms<T, M>(ax, ay, bx, by, m, v);
    }
#pragma unroll
    for (int q = 0; q < K; ++q) terms[wq][q][lane] = v[q];
    n += __popc(__ballot_sync(0xffffffffu, m));
    __syncwarp();
    if (lane < K)
      for (int j = 0; j < cnt; ++j) s = fold<T, M>(lane, s, terms[wq][lane][j]);
    __syncwarp();                     // the next 32 slots reuse the terms
  }
  T sums[K];
#pragma unroll
  for (int q = 0; q < K; ++q) sums[q] = __shfl_sync(0xffffffffu, s, q);
  if (lane == 0) finish<T, M>(sums, n, out, g);
}

template <typename T, int M>
void launch_measure(int path, const T* a, const T* b,
                    const unsigned char* mask, long long G, int E, bool pair,
                    T* out, cudaStream_t stream) {
  if (path == kStaged) {
    const unsigned blocks = (unsigned)((G + kRows - 1) / kRows);
    measures_staged_kernel<T, M><<<blocks, kThreads, 0, stream>>>(
        a, b, mask, G, E, pair, out);
  } else {
    const unsigned blocks = (unsigned)((G + kWarps - 1) / kWarps);
    measures_warp_kernel<T, M><<<blocks, kThreads, 0, stream>>>(
        a, b, mask, G, E, pair, out);
  }
}

template <typename T>
int launch(const T* a, const T* b, const bool* mask, long long G, int E,
           int what, int path, T* out, cudaStream_t stream) {
  if (G <= 0) return 0;
  if (E < 0 || (path != kStaged && path != kWarp)) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t size = 2 * sizeof(T);
  const bool pair = (uintptr_t)a % size == 0 && (uintptr_t)b % size == 0;
  if ((uintptr_t)out % size != 0) return (int)cudaErrorMisalignedAddress;
  const unsigned char* m = reinterpret_cast<const unsigned char*>(mask);
  switch (what) {
    case kArea:
      launch_measure<T, kArea>(path, a, b, m, G, E, pair, out, stream);
      break;
    case kLength:
      launch_measure<T, kLength>(path, a, b, m, G, E, pair, out, stream);
      break;
    case kCentroid:
      launch_measure<T, kCentroid>(path, a, b, m, G, E, pair, out,
                                   stream);
      break;
    case kBounds:
      launch_measure<T, kBounds>(path, a, b, m, G, E, pair, out, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b [G, E, 2] and out ([G], [G, 2] or [G, 4] as `what` is 0 area,
// 1 length, 2 centroid or 3 bounds) of one type, mask [G, E] bool, all
// contiguous on the device; a, b and mask of any alignment, out aligned to
// two of its values (as torch.empty gives it); the wrapper checks them.
// Launches on `stream`, by the mapping edge_measures_plan picks, and
// returns the launch's CUDA error.
int edge_measures_f32_launch(const float* a, const float* b,
                             const bool* mask, long long G, int E, int what,
                             float* out, void* stream) {
  return launch<float>(a, b, mask, G, E, what, plan(G, E), out,
                       (cudaStream_t)stream);
}

int edge_measures_f64_launch(const double* a, const double* b,
                             const bool* mask, long long G, int E, int what,
                             double* out, void* stream) {
  return launch<double>(a, b, mask, G, E, what, plan(G, E), out,
                        (cudaStream_t)stream);
}

// the same by the mapping `path` (0 staged tiles, 1 a warp a geometry),
// whatever G and E
int edge_measures_f32_launch_path(const float* a, const float* b,
                                  const bool* mask, long long G, int E,
                                  int what, int path, float* out,
                                  void* stream) {
  return launch<float>(a, b, mask, G, E, what, path, out,
                       (cudaStream_t)stream);
}

int edge_measures_f64_launch_path(const double* a, const double* b,
                                  const bool* mask, long long G, int E,
                                  int what, int path, double* out,
                                  void* stream) {
  return launch<double>(a, b, mask, G, E, what, path, out,
                        (cudaStream_t)stream);
}

// the mapping the launch picks for G rows of E slots
int edge_measures_plan(long long G, int E) { return plan(G, E); }

const char* edge_measures_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

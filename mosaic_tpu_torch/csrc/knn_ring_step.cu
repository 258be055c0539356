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
// after every equal entry, in (offset, j) order, which gives the same
// list; a bad candidate, (inf, -1), never enters a list that holds only
// numbers, so it is skipped.  A 1e9-padded pool point is not bad: it
// keeps its finite d2 (~2e18) and its live code, as in the reference.
// Every f32 step is one rounding in the reference's order (explicit _rn
// intrinsics, the build has -fmad=false), so the kernel equals the
// plain version bit for bit.  Rows are never skipped: the reference
// scans every row every ring.
//
// What bounds it on an H100: bytes.  A row reads its point, its seven
// window scalars and its list, and writes the list; each window entry
// and pool row the ring reaches is needed once.  The arithmetic, 5
// flops per pool point, is small.  The gathers set the pace: a warp
// whose 32 rows sit in unrelated cells pays a 32-byte sector for each
// 4-byte entry read, and each offset is a dependent mask -> offset ->
// entry -> pool chain.  Design:
//   * rows in lattice order: thread t works on row t, and the caller
//     hands the rows over sorted by (face window, Morton(a, b)), so a
//     warp's rows share most of their ring cells and every per-row read
//     and write is coalesced (models/knn.py sorts its march's rows once a
//     transform; a thread per row in any other order is still right);
//   * the offsets go kUnroll at a time: two offsets a 16-byte load and
//     four mask bytes a load (uniform across the warp, so each one L1
//     wavefront), then kUnroll branch-free entry lookups (an index past
//     the offsets or off the window reads a valid address and is
//     dropped), all in flight together; then their pool rows, in order;
//   * the list tiers: registers up to k + 1 = 64 (KMAX the smallest of
//     8, 16, 32, 64 that holds it; positions past k + 1 start at (inf,
//     -1) and are not written back: a candidate that reaches them never
//     moves up again, so the first k + 1 are the reference's list);
//     past 64, in shared memory (128 rows a block, entry t of row r at
//     [t * 128 + r]) while the block's lists fit its 227 KB; past that,
//     in global memory, in place in the output row.
// Staging each block's entry sub-window in shared memory was built and
// measured: with the rows in lattice order it gained nothing over the
// read-only cache (PERF.md), so the entries are read from global
// memory.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRegThreads = 256;         // rows per block, register lists
constexpr int kMemThreads = 128;         // rows per block, memory lists
constexpr int kSmemMax = 232448;         // dynamic shared memory a block gets
constexpr int kUnroll = 4;               // offsets looked up together
static_assert(kUnroll % 4 == 0, "offsets go 2 and mask bytes 4 a load");

struct Row {
  const float2* pts;
  const int *al, *bl, *a0r, *b0r, *wr, *hr, *eoffr;
};

struct Ring {
  const int* entry;
  const float2* pool;
  const int2* offs;
  const unsigned char* omask;
  int n_off, cap;
  float thr2;
};

// the running list in registers
template <int KMAX>
struct RegList {
  float L[KMAX];
  int C[KMAX];

  __device__ __forceinline__ void load(const float* d, const int* c,
                                       int k1) {
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      L[t] = t < k1 ? d[t] : INFINITY;
      C[t] = t < k1 ? c[t] : -1;
    }
  }
  __device__ __forceinline__ void offer(float d, int code, float thr2) {
    if (d > thr2 || !(d < L[KMAX - 1])) return;
    L[KMAX - 1] = d;
    C[KMAX - 1] = code;
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
  __device__ __forceinline__ void store(float* d, int* c, int k1) const {
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (t < k1) {
        d[t] = L[t];
        c[t] = C[t];
      }
    }
  }
};

// the running list in memory, entry t at [t * stride]: shared memory or
// the output row itself
struct MemList {
  float* L;
  int* C;
  int stride, k1;
  float tail;

  __device__ __forceinline__ void offer(float d, int code, float thr2) {
    if (d > thr2 || !(d < tail)) return;
    int t = k1 - 1;
    while (t > 0) {
      const float prev = L[(t - 1) * stride];
      if (!(prev > d)) break;            // equal entries stay before
      L[t * stride] = prev;
      C[t * stride] = C[(t - 1) * stride];
      --t;
    }
    L[t * stride] = d;
    C[t * stride] = code;
    tail = L[(k1 - 1) * stride];
  }
};

template <class List>
__device__ __forceinline__ void scan_ring(const Ring& ring, float2 p, int a,
                                          int b, int w, int h, int eoff,
                                          List& list) {
  const int cap = ring.cap;
  for (int o0 = 0; o0 < ring.n_off; o0 += kUnroll) {
    // kUnroll lookups with no branch between them, so their loads are in
    // flight together: an index past the offsets or off the window reads
    // a valid address and is then dropped
    int2 off[kUnroll];
    bool on[kUnroll];
    if (o0 + kUnroll <= ring.n_off) {
      // a whole group: two offsets a 16-byte load, four mask bytes a load
#pragma unroll
      for (int u = 0; u < kUnroll; u += 2) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(ring.offs) +
                             (o0 + u) / 2);
        off[u] = make_int2(v.x, v.y);
        off[u + 1] = make_int2(v.z, v.w);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; u += 4) {
        const uchar4 mk = __ldg(reinterpret_cast<const uchar4*>(ring.omask) +
                                (o0 + u) / 4);
        on[u] = mk.x;
        on[u + 1] = mk.y;
        on[u + 2] = mk.z;
        on[u + 3] = mk.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int o = min(o0 + u, ring.n_off - 1);
        off[u] = __ldg(ring.offs + o);
        on[u] = o0 + u < ring.n_off && __ldg(ring.omask + o);
      }
    }
    int slot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ia = a + off[u].x;
      const int ib = b + off[u].y;
      const bool in = on[u] && ia >= 0 && ia < w && ib >= 0 && ib < h;
      const int e = __ldg(ring.entry + (in ? eoff + ia * h + ib : 0));
      slot[u] = in ? e : -1;
    }
    // their candidates in (offset, j) order
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (slot[u] < 0) continue;
      const float2* q = ring.pool + (long long)slot[u] * cap;
      for (int j = 0; j < cap; ++j) {
        const float2 r = __ldg(q + j);
        const float dx = __fsub_rn(r.x, p.x);
        const float dy = __fsub_rn(r.y, p.y);
        list.offer(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   slot[u] * cap + j, ring.thr2);
      }
    }
  }
}

// KMAX > 0: register lists; KMAX == 0: memory lists, in shared memory
// when list_in_smem, else in the output rows
template <int KMAX>
__global__ void __launch_bounds__(KMAX > 0 ? kRegThreads : kMemThreads)
    ring_kernel(Ring ring, Row rows, long long n,
                const float* __restrict__ top_d2_in,
                const int* __restrict__ top_code_in,
                float* __restrict__ top_d2_out,
                int* __restrict__ top_code_out, int k1, int list_in_smem) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float2 p = rows.pts[row];
  const int a = rows.al[row] - rows.a0r[row];
  const int b = rows.bl[row] - rows.b0r[row];
  const int w = rows.wr[row], h = rows.hr[row], eoff = rows.eoffr[row];
  const float* d_in = top_d2_in + row * k1;
  const int* c_in = top_code_in + row * k1;
  float* d_out = top_d2_out + row * k1;
  int* c_out = top_code_out + row * k1;
  if constexpr (KMAX > 0) {
    RegList<KMAX> list;
    list.load(d_in, c_in, k1);
    scan_ring(ring, p, a, b, w, h, eoff, list);
    list.store(d_out, c_out, k1);
  } else {
    extern __shared__ float lists_sh[];  // [k1][blockDim] d, then codes
    MemList list;
    list.k1 = k1;
    if (list_in_smem) {
      list.L = lists_sh + threadIdx.x;
      list.C = reinterpret_cast<int*>(lists_sh + k1 * blockDim.x) +
               threadIdx.x;
      list.stride = blockDim.x;
    } else {
      list.L = d_out;
      list.C = c_out;
      list.stride = 1;
    }
    for (int i = 0; i < k1; ++i) {
      list.L[i * list.stride] = d_in[i];
      list.C[i * list.stride] = c_in[i];
    }
    list.tail = list.L[(k1 - 1) * list.stride];
    scan_ring(ring, p, a, b, w, h, eoff, list);
    if (list_in_smem) {
      for (int i = 0; i < k1; ++i) {
        d_out[i] = list.L[i * list.stride];
        c_out[i] = list.C[i * list.stride];
      }
    }
  }
}

template <int KMAX>
int launch(const Ring& ring, const Row& rows, long long n,
           const float* td_in, const int* tc_in, float* td_out, int* tc_out,
           int k1, cudaStream_t stream) {
  const int threads = KMAX > 0 ? kRegThreads : kMemThreads;
  size_t smem = 0;
  int list_in_smem = 0;
  if (KMAX == 0) {
    const size_t lists = (size_t)kMemThreads * k1 * 8;
    list_in_smem = lists <= (size_t)kSmemMax;
    if (list_in_smem) {
      smem = lists;
      const cudaError_t e = cudaFuncSetAttribute(
          ring_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  const long long blocks = (n + threads - 1) / threads;
  ring_kernel<KMAX><<<(unsigned)blocks, threads, smem, stream>>>(
      ring, rows, n, td_in, tc_in, td_out, tc_out, k1, list_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// entry [E] i32; pool [C, cap, 2] f32; pts [n, 2] f32 (face-origin
// local); al, bl, a0r, b0r, wr, hr, eoffr [n] i32; top_d2_in/out
// [n, k1] f32 and top_code_in/out [n, k1] i32 (in and out distinct);
// offs [n_off, 2] i32 and omask [n_off] u8; all on the device, pts and
// pool 8-byte, offs 16-byte and omask 4-byte aligned.  k1 >= 1 (the
// wrapper checks).  Launches on `stream` and returns the launch's CUDA
// error.
int knn_ring_step_launch(const int* entry, const float* pool,
                         const float* pts, const int* al, const int* bl,
                         const int* a0r, const int* b0r, const int* wr,
                         const int* hr, const int* eoffr, long long n,
                         const float* top_d2_in, const int* top_code_in,
                         float* top_d2_out, int* top_code_out, const int* offs,
                         const unsigned char* omask, int n_off, int cap,
                         int k1, float thr2, void* stream) {
  if (n <= 0) return 0;
  const Row rows{reinterpret_cast<const float2*>(pts), al, bl, a0r, b0r,
                 wr, hr, eoffr};
  const Ring ring{entry, reinterpret_cast<const float2*>(pool),
                  reinterpret_cast<const int2*>(offs), omask, n_off, cap,
                  thr2};
  cudaStream_t s = (cudaStream_t)stream;
  if (k1 <= 8)
    return launch<8>(ring, rows, n, top_d2_in, top_code_in, top_d2_out,
                     top_code_out, k1, s);
  if (k1 <= 16)
    return launch<16>(ring, rows, n, top_d2_in, top_code_in,
                      top_d2_out, top_code_out, k1, s);
  if (k1 <= 32)
    return launch<32>(ring, rows, n, top_d2_in, top_code_in,
                      top_d2_out, top_code_out, k1, s);
  if (k1 <= 64)
    return launch<64>(ring, rows, n, top_d2_in, top_code_in,
                      top_d2_out, top_code_out, k1, s);
  return launch<0>(ring, rows, n, top_d2_in, top_code_in, top_d2_out,
                   top_code_out, k1, s);
}

const char* knn_ring_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// The fused SQL operator group for Hopper (sm_90a): K14.  One launch runs
// a fusion group's WHERE mask and its projections or aggregates over every
// row, interpreting the group's typed register program row by row.
//
// Replaces the XLA program of the JAX package's whole-query fusion,
// mosaic_tpu/perf/fusion.py:555 _build_program (body :563-579, run at
// :629-641): one jitted program per (fusion group, pow2 row bucket) that
// computes the row mask, then either the projected columns or the scalar
// aggregates, with only the group's outputs crossing back to the host.  The
// port builds nothing at run time, so the group is not compiled: the host
// encodes it once into a small typed program (perf/fusion.py encode_group,
// ops/fused_group.py) and this fixed kernel interprets it.  The plain
// PyTorch version is ops/fused_group.py fused_group_ref.
//
// Input: one byte buffer, copied to the card in one piece:
//   header (int64 words; the layout is ops/fused_group.py's HDR_*):
//     [0] instructions  [1] columns  [2] terminal (0 project, 1 aggregate)
//     [3] mask register (-1: no WHERE)  [4] outputs (items or specs)
//     [5] state word    [6] header words
//     then per column (byte offset, dtype), per instruction (op, dtype, a,
//     b, imm), per output 4 words: a project item (register, dtype, out
//     byte offset, 0), an aggregate spec (kind, register, dtype, out word);
//   state (uint64 words, initialised by the host): [0] passing rows,
//     [1] blocks done, then per spec (accumulator, count, first row);
//   the referenced columns, padded to the bucket, at 8-byte aligned offsets.
// Output: one byte buffer, fetched in one piece: a project group writes
// [rows passing][mask: bucket bytes][each item: bucket values], an
// aggregate group [rows passing][per spec: 1 or 2 words] in the order of
// the JAX program's outputs.
//
// Registers are 64-bit words, one per instruction: bool 0/1, integers
// sign-extended int64, float16 and float32 as float bits, float64 as double
// bits.  Integer arithmetic is done in uint64 and truncated to the width of
// the node's dtype (signed overflow is undefined in C++, and numpy and XLA
// wrap).  Float arithmetic is one correctly rounded operation per node
// (__fadd_rn and friends; the build also has -fmad=false, so x * 2 + 1 is
// two roundings, as numpy does it); float16 rounds through float32, which
// is exact for + - * /.
//
// Aggregates: a thread per row (grid-stride) keeps its partials, a warp
// reduces them by shuffles, and lane 0 adds them with one atomic each.
// Counts and integer sums are uint64 adds (exact: the host admits a sum
// only below 2^53).  Minima and maxima are signed 64-bit atomics, of the
// value for integers and of an order key for floats: the double's bits,
// with a negative double's magnitude bits inverted, so that -0.0 sorts
// below +0.0 as XLA's min and max order them; rows where the value is NaN
// do not take part.  first() is the value at the least passing row: an
// atomicMin of the row index, and the last block to finish reads that
// row's value, so the result never depends on which atomic lands first.
//
// What bounds it on an H100: its bytes.  Each referenced column is read
// once (the bucket's rows), each output written once.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRegs = 128;
constexpr int kMaxSpecs = 32;
// first()'s row before any row passed (the host initialises the state so)
constexpr long long kNoRow = 0x7fffffffffffffffll;

// ops/fused_group.py DTYPES
enum DType { kBool = 0, kI8, kI16, kI32, kI64, kF16, kF32, kF64 };
// ops/fused_group.py OPS
enum Op {
  kLoad = 0, kConst, kCast, kAdd, kSub, kMul, kDiv, kNeg,
  kEq, kNe, kLt, kLe, kGt, kGe, kAnd, kOr, kNot, kIsNan, kMask
};
// ops/fused_group.py AGG_KINDS
enum Agg { kCountStar = 0, kCount, kSum, kAvg, kMin, kMax, kFirst };

enum Hdr { kHInstr = 0, kHCols, kHTerminal, kHMask, kHOuts, kHState,
           kHWords, kHFixed = 8 };

typedef unsigned long long u64;

__device__ __forceinline__ bool is_float(int dt) { return dt >= kF16; }

__device__ __forceinline__ float as_f32(u64 v) {
  return __uint_as_float((unsigned)v);
}
__device__ __forceinline__ u64 of_f32(float f) {
  return (u64)__float_as_uint(f);
}
__device__ __forceinline__ double as_f64(u64 v) {
  return __longlong_as_double((long long)v);
}
__device__ __forceinline__ u64 of_f64(double d) {
  return (u64)__double_as_longlong(d);
}

// an integer result truncated to dt's width, sign-extended
__device__ __forceinline__ u64 wrap(u64 v, int dt) {
  switch (dt) {
    case kBool: return v & 1ull;
    case kI8: return (u64)(long long)(signed char)(unsigned char)v;
    case kI16: return (u64)(long long)(short)(unsigned short)v;
    case kI32: return (u64)(long long)(int)(unsigned)v;
    default: return v;
  }
}

// a float16 value held as float bits, rounded to float16 and back
__device__ __forceinline__ float to_half(float f) {
  return __half2float(__float2half_rn(f));
}

// a float register widened to double (exact)
__device__ __forceinline__ double fval(u64 v, int dt) {
  return dt == kF64 ? as_f64(v) : (double)as_f32(v);
}

__device__ __forceinline__ u64 load(const unsigned char* col, int dt,
                                    long long row) {
  switch (dt) {
    case kBool: return col[row] ? 1ull : 0ull;
    case kI8: return (u64)(long long)((const signed char*)col)[row];
    case kI16: return (u64)(long long)((const short*)col)[row];
    case kI32: return (u64)(long long)((const int*)col)[row];
    case kI64: return (u64)((const long long*)col)[row];
    case kF16: return of_f32(__half2float(((const __half*)col)[row]));
    case kF32: return of_f32(((const float*)col)[row]);
    default: return (u64)((const long long*)col)[row];
  }
}

__device__ __forceinline__ void store(unsigned char* col, int dt,
                                      long long row, u64 v) {
  switch (dt) {
    case kBool: col[row] = (unsigned char)(v & 1ull); break;
    case kI8: ((signed char*)col)[row] = (signed char)v; break;
    case kI16: ((short*)col)[row] = (short)v; break;
    case kI32: ((int*)col)[row] = (int)v; break;
    case kF16: ((__half*)col)[row] = __float2half_rn(as_f32(v)); break;
    case kF32: ((unsigned*)col)[row] = (unsigned)v; break;
    default: ((u64*)col)[row] = v; break;
  }
}

__device__ __forceinline__ u64 cast(u64 v, int from, int to) {
  if (!is_float(from)) {
    const long long i = (long long)v;
    if (to == kF64) return of_f64(__ll2double_rn(i));
    if (to == kF32) return of_f32(__ll2float_rn(i));
    if (to == kF16) return of_f32(to_half(__ll2float_rn(i)));
    return wrap(v, to);
  }
  const double d = fval(v, from);
  if (to == kF64) return of_f64(d);
  if (to == kF32) return of_f32(__double2float_rn(d));
  if (to == kF16) return of_f32(to_half(__double2float_rn(d)));
  return wrap((u64)__double2ll_rz(d), to);
}

__device__ __forceinline__ u64 arith(int op, int dt, u64 a, u64 b) {
  if (!is_float(dt)) {
    u64 r;
    switch (op) {
      case kAdd: r = a + b; break;
      case kSub: r = a - b; break;
      case kMul: r = a * b; break;
      default: r = 0ull - a; break;  // kNeg
    }
    return wrap(r, dt);
  }
  if (op == kNeg) return dt == kF64 ? a ^ 0x8000000000000000ull
                                    : a ^ 0x80000000ull;
  if (dt == kF64) {
    const double x = as_f64(a), y = as_f64(b);
    switch (op) {
      case kAdd: return of_f64(__dadd_rn(x, y));
      case kSub: return of_f64(__dsub_rn(x, y));
      case kMul: return of_f64(__dmul_rn(x, y));
      default: return of_f64(__ddiv_rn(x, y));
    }
  }
  const float x = as_f32(a), y = as_f32(b);
  float r;
  switch (op) {
    case kAdd: r = __fadd_rn(x, y); break;
    case kSub: r = __fsub_rn(x, y); break;
    case kMul: r = __fmul_rn(x, y); break;
    default: r = __fdiv_rn(x, y); break;
  }
  return of_f32(dt == kF16 ? to_half(r) : r);
}

__device__ __forceinline__ u64 compare(int op, int dt, u64 a, u64 b) {
  bool r;
  if (is_float(dt)) {
    const double x = fval(a, dt), y = fval(b, dt);
    switch (op) {
      case kEq: r = x == y; break;
      case kNe: r = x != y; break;
      case kLt: r = x < y; break;
      case kLe: r = x <= y; break;
      case kGt: r = x > y; break;
      default: r = x >= y; break;
    }
  } else {
    const long long x = (long long)a, y = (long long)b;
    switch (op) {
      case kEq: r = x == y; break;
      case kNe: r = x != y; break;
      case kLt: r = x < y; break;
      case kLe: r = x <= y; break;
      case kGt: r = x > y; break;
      default: r = x >= y; break;
    }
  }
  return r ? 1ull : 0ull;
}

// the program over one row; regs[i] is instruction i's value
__device__ void run(const long long* hdr, const unsigned char* in,
                    long long row, u64* regs) {
  const int ni = (int)hdr[kHInstr];
  const long long* cols = hdr + kHFixed;
  const long long* ins = cols + 2 * hdr[kHCols];
  for (int i = 0; i < ni; ++i) {
    const long long* w = ins + 5 * i;
    const int op = (int)w[0], dt = (int)w[1];
    const int a = (int)w[2], b = (int)w[3];
    u64 v;
    switch (op) {
      case kLoad: v = load(in + cols[2 * a], (int)cols[2 * a + 1], row);
        break;
      case kConst:
        v = is_float(dt) ? (dt == kF64 ? (u64)w[4]
                                       : of_f32((float)as_f64((u64)w[4])))
                         : (u64)w[4];
        break;
      case kCast: v = cast(regs[a], b, dt); break;
      case kAdd: case kSub: case kMul: case kDiv:
        v = arith(op, dt, regs[a], regs[b]);
        break;
      case kNeg: v = arith(op, dt, regs[a], 0ull); break;
      case kEq: case kNe: case kLt: case kLe: case kGt: case kGe:
        v = compare(op, dt, regs[a], regs[b]);
        break;
      case kAnd: v = regs[a] & regs[b] & 1ull; break;
      case kOr: v = (regs[a] | regs[b]) & 1ull; break;
      case kNot: v = (regs[a] & 1ull) ^ 1ull; break;
      case kIsNan: v = is_float(dt) && isnan(fval(regs[a], dt)) ? 1ull : 0ull;
        break;
      default:  // kMask: NaN is true, as numpy's astype(bool)
        v = is_float(dt) ? (fval(regs[a], dt) != 0.0 ? 1ull : 0ull)
                         : (regs[a] != 0ull ? 1ull : 0ull);
        break;
    }
    regs[i] = v;
  }
}

// the signed order key of a float register (see the head of this file)
__device__ __forceinline__ long long fkey(u64 v, int dt) {
  const long long b = __double_as_longlong(fval(v, dt));
  return b < 0 ? b ^ 0x7fffffffffffffffll : b;
}
__device__ __forceinline__ u64 unkey(long long k) {
  return (u64)(k < 0 ? k ^ 0x7fffffffffffffffll : k);
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = 16; o; o >>= 1) {
    const long long w = __shfl_down_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}
__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o; o >>= 1) {
    const long long w = __shfl_down_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    fused_group_kernel(unsigned char* in, long long n, long long bucket,
                       unsigned char* out) {
  extern __shared__ long long hdr[];
  const long long* g = (const long long*)in;
  const int words = (int)g[kHWords];
  for (int i = threadIdx.x; i < words; i += kThreads) hdr[i] = g[i];
  __syncthreads();
  u64* state = (u64*)in + hdr[kHState];
  const bool project = hdr[kHTerminal] == 0;
  const int mreg = (int)hdr[kHMask];
  const int nout = (int)hdr[kHOuts];
  const long long* outs = hdr + kHFixed + 2 * hdr[kHCols] + 5 * hdr[kHInstr];
  const long long stride = (long long)gridDim.x * kThreads;
  u64 regs[kMaxRegs];
  u64 passed = 0;
  u64 acc[kMaxSpecs], cnt[kMaxSpecs];
  long long first[kMaxSpecs];
  if (!project) {
    for (int s = 0; s < nout; ++s) {
      // the identity of the spec's reduction (never the state words:
      // blocks that finished early have added into them already)
      const int kind = (int)outs[4 * s];
      acc[s] = kind == kMin ? (u64)kNoRow
             : kind == kMax ? (u64)(-kNoRow - 1) : 0ull;
      cnt[s] = 0;
      first[s] = kNoRow;
    }
  }
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
       row < bucket; row += stride) {
    if (row >= n) {                    // the bucket's padding never counts
      if (project) {
        out[8 + row] = 0;
        for (int j = 0; j < nout; ++j) {
          const long long* o = outs + 4 * j;
          store(out + o[2], (int)o[1], row, 0ull);
        }
      }
      continue;
    }
    run(hdr, in, row, regs);
    const bool m = mreg < 0 || (regs[mreg] & 1ull);
    passed += m;
    if (project) {
      out[8 + row] = m;
      for (int j = 0; j < nout; ++j) {
        const long long* o = outs + 4 * j;
        store(out + o[2], (int)o[1], row, regs[o[0]]);
      }
      continue;
    }
    if (!m) continue;
    for (int s = 0; s < nout; ++s) {
      const long long* o = outs + 4 * s;
      const int kind = (int)o[0], dt = (int)o[2];
      if (kind == kCountStar) continue;
      const u64 v = regs[o[1]];
      if (is_float(dt) && isnan(fval(v, dt))) continue;  // not ok
      ++cnt[s];
      switch (kind) {
        case kSum: case kAvg: acc[s] += v; break;
        case kMin: case kMax: {
          const long long k = is_float(dt) ? fkey(v, dt) : (long long)v;
          const long long c = (long long)acc[s];
          if (kind == kMin ? k < c : k > c) acc[s] = (u64)k;
          break;
        }
        case kFirst: if (row < first[s]) first[s] = row; break;
        default: break;
      }
    }
  }
  // warp, then one atomic a warp
  const bool lead = (threadIdx.x & 31) == 0;
  passed = warp_sum(passed);
  if (lead && passed) atomicAdd(&state[0], passed);
  if (!project) {
    for (int s = 0; s < nout; ++s) {
      const long long* o = outs + 4 * s;
      const int kind = (int)o[0];
      if (kind == kCountStar) continue;
      u64* st = state + 2 + 3 * s;
      const u64 c = warp_sum(cnt[s]);
      if (lead && c) atomicAdd(&st[1], c);
      if (kind == kSum || kind == kAvg) {
        const u64 a = warp_sum(acc[s]);
        if (lead && c) atomicAdd(&st[0], a);
      } else if (kind == kMin) {
        const long long a = warp_min((long long)acc[s]);
        if (lead && c) atomicMin((long long*)&st[0], a);
      } else if (kind == kMax) {
        const long long a = warp_max((long long)acc[s]);
        if (lead && c) atomicMax((long long*)&st[0], a);
      } else if (kind == kFirst) {
        const long long f = warp_min(first[s]);
        if (lead && c) atomicMin(&st[2], (u64)f);
      }
    }
  }
  if (lead) __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) {
    last = atomicAdd(&state[1], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  // the last block: every other block's atomics are visible
  volatile u64* vs = state;
  const u64 total = vs[0];
  ((u64*)out)[0] = total;
  if (project) return;
  u64* ow = (u64*)out;
  for (int s = 0; s < nout; ++s) {
    const long long* o = outs + 4 * s;
    const int kind = (int)o[0], dt = (int)o[2];
    const long long w = o[3];
    volatile u64* st = vs + 2 + 3 * s;
    if (kind == kCountStar) {
      ow[w] = total;
      continue;
    }
    const u64 c = st[1];
    if (kind == kCount) {
      ow[w] = c;
      continue;
    }
    u64 v = st[0];
    if (kind == kMin || kind == kMax) {
      v = is_float(dt) ? unkey((long long)v) : v;
    } else if (kind == kFirst) {
      const u64 f = st[2];
      v = 0ull;
      if (c && f != (u64)kNoRow) {
        run(hdr, in, (long long)f, regs);
        const u64 r = regs[o[1]];
        v = is_float(dt) ? of_f64(fval(r, dt)) : r;
      }
    }
    ow[w] = v;
    ow[w + 1] = c;
  }
}

}  // namespace

extern "C" {

// in: the packed input buffer on the device (header, state, columns; see
// the head of this file), n live rows of a bucket of `bucket` rows, out the
// output buffer; `blocks` blocks of 256 threads, the header in `hdr_bytes`
// of dynamic shared memory.  Returns the launch's CUDA error.
int fused_group_launch(void* in, long long n, long long bucket, void* out,
                       int blocks, int hdr_bytes, void* stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  if (hdr_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        hdr_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  fused_group_kernel<<<blocks, kThreads, hdr_bytes, (cudaStream_t)stream>>>(
      (unsigned char*)in, n, bucket, (unsigned char*)out);
  return (int)cudaGetLastError();
}

int fused_group_limits(int which) {
  return which == 0 ? kMaxRegs : which == 1 ? kMaxSpecs : kThreads;
}

const char* fused_group_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

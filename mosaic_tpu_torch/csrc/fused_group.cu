// The fused SQL operator group for Hopper (sm_90a): K14.  One launch runs
// a fusion group's WHERE mask and its projections or aggregates over every
// row, interpreting the group's typed register program a tile of rows at a
// time.
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
//     [5] state word  [6] header words  [7] tile rows T  [8] stages
//     [9] slots  [10] dynamic shared memory bytes  [11] bytes a stage
//     [12-15] the decoded program's, specs', partials' and staged
//     columns' first bytes in shared memory
//     then per column (byte offset, dtype, stage byte offset or -1), per
//     instruction (op, dtype, a, b, imm), per output 4 words: a project
//     item (register, dtype, out byte offset, 0), an aggregate spec (kind,
//     register, dtype, out word); then the plan, one word an instruction:
//     where its value lives in shared memory (see Loc below);
//   state (uint64 words, initialised by the host): [0] passing rows,
//     [1] blocks done, then per spec (accumulator, count, first row);
//   the referenced columns, padded to the bucket, at 16-byte aligned
//   offsets.
// Output: one byte buffer, fetched in one piece: a project group writes
// [rows passing][mask: bucket bytes][each item: bucket values, 16-byte
// aligned], an aggregate group [rows passing][per spec: 1 or 2 words] in
// the order of the JAX program's outputs.  Scratch (an aggregate group
// with a first() spec): a word a (spec, block) past the output words.
//
// Values are 64-bit words: bool 0/1, integers sign-extended int64, float16
// and float32 as float bits, float64 as double bits.  Integer arithmetic is
// done in uint64 and truncated to the width of the node's dtype (signed
// overflow is undefined in C++, and numpy and XLA wrap).  Float arithmetic
// is one correctly rounded operation per node (__fadd_rn and friends; the
// build also has -fmad=false, so x * 2 + 1 is two roundings, as numpy does
// it); float16 rounds through float32, which is exact for + - * /.
//
// The design, against what bounds it on an H100 (its bytes: each
// referenced column read once, each output written once):
// - Registers live in shared memory, allotted on the host
//   (ops/fused_group.py plan_program): each instruction's value is one of
//   P slot tiles [T] of 64-bit words, struct of arrays (consecutive rows on
//   consecutive words, no bank conflicts), a slot free again after its
//   last reader.  A constant is one word read at stride 0; a column of
//   int64 or float64 is read in place from its staged tile.  Nothing is
//   indexed at run time in a thread's own memory: no local memory.
// - Decode once a tile: the block decodes the program once, keeping the
//   instructions that run a loop (a constant is written once, a column
//   read in place needs none); persistent blocks walk tiles of T rows; for
//   each instruction a block-uniform switch on (op, dtype) picks a loop
//   compiled for that pair, each thread over its row pairs 2 * (tid + k
//   * 256) and the row after (16-byte shared loads and stores).  Every
//   loop maps rows to threads the same way, so an instruction reads what
//   the same thread wrote: no barrier between instructions.
// - Column tiles staged ahead: each referenced column's slice of the next
//   tile is copied into shared memory by bulk copies (cp.async.bulk, TMA,
//   completion on an mbarrier), in a ring of up to three stages, so the
//   next tiles' bytes are in flight while this one is interpreted (a
//   program too large for two stages takes one).  Bulk copies move
//   16-byte multiples; the bytes past the last multiple of a tile (narrow
//   columns, odd n) are read by threads.  Nothing is read past n.
// - Reductions: a thread's passing rows are a bit word; each spec reads
//   every live row's value (the reads wait on nothing) and takes the
//   passing ones in registers, then the warp reduces them
//   (__reduce_*_sync) into the warp's partials in shared memory, which its
//   lane 0 alone writes; at the end the block adds its warps' partials
//   and makes one atomic a spec.  A spec with the reduction and register
//   of an earlier one (avg is sum's) shares its partials.  Counts and
//   integer sums are uint64 adds (exact: the host admits a sum only below
//   2^53).  Minima and maxima are signed 64-bit atomics, of the value for
//   integers and of an order key for floats: the double's bits, with a
//   negative double's magnitude bits inverted, so that -0.0 sorts below
//   +0.0 as XLA's min and max order them; rows where the value is NaN do
//   not take part.  first() is the value at the least passing row: an
//   atomicMin of the row; each warp keeps the value at its own least row
//   (a block's tiles come in row order), each block its warps' least in
//   scratch, and the last block to finish reads the winner's, the block
//   that owned that row's tile, so the result never depends on which
//   atomic lands first.
// - Projection: the mask goes out as 8-byte stores of a warp's ballot, each
//   item with 16-byte stores; padding rows n..bucket are zeros.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRegs = 128;
constexpr int kMaxSpecs = 32;
// a tile's rows at most: a thread's rows of a tile are bits of one word
constexpr int kMaxTile = 4096;
constexpr int kTileStep = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;  // a warp's lanes
// first()'s row before any row passed (the host initialises the state so)
constexpr long long kNoRow = 0x7fffffffffffffffll;

// ops/fused_group.py DTYPES
enum DType { kBool = 0, kI8, kI16, kI32, kI64, kF16, kF32, kF64 };
// ops/fused_group.py OPS; kNop marks a constant or an in-place column load
enum Op {
  kLoad = 0, kConst, kCast, kAdd, kSub, kMul, kDiv, kNeg,
  kEq, kNe, kLt, kLe, kGt, kGe, kAnd, kOr, kNot, kIsNan, kMask, kNop = 99
};
// ops/fused_group.py AGG_KINDS
enum Agg { kCountStar = 0, kCount, kSum, kAvg, kMin, kMax, kFirst };

enum Hdr { kHInstr = 0, kHCols, kHTerminal, kHMask, kHOuts, kHState,
           kHWords, kHTile, kHStages, kHSlots, kHSmem, kHStageBytes,
           kHCode, kHSpec, kHPart, kHStaged, kHFixed };

// A plan word (ops/fused_group.py LOC_*): the low 30 bits are the value's
// word offset in dynamic shared memory; kLocStage adds the stage in use
// (a column read in place), kLocConst reads one word for every row.
constexpr unsigned kLocStage = 1u << 30;
constexpr unsigned kLocConst = 1u << 31;
constexpr unsigned kLocOffset = kLocStage - 1;

// the front of dynamic shared memory (ops/fused_group.py front_layout):
// fixed, then sized by the program at the header's offsets (code, specs,
// per-warp partials, staged columns), then the slots
constexpr int kMaxStages = 3;
constexpr int kOffBar = 0;     // an mbarrier a stage
constexpr int kOffMisc = 32;   // passing rows, last, instructions run,
                               // staged columns
constexpr int kOffConst = 64;  // a word a register
// what a block may take (227 KB of the SM's 228)
constexpr int kMaxSmem = 232448;

static_assert(kMaxTile / kThreads <= 16, "a thread's rows fit 16 bits");

typedef unsigned long long u64;

// one instruction, decoded at the start of the block
struct Code {
  int op, dt, aux;            // aux: a cast's source dtype, a load's stage
  unsigned dst, a, b;         // plan words
  int pad0, pad1;
};
// one aggregate spec, decoded
struct Spec {
  int kind, dt;
  unsigned loc;
  int same;                   // the spec whose partials this one shares
};
// a staged column: its first byte in the input, its element bytes, its
// tile's first byte in stage 0
struct Staged {
  long long src;
  int size, dst;
};
// a spec's partials in a warp
struct Part {
  u64 acc, cnt;
  long long first_row;
  u64 first_val;
};

template <int V>
struct K {
  static constexpr int v = V;
};

__host__ __device__ constexpr int dt_size(int dt) {
  return dt == kBool || dt == kI8 ? 1
       : dt == kI16 || dt == kF16 ? 2
       : dt == kI32 || dt == kF32 ? 4 : 8;
}

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

// float16 bits widened to float bits and back, NaN payloads kept as numpy
// keeps them (npy_halfbits_to_floatbits, npy_floatbits_to_halfbits):
// __float2half_rn would make every NaN 0x7fff, and a float16 column
// projected unchanged must keep its bits
__device__ __forceinline__ unsigned half_to_float_bits(unsigned short h) {
  if ((h & 0x7c00u) == 0x7c00u && (h & 0x3ffu)) {
    return ((unsigned)(h & 0x8000u) << 16) | 0x7f800000u |
           ((unsigned)(h & 0x3ffu) << 13);
  }
  return __float_as_uint(__half2float(__ushort_as_half(h)));
}
__device__ __forceinline__ unsigned short float_to_half_bits(unsigned f) {
  if ((f & 0x7f800000u) == 0x7f800000u && (f & 0x7fffffu)) {
    unsigned short h = (unsigned short)(0x7c00u + ((f & 0x7fffffu) >> 13));
    if (h == 0x7c00u) ++h;
    return (unsigned short)(h | ((f >> 16) & 0x8000u));
  }
  return __half_as_ushort(__float2half_rn(__uint_as_float(f)));
}

// a float register widened to double (exact)
__device__ __forceinline__ double fval(u64 v, int dt) {
  return dt == kF64 ? as_f64(v) : (double)as_f32(v);
}

// an element of a column of dtype dt, widened to a register
__device__ __forceinline__ u64 load(const unsigned char* col, int dt,
                                    int row) {
  switch (dt) {
    case kBool: return col[row] ? 1ull : 0ull;
    case kI8: return (u64)(long long)((const signed char*)col)[row];
    case kI16: return (u64)(long long)((const short*)col)[row];
    case kI32: return (u64)(long long)((const int*)col)[row];
    case kI64: return (u64)((const long long*)col)[row];
    case kF16:
      return (u64)half_to_float_bits(((const unsigned short*)col)[row]);
    case kF32: return of_f32(((const float*)col)[row]);
    default: return (u64)((const long long*)col)[row];
  }
}

// a register as the bits of one element of dtype dt (the low dt_size bytes)
__device__ __forceinline__ u64 element(u64 v, int dt) {
  switch (dt) {
    case kBool: return v & 1ull;
    case kI8: return v & 0xffull;
    case kI16: return v & 0xffffull;
    case kI32: return v & 0xffffffffull;
    case kF16: return (u64)float_to_half_bits((unsigned)v);
    case kF32: return v & 0xffffffffull;
    default: return v;
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

// one node over one row's operands; OP, DT and FROM are compile-time, so
// the switches above fold away
template <int OP, int DT, int FROM>
__device__ __forceinline__ u64 eval(u64 a, u64 b) {
  if constexpr (OP == kCast) {
    return cast(a, FROM, DT);
  } else if constexpr (OP >= kAdd && OP <= kNeg) {
    return arith(OP, DT, a, b);
  } else if constexpr (OP >= kEq && OP <= kGe) {
    return compare(OP, DT, a, b);
  } else if constexpr (OP == kAnd) {
    return a & b & 1ull;
  } else if constexpr (OP == kOr) {
    return (a | b) & 1ull;
  } else if constexpr (OP == kNot) {
    return (a & 1ull) ^ 1ull;
  } else if constexpr (OP == kIsNan) {
    return is_float(DT) && isnan(fval(a, DT)) ? 1ull : 0ull;
  } else {  // kMask: NaN is true, as numpy's astype(bool)
    return is_float(DT) ? (fval(a, DT) != 0.0 ? 1ull : 0ull)
                        : (a != 0ull ? 1ull : 0ull);
  }
}

template <class F>
__device__ __forceinline__ void on_dtype(int dt, F&& f) {
  switch (dt) {
    case kBool: f(K<kBool>()); break;
    case kI8: f(K<kI8>()); break;
    case kI16: f(K<kI16>()); break;
    case kI32: f(K<kI32>()); break;
    case kI64: f(K<kI64>()); break;
    case kF16: f(K<kF16>()); break;
    case kF32: f(K<kF32>()); break;
    default: f(K<kF64>()); break;
  }
}

// a plan word as (word offset for this stage, row mask: 0 reads one word)
struct Ref {
  int off;
  unsigned mask;
};
__device__ __forceinline__ Ref ref(unsigned loc, int stage_words) {
  Ref r;
  r.off = (int)(loc & kLocOffset) + ((loc & kLocStage) ? stage_words : 0);
  r.mask = (loc & kLocConst) ? 0u : 0xffffffffu;
  return r;
}

// a thread's rows of a tile come in pairs: r = 2 * (tid + k * 256) and
// r + 1, so that its shared memory accesses are 16 bytes
struct Pair {
  u64 x, y;
};
__device__ __forceinline__ Pair pair(const u64* W, Ref v, int r) {
  Pair p;
  if (v.mask) {
    const ulonglong2 w = *(const ulonglong2*)(W + v.off + r);
    p.x = w.x;
    p.y = w.y;
  } else {
    p.x = p.y = W[v.off];
  }
  return p;
}
__device__ __forceinline__ void put(u64* W, int off, int r, u64 x, u64 y) {
  *(ulonglong2*)(W + off + r) = make_ulonglong2(x, y);
}

// dst[r] = OP(a[r], b[r]) over this thread's row pairs that start below
// live (a pair's second row may lie past it: its slot word is never read);
// dst may be an operand's slot (each row is read, then written, by the same
// thread)
template <int OP, int DT, int FROM, bool BIN>
__device__ __forceinline__ void apply(u64* W, int dst, Ref a, Ref b,
                                      int live) {
  for (int r = 2 * threadIdx.x; r < live; r += 2 * kThreads) {
    const Pair x = pair(W, a, r);
    Pair y = {0ull, 0ull};
    if (BIN) y = pair(W, b, r);
    put(W, dst, r, eval<OP, DT, FROM>(x.x, y.x), eval<OP, DT, FROM>(x.y, y.y));
  }
}

// a column's staged tile widened into a slot
template <int DT>
__device__ __forceinline__ void widen(u64* W, const unsigned char* col,
                                      int dst, int live) {
  for (int r = 2 * threadIdx.x; r < live; r += 2 * kThreads) {
    put(W, dst, r, load(col, DT, r), load(col, DT, r + 1));
  }
}

// one instruction over the tile's live rows
__device__ __forceinline__ void execute(const Code& c, u64* W,
                                        unsigned char* smem, int stage_off,
                                        int live) {
  const int sw = stage_off / 8;
  const int dst = (int)(c.dst & kLocOffset);
  const Ref a = ref(c.a, sw), b = ref(c.b, sw);
  switch (c.op) {
    case kLoad:
      on_dtype(c.dt, [=](auto D) {
        widen<decltype(D)::v>(W, smem + c.aux + stage_off, dst, live);
      });
      break;
    case kCast:
      on_dtype(c.aux, [=](auto F) {
        on_dtype(c.dt, [=](auto D) {
          apply<kCast, decltype(D)::v, decltype(F)::v, false>(W, dst, a, b,
                                                              live);
        });
      });
      break;
#define K14_BINARY(OPC)                                                   \
  case OPC:                                                               \
    on_dtype(c.dt, [=](auto D) {                                          \
      apply<OPC, decltype(D)::v, 0, true>(W, dst, a, b, live);            \
    });                                                                   \
    break;
    K14_BINARY(kAdd)
    K14_BINARY(kSub)
    K14_BINARY(kMul)
    K14_BINARY(kDiv)
    K14_BINARY(kEq)
    K14_BINARY(kNe)
    K14_BINARY(kLt)
    K14_BINARY(kLe)
    K14_BINARY(kGt)
    K14_BINARY(kGe)
#undef K14_BINARY
#define K14_UNARY(OPC)                                                    \
  case OPC:                                                               \
    on_dtype(c.dt, [=](auto D) {                                          \
      apply<OPC, decltype(D)::v, 0, false>(W, dst, a, b, live);           \
    });                                                                   \
    break;
    K14_UNARY(kNeg)
    K14_UNARY(kIsNan)
    K14_UNARY(kMask)
#undef K14_UNARY
    case kAnd: apply<kAnd, kBool, 0, true>(W, dst, a, b, live); break;
    case kOr: apply<kOr, kBool, 0, true>(W, dst, a, b, live); break;
    case kNot: apply<kNot, kBool, 0, false>(W, dst, a, b, live); break;
    default: break;  // kNop: a constant, or a column read in place
  }
}

// ------------------------------------------------------------ TMA

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(u64* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the live rows of tile t
__device__ __forceinline__ int live_rows(long long t, int T, long long n) {
  const long long r = n - t * T;
  return r <= 0 ? 0 : (r < T ? (int)r : T);
}

// warp 0: tile t's staged columns into stage `stage`, a lane a column,
// the 16-byte multiples of each by bulk copies on the stage's barrier (the
// rest is read by threads after the wait, see fill_tails)
__device__ void issue(const Staged* sc, int ns, const unsigned char* in,
                      unsigned char* smem, u64* bar, long long t, int T,
                      long long n, int stage, int stage_bytes) {
  const int live = live_rows(t, T, n);
  if (live == 0) return;
  const int lane = threadIdx.x & 31;
  unsigned mine = 0;
  for (int c = lane; c < ns; c += 32) {
    mine += (unsigned)(live * sc[c].size) & ~15u;
  }
  const unsigned total = __reduce_add_sync(kAll, mine);
  if (lane == 0) bar_expect(bar + stage, total);
  __syncwarp();
  for (int c = lane; c < ns; c += 32) {
    const Staged col = sc[c];
    const unsigned bytes = (unsigned)(live * col.size) & ~15u;
    if (bytes) {
      // the stage was last read by generic loads: order them before
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(smem + col.dst + (long long)stage * stage_bytes,
                in + col.src + t * (long long)T * col.size, bytes,
                bar + stage);
    }
  }
}

// every thread: the bytes of tile t past each column's last 16-byte
// multiple (live rows only), then a barrier; only where live % 16 != 0
__device__ void fill_tails(const Staged* sc, int ns, const unsigned char* in,
                           unsigned char* smem, long long t, int T,
                           int live, int stage_off) {
  for (int c = 0; c < ns; ++c) {
    const Staged col = sc[c];
    const int bytes = live * col.size, bulk = bytes & ~15;
    const int i = bulk + (int)threadIdx.x;
    if (i < bytes) {
      smem[col.dst + stage_off + i] =
          in[col.src + t * (long long)T * col.size + i];
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ terminals

// a warp's sum of 64-bit words (mod 2^64), four 16-bit limbs at a time
__device__ __forceinline__ u64 warp_sum(u64 v) {
  u64 sum = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    sum += (u64)__reduce_add_sync(kAll, (unsigned)(v >> (16 * l)) & 0xffffu)
           << (16 * l);
  }
  return sum;
}
// a warp's least and greatest signed 64-bit word, high word first
__device__ __forceinline__ long long warp_min(long long v) {
  const int hi = __reduce_min_sync(kAll, (int)(v >> 32));
  const unsigned lo = __reduce_min_sync(
      kAll, (int)(v >> 32) == hi ? (unsigned)v : 0xffffffffu);
  return (long long)(((u64)(unsigned)hi << 32) | lo);
}
__device__ __forceinline__ long long warp_max(long long v) {
  const int hi = __reduce_max_sync(kAll, (int)(v >> 32));
  const unsigned lo = __reduce_max_sync(
      kAll, (int)(v >> 32) == hi ? (unsigned)v : 0u);
  return (long long)(((u64)(unsigned)hi << 32) | lo);
}

// the signed order key of a float register (see the head of this file)
__device__ __forceinline__ long long fkey(u64 v, int dt) {
  const long long b = __double_as_longlong(fval(v, dt));
  return b < 0 ? b ^ 0x7fffffffffffffffll : b;
}
__device__ __forceinline__ u64 unkey(long long k) {
  return (u64)(k < 0 ? k ^ 0x7fffffffffffffffll : k);
}

// the dtype class a spec reduces in: integers (kI64), float bits (kF32,
// float16 too) or double bits (kF64)
__device__ __forceinline__ int dt_class(int dt) {
  return dt == kF64 ? kF64 : is_float(dt) ? kF32 : kI64;
}

// the signed order key of float32 bits, in float order (-0.0 below +0.0)
__device__ __forceinline__ int fkey32(u64 v) {
  const int b = (int)(unsigned)v;
  return b < 0 ? b ^ 0x7fffffff : b;
}

// one spec over this thread's passing rows (bits 2k and 2k + 1: rows
// 2 * (tid + k * 256) and the next of the tile), reduced by the warp into
// the warp's partials (its lane 0
// alone writes them: no atomics; a warp's tiles come in row order, so its
// first row is set once, with the value at it).  Every live row's value is
// read, the passing ones taken: the reads do not wait on each other.
template <int KIND, int C>
__device__ __forceinline__ void reduce_spec(const u64* W, Ref v,
                                            unsigned bits, int live,
                                            long long row0, Part* mine) {
  unsigned cnt = 0, first = 0xffffffffu;
  u64 acc = 0;
  long long best = KIND == kMin ? kNoRow : KIND == kMax ? -kNoRow - 1 : 0;
  int best32 = KIND == kMin ? 0x7fffffff : (int)0x80000000;
  if (C == kI64 && (KIND == kCount || KIND == kFirst)) {
    cnt = __popc(bits);
    if (KIND == kFirst && bits) {
      const int b = __ffs(bits) - 1;
      first = 2 * (threadIdx.x + (b >> 1) * kThreads) + (b & 1);
    }
  } else {
    const auto take = [&](u64 x, bool ok, int r) {
      if (C == kF32) ok = ok && !isnan(as_f32(x));
      if (C == kF64) ok = ok && !isnan(as_f64(x));
      cnt += ok;
      if (KIND == kSum) {
        acc += ok ? x : 0ull;
      } else if ((KIND == kMin || KIND == kMax) && C == kF32) {
        const int key = fkey32(x);
        if (ok && (KIND == kMin ? key < best32 : key > best32)) best32 = key;
      } else if (KIND == kMin || KIND == kMax) {
        const long long key = C == kF64 ? fkey(x, kF64) : (long long)x;
        if (ok && (KIND == kMin ? key < best : key > best)) best = key;
      } else if (KIND == kFirst) {
        if (ok && first == 0xffffffffu) first = (unsigned)r;
      }
    };
#pragma unroll 2
    for (int k = 0; k < kMaxTile / (2 * kThreads); ++k) {
      const int r = 2 * ((int)threadIdx.x + k * kThreads);
      if (r >= live) break;
      const Pair x = pair(W, v, r);
      take(x.x, (bits >> (2 * k)) & 1u, r);
      take(x.y, (bits >> (2 * k + 1)) & 1u, r + 1);
    }
  }
  cnt = __reduce_add_sync(kAll, cnt);
  if (cnt == 0) return;  // warp-uniform: no lane has a row
  if ((KIND == kMin || KIND == kMax) && C == kF32 &&
      best32 != (KIND == kMin ? 0x7fffffff : (int)0x80000000)) {
    // the float's key in double order, the one the state holds
    best = fkey((u64)(unsigned)(best32 < 0 ? best32 ^ 0x7fffffff : best32),
                kF32);
  }
  if (KIND == kSum) acc = warp_sum(acc);
  if (KIND == kMin) best = warp_min(best);
  if (KIND == kMax) best = warp_max(best);
  if (KIND == kFirst) first = __reduce_min_sync(kAll, first);
  __syncwarp();  // the row first names was written by another lane
  if ((threadIdx.x & 31) != 0) return;
  mine->cnt += cnt;
  if (KIND == kSum) mine->acc += acc;
  if (KIND == kMin && best < (long long)mine->acc) mine->acc = (u64)best;
  if (KIND == kMax && best > (long long)mine->acc) mine->acc = (u64)best;
  if (KIND == kFirst && mine->first_row == kNoRow) {
    mine->first_row = row0 + first;
    const u64 x = W[v.off + (int)(first & v.mask)];
    mine->first_val = C != kI64 ? of_f64(fval(x, C)) : x;
  }
}

// one item's rows [0, rows) of the tile out with 16-byte stores (16 / size
// rows a store), the rows past the last whole store one by one; rows at or
// past `live` are zeros
template <int DT>
__device__ __forceinline__ void store_item(const u64* W, Ref v,
                                           unsigned char* dst, int rows,
                                           int live) {
  constexpr int size = dt_size(DT), per = 16 / size;
  const int whole = rows / per;
  for (int q = threadIdx.x; q < whole; q += kThreads) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const int r = q * per + j;
      const u64 x = r < live ? element(W[v.off + (int)((unsigned)r & v.mask)],
                                       DT) : 0ull;
      if (size == 8) {
        w[2 * j] = (unsigned)x;
        w[2 * j + 1] = (unsigned)(x >> 32);
      } else {
        w[j * size / 4] |= (unsigned)x << (8 * ((j * size) % 4));
      }
    }
    *(uint4*)(dst + 16 * (long long)q) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int r = whole * per + (int)threadIdx.x; r < rows; r += kThreads) {
    const u64 x = r < live ? element(W[v.off + (int)((unsigned)r & v.mask)],
                                     DT) : 0ull;
    for (int j = 0; j < size; ++j) {
      dst[(long long)r * size + j] = (unsigned char)(x >> (8 * j));
    }
  }
}

// ------------------------------------------------------------ the kernel

__global__ void __launch_bounds__(kThreads, 2)
    fused_group_kernel(unsigned char* in, long long n, long long bucket,
                       unsigned char* out, u64* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* W = (u64*)smem;
  u64* bar = (u64*)(smem + kOffBar);
  const long long* g = (const long long*)in;
  Code* code = (Code*)(smem + g[kHCode]);
  Spec* spec = (Spec*)(smem + g[kHSpec]);
  Part* part = (Part*)(smem + g[kHPart]);
  Staged* staged = (Staged*)(smem + g[kHStaged]);
  u64* block_passed = (u64*)(smem + kOffMisc);
  int* last = (int*)(smem + kOffMisc + 8);
  int* nrun = (int*)(smem + kOffMisc + 12);
  int* nstaged = (int*)(smem + kOffMisc + 16);
  const int tid = (int)threadIdx.x;
  const int ni = (int)g[kHInstr];
  const int nc = (int)g[kHCols];
  const bool project = g[kHTerminal] == 0;
  const int mreg = (int)g[kHMask];
  const int nout = (int)g[kHOuts];
  const int T = (int)g[kHTile];
  const int stages = (int)g[kHStages];
  const int stage_bytes = (int)g[kHStageBytes];
  const long long* cols = g + kHFixed;
  const long long* ins = cols + 3 * nc;
  const long long* outs = ins + 5 * ni;
  const long long* plan = outs + 4 * nout;
  u64* state = (u64*)in + g[kHState];

  // ---- decode the program once a block: warp 0 keeps the instructions
  // that run a loop, in order (constants are written here once, and an
  // int64 or float64 column is read where it is staged)
  if (tid < 32) {
    int kept = 0;
    for (int i0 = 0; i0 < ni; i0 += 32) {
      const int i = i0 + tid;
      Code c;
      bool runs = false;
      if (i < ni) {
        const long long* w = ins + 5 * i;
        c.op = (int)w[0];
        c.dt = (int)w[1];
        c.aux = 0;
        c.dst = (unsigned)plan[i];
        c.a = c.b = 0u;
        c.pad0 = c.pad1 = 0;
        const bool bin = (c.op >= kAdd && c.op <= kDiv) ||
                         (c.op >= kEq && c.op <= kOr);
        if (c.op == kLoad) {
          c.aux = (int)cols[3 * w[2] + 2];
          runs = !(c.dst & kLocStage);
        } else if (c.op == kConst) {
          const u64 imm = (u64)w[4];
          W[(c.dst & kLocOffset)] =
              is_float(c.dt) ? (c.dt == kF64 ? imm
                                             : of_f32((float)as_f64(imm)))
                             : imm;
        } else {
          c.a = (unsigned)plan[w[2]];
          if (bin) c.b = (unsigned)plan[w[3]];
          if (c.op == kCast) c.aux = (int)w[3];
          runs = true;
        }
      }
      const unsigned ballot = __ballot_sync(kAll, runs);
      if (runs) code[kept + __popc(ballot & ((1u << tid) - 1u))] = c;
      kept += __popc(ballot);
    }
    if (tid == 0) *nrun = kept;
    // the columns a load reads, in order
    kept = 0;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int c = c0 + tid;
      const bool on = c < nc && cols[3 * c + 2] >= 0;
      const unsigned ballot = __ballot_sync(kAll, on);
      if (on) {
        Staged e;
        e.src = cols[3 * c];
        e.size = dt_size((int)cols[3 * c + 1]);
        e.dst = (int)cols[3 * c + 2];
        staged[kept + __popc(ballot & ((1u << tid) - 1u))] = e;
      }
      kept += __popc(ballot);
    }
    if (tid == 0) *nstaged = kept;
  }
  if (!project) {
    for (int i = tid; i < nout * kWarps; i += kThreads) {
      const int s = i / kWarps;
      const long long* o = outs + 4 * s;
      Spec sp;
      sp.kind = (int)o[0];
      sp.dt = (int)o[2];
      sp.loc = o[1] >= 0 ? (unsigned)plan[o[1]] : 0u;
      // the first spec of the same reduction over the same register (avg
      // is sum's): its partials serve this one too
      sp.same = s;
      const int red = sp.kind == kAvg ? kSum : sp.kind;
      for (int e = 0; e < s && sp.same == s; ++e) {
        const long long* oe = outs + 4 * e;
        if ((oe[0] == kAvg ? kSum : (int)oe[0]) == red && oe[1] == o[1] &&
            oe[2] == o[2]) {
          sp.same = e;
        }
      }
      if (i % kWarps == 0) spec[s] = sp;
      // the identity of the spec's reduction (never the state words:
      // blocks that finished early have added into them already)
      Part p;
      p.acc = sp.kind == kMin ? (u64)kNoRow
            : sp.kind == kMax ? (u64)(-kNoRow - 1) : 0ull;
      p.cnt = 0;
      p.first_row = kNoRow;
      p.first_val = 0;
      part[i] = p;
    }
  }
  if (tid == 0) {
    *block_passed = 0;
    for (int st = 0; st < kMaxStages; ++st) bar_init(bar + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const unsigned mloc = mreg >= 0 ? (unsigned)plan[mreg] : 0u;
  const int nr = *nrun, ns = *nstaged;
  const long long cover = project ? bucket : n;
  const long long ntiles = (cover + T - 1) / T;
  const long long step = gridDim.x;
  unsigned phase = 0;  // bit s: the parity stage s's next wait waits for
  u64 passed = 0;

  // stages - 1 tiles in flight ahead of the one interpreted: the block's
  // j-th tile is staged in stage j % stages
  if (tid < 32) {
    for (int a = 0; a < stages - 1; ++a) {
      const long long t = blockIdx.x + a * step;
      if (t < ntiles) issue(staged, ns, in, smem, bar, t, T, n, a,
                            stage_bytes);
    }
  }
  int j = 0;
  for (long long t = blockIdx.x; t < ntiles; t += step, ++j) {
    const int st = j % stages;
    const int stage_off = st * stage_bytes;
    const int sw = stage_off / 8;
    const long long row0 = t * T;
    const int rows = (int)(cover - row0 < T ? cover - row0 : T);
    const int live = live_rows(t, T, n);
    if (tid < 32) {
      // the stage this copy fills was last read by the tile before the
      // barrier that ended it
      const long long ahead = t + (stages - 1) * step;
      if (ahead < ntiles) {
        issue(staged, ns, in, smem, bar, ahead, T, n,
              (j + stages - 1) % stages, stage_bytes);
      }
    }
    if (live > 0) {
      bar_wait(bar + st, (phase >> st) & 1u);
      phase ^= 1u << st;
      if (live & 15) fill_tails(staged, ns, in, smem, t, T, live, stage_off);
      for (int i = 0; i < nr; ++i) {
        const Code c = code[i];
        execute(c, W, smem, stage_off, live);
      }
    }
    const Ref m = ref(mloc, sw);
    if (project) {
      // the items' 16-byte stores read rows other threads wrote
      __syncthreads();
      // the mask: each warp's ballots of its 64 rows (the pairs' first
      // rows, their second), 8 bytes a lane of 8
      const int lane = tid & 31;
      for (int base = 2 * (tid - lane); base < rows; base += 2 * kThreads) {
        const int r = base + 2 * lane;
        const Pair mp = r < live && mreg >= 0 ? pair(W, m, r)
                                              : Pair{1ull, 1ull};
        const bool p0 = r < live && (mp.x & 1ull);
        const bool p1 = r + 1 < live && (mp.y & 1ull);
        passed += p0 + p1;
        const unsigned even = __ballot_sync(kAll, p0);
        const unsigned odd = __ballot_sync(kAll, p1);
        if (lane < 8) {
          const int r8 = base + 8 * lane;
          unsigned char* dst = out + 8 + row0 + r8;
          u64 bytes = 0;
          for (int b = 0; b < 4; ++b) {
            bytes |= (u64)((even >> (4 * lane + b)) & 1u) << (16 * b);
            bytes |= (u64)((odd >> (4 * lane + b)) & 1u) << (16 * b + 8);
          }
          if (r8 + 8 <= rows) {
            *(u64*)dst = bytes;
          } else {
            for (int b = 0; r8 + b < rows; ++b) {
              dst[b] = (unsigned char)(bytes >> (8 * b));
            }
          }
        }
      }
      for (int q = 0; q < nout; ++q) {
        const long long* o = outs + 4 * q;
        const int dt = (int)o[1];
        const Ref v = ref((unsigned)plan[o[0]], sw);
        unsigned char* dst = out + o[2] + row0 * dt_size(dt);
        on_dtype(dt, [=](auto D) {
          store_item<decltype(D)::v>(W, v, dst, rows, live);
        });
      }
    } else if (live > 0) {
      unsigned bits = 0;
      for (int k = 0, r = 2 * tid; r < live; ++k, r += 2 * kThreads) {
        const Pair mp = mreg < 0 ? Pair{1ull, 1ull} : pair(W, m, r);
        bits |= (unsigned)(mp.x & 1ull) << (2 * k);
        if (r + 1 < live) bits |= (unsigned)(mp.y & 1ull) << (2 * k + 1);
      }
      passed += (u64)__popc(bits);
      Part* mine = part + tid / 32;
      for (int s = 0; s < nout; ++s) {
        const Spec sp = spec[s];
        if (sp.kind == kCountStar || sp.same != s) continue;
        const Ref v = ref(sp.loc, sw);
        Part* p = mine + s * kWarps;
        const int c = dt_class(sp.dt);
        const auto by_class = [=](auto C) {
          constexpr int CL = decltype(C)::v;
          switch (sp.kind) {
            case kCount:
              reduce_spec<kCount, CL>(W, v, bits, live, row0, p);
              break;
            case kSum: case kAvg:
              reduce_spec<kSum, CL>(W, v, bits, live, row0, p);
              break;
            case kMin:
              reduce_spec<kMin, CL>(W, v, bits, live, row0, p);
              break;
            case kMax:
              reduce_spec<kMax, CL>(W, v, bits, live, row0, p);
              break;
            default:
              reduce_spec<kFirst, CL>(W, v, bits, live, row0, p);
              break;
          }
        };
        if (c == kI64) {
          by_class(K<kI64>());
        } else if (c == kF32) {
          by_class(K<kF32>());
        } else {
          by_class(K<kF64>());
        }
      }
    }
    __syncthreads();  // the tile's slots and stage are free again
  }

  // ---- the block's partials out: one atomic a block a spec
  passed = warp_sum(passed);
  if ((tid & 31) == 0 && passed) atomicAdd(block_passed, passed);
  __syncthreads();
  if (tid == 0 && *block_passed) atomicAdd(&state[0], *block_passed);
  if (!project) {
    for (int s = tid; s < nout; s += kThreads) {
      const Spec sp = spec[s];
      if (sp.kind == kCountStar) continue;
      // the block's partials: its warps' (the least first row with its
      // value), or those of the spec it shares them with
      const int from = sp.same;
      Part p = part[from * kWarps];
      for (int w = 1; w < kWarps; ++w) {
        const Part q = part[from * kWarps + w];
        p.cnt += q.cnt;
        if (sp.kind == kSum || sp.kind == kAvg) p.acc += q.acc;
        if (sp.kind == kMin && (long long)q.acc < (long long)p.acc) {
          p.acc = q.acc;
        }
        if (sp.kind == kMax && (long long)q.acc > (long long)p.acc) {
          p.acc = q.acc;
        }
        if (q.first_row < p.first_row) {
          p.first_row = q.first_row;
          p.first_val = q.first_val;
        }
      }
      u64* st = state + 2 + 3 * s;
      if (sp.kind == kFirst) scratch[(long long)s * gridDim.x + blockIdx.x] =
          p.first_val;
      if (p.cnt == 0) continue;
      atomicAdd(&st[1], p.cnt);
      if (sp.kind == kSum || sp.kind == kAvg) {
        atomicAdd(&st[0], p.acc);
      } else if (sp.kind == kMin) {
        atomicMin((long long*)&st[0], (long long)p.acc);
      } else if (sp.kind == kMax) {
        atomicMax((long long*)&st[0], (long long)p.acc);
      } else if (sp.kind == kFirst) {
        atomicMin(&st[2], (u64)p.first_row);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(&state[1], 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!*last || tid != 0) return;
  __threadfence();
  // the last block: every other block's atomics and scratch are visible
  volatile u64* vs = state;
  const u64 total = vs[0];
  ((u64*)out)[0] = total;
  if (project) {
    // zeros in the gaps that align the mask's end and each item's to 16
    long long end = 8 + bucket;
    for (int q = 0; q <= nout; ++q) {
      const long long next = (end + 15) / 16 * 16;
      for (long long i = end; i < next; ++i) out[i] = 0;
      if (q < nout) {
        const long long* o = outs + 4 * q;
        end = o[2] + bucket * dt_size((int)o[1]);
      }
    }
    return;
  }
  u64* ow = (u64*)out;
  volatile u64* vscratch = scratch;
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
        // the tile of row f was the block (f / T) % gridDim's
        v = vscratch[(long long)s * gridDim.x + (long long)((f / T) %
                                                            gridDim.x)];
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
// output buffer, scratch a word a (spec, block) for an aggregate group with
// a first() spec (else may be null); `blocks` blocks of 256 threads with
// the header's `smem_bytes` of dynamic shared memory.  Returns the launch's
// CUDA error.
int fused_group_launch(void* in, long long n, long long bucket, void* out,
                       void* scratch, int blocks, int smem_bytes,
                       void* stream) {
  if (blocks <= 0 || smem_bytes < kOffConst || smem_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  static int allowed = 48 * 1024;
  if (smem_bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = kMaxSmem;
  }
  fused_group_kernel<<<blocks, kThreads, smem_bytes,
                       (cudaStream_t)stream>>>(
      (unsigned char*)in, n, bucket, (unsigned char*)out, (u64*)scratch);
  return (int)cudaGetLastError();
}

// the kernel's limits and shared memory layout, which ops/fused_group.py
// mirrors: 0 registers, 1 specs, 2 threads, 3 tile rows at most, 4 the
// tile step, 5 the constants' first word, 6 the bytes a block may take, 7
// the copy stages at most, 8 the bytes of a decoded instruction, a decoded
// spec, a warp's partials of a spec and a staged column (8 bits each)
int fused_group_limits(int which) {
  switch (which) {
    case 0: return kMaxRegs;
    case 1: return kMaxSpecs;
    case 2: return kThreads;
    case 3: return kMaxTile;
    case 4: return kTileStep;
    case 5: return kOffConst / 8;
    case 6: return kMaxSmem;
    case 7: return kMaxStages;
    default:
      return (int)(sizeof(Code) | sizeof(Spec) << 8 | sizeof(Part) << 16 |
                   sizeof(Staged) << 24);
  }
}

const char* fused_group_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

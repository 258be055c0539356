// The raster stencil for Hopper (sm_90a): per band, a SAME-padded 2-D
// cross-correlation of a [B, H, W] raster with a [kh, kw] weight array,
// in f64 or f32.
//
// Replaces the XLA bodies of the JAX package's raster stencil:
//   mosaic_tpu/core/raster/rops.py:318 convolve (f64,
//     jax.lax.conv_general_dilated with padding="SAME", zero-padded), and
//   mosaic_tpu/parallel/raster_halo.py:30 _convolve_fn (the same stencil
//     in f32 over row slabs widened by two ppermute halos; on one device
//     the whole tile with zero halos).
// Neither has a Pallas form.  The plain PyTorch version is
// ops/raster_convolve.py convolve_ref.
//
//   out[b, r, c] = sum over (i, j) of w[i, j] * x[b, r + i - ph, c + j - pw]
//
// with ph = (kh - 1) / 2 and pw = (kw - 1) / 2 (XLA's SAME: the smaller
// half of the padding before, the rest after, which matters for even
// sides) and x taken as 0 outside the tile.  It is not flipped: XLA's
// convolution is a cross-correlation.  The callers set invalid pixels to
// 0 before the call.
//
// Order: each output sums its taps in row-major order from 0, every
// product and every sum rounded once (__dmul_rn / __dadd_rn, __fmul_rn /
// __fadd_rn; the build also has -fmad=false), and a tap outside the tile
// adds w * 0 like any other (the sign of a zero sum and a non-finite
// weight depend on it).  convolve_ref adds the shifted slices of the
// zero-padded raster in the same order, so the two are bit-equal.
//
// What bounds it on an H100: at 3601 x 3601 f64 pixels (an SRTM
// 1-arc-second tile) the raster in and out is 207 MB, 62 us at HBM3's
// 3.35 TB/s.  A tap is a rounded multiply and a rounded add, two FP64
// instructions (an FMA would change the bits), so 5 x 5 needs 38 us at
// the FP64 rate and 7 x 7 75 us: the bytes bound up to 5 x 5, the
// operations beyond.  A thread-per-pixel form loses to the load pipe:
// two global loads and two bounds checks a tap.
//
// The design:
// - A block owns a column strip TW outputs wide and marches down it
//   TH = NY * kR rows a step.  The input rows of a step and its halo,
//   (TH + kh - 1) x (TW + kw - 1) values, sit in a ring of
//   2 * TH + kh - 1 rows in shared memory: a step keeps the kh - 1 halo
//   rows of the one before and stages only its TH new rows, so the
//   raster is read about (TW + kw - 1) / TW times.  Wide strips (256
//   columns for 3 x 3 and 4 x 4, 128 for 5 x 5) read long runs of each
//   row; 7 x 7, whose weights take 98 registers in f64, runs 64 x 16 so
//   that two blocks fit an SM.
// - Staging is cp.async of one value a copy (an SRTM row of 28,808 or
//   14,404 bytes is no multiple of 16, so TMA cannot map it), coalesced,
//   with src-size 0 for values outside the tile: the zero padding.  The
//   next step's rows are in flight while the block sums this one (two
//   commit groups; staging two or three steps ahead was no faster).
// - Each thread computes kR = 8 outputs of one column.  It walks the
//   kR + kh - 1 input rows once, reads each row's kw values from shared
//   memory once, and adds each value's products to the outputs it
//   belongs to: input row q adds tap row i = q - o to output o, so each
//   output still sums its taps in row-major order.  A 5 x 5 stencil
//   takes 12 x 5 shared reads for 200 taps.
// - The weights are read once a block: into registers for the instances
//   of a fixed size (3 x 3, 4 x 4, 5 x 5, 7 x 7; every loop unrolled),
//   into shared memory for the runtime-size instances (any kh x kw whose
//   ring fits; a 32 x 8 tile for large stencils).  No __constant__
//   symbol is written per call: calls on different streams may carry
//   different weights.
// - The grid is persistent: as many blocks as the card holds at once.
//   The work units, (band, strip, step) in that order, are split into
//   equal contiguous ranges, one a block, so no SM gets more than one
//   unit over the mean.  A block restarts its ring where its range
//   enters a new strip.
// - Stores are coalesced and streaming (__stcs): nothing reads the
//   output again in this kernel.

#include <cuda_runtime.h>

namespace {

// Output rows a thread.  The tile constants are kept in one table,
// kInstances, which ops/raster_convolve.py mirrors (INSTANCES,
// ROWS_PER_THREAD) and checks against raster_convolve_instances() when it
// loads this library.
constexpr int kR = 8;

struct Instance {
  int kh, kw;   // the stencil of a fixed-size instance; 0, 0: any
  int tw, ny;   // output columns a block (threads in x), row groups (y)
};

constexpr Instance kInstances[] = {
    {3, 3, 256, 1}, {4, 4, 256, 1}, {5, 5, 128, 2}, {7, 7, 64, 2},
    {0, 0, 128, 2}, {0, 0, 32, 1}};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// One value from global to shared memory, asynchronously; src_bytes 0
// writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Shared memory of an instance for a kh x kw stencil, in values: the
// ring, and the weights of a runtime-size instance.
__host__ __device__ constexpr int smem_values(int fixed_kh, int tw, int ny,
                                              int kh, int kw) {
  return (2 * ny * kR + kh - 1) * (tw + kw - 1) +
         (fixed_kh > 0 ? 0 : kh * kw);
}

// Stage input rows [g0, g0 + nrows) of the strip whose halo starts at
// column cl into ring rows from ring_row on (mod n_ring).
template <typename T, int TW, int NY>
__device__ __forceinline__ void stage(T* ring, int ring_row, int n_ring,
                                      int sw, const T* xb, int H, int W,
                                      int g0, int nrows, int cl) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int total = nrows * sw;
  for (int e = tid; e < total; e += TW * NY) {
    const int rr = e / sw;
    const int cc = e - rr * sw;
    int rp = ring_row + rr;
    rp = rp >= n_ring ? rp - n_ring : rp;
    const int gr = g0 + rr;
    const int gc = cl + cc;
    const bool in = static_cast<unsigned>(gr) < static_cast<unsigned>(H) &&
                    static_cast<unsigned>(gc) < static_cast<unsigned>(W);
    const T* src = in ? xb + static_cast<long long>(gr) * W + gc : xb;
    cp_async<sizeof(T)>(ring + rp * sw + cc, src, in ? sizeof(T) : 0);
  }
}

// KH, KW > 0: a fixed-size instance; 0, 0: kh and kw at run time.
template <typename T, int KH, int KW, int TW, int NY>
__global__ void __launch_bounds__(TW * NY)
    convolve_kernel(const T* __restrict__ x, int H, int W,
                    const T* __restrict__ w, int kh_rt, int kw_rt,
                    T* __restrict__ out, long long units, int strips,
                    int steps) {
  constexpr bool kFixed = KH > 0;
  constexpr int TH = NY * kR;
  const int kh = kFixed ? KH : kh_rt;
  const int kw = kFixed ? KW : kw_rt;
  const int ph = (kh - 1) / 2;
  const int pw = (kw - 1) / 2;
  const int n_ring = 2 * TH + kh - 1;
  const int sw = TW + kw - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* ws = ring + n_ring * sw;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  T wr[kFixed ? KH * KW : 1];
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < KH * KW; ++k) wr[k] = __ldg(w + k);
  } else {
    // visible after the first __syncthreads of the march
    for (int k = ty * TW + tx; k < kh * kw; k += TW * NY) ws[k] = __ldg(w + k);
  }

  long long u = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  if (u >= u_end) return;
  const long long per_band = static_cast<long long>(strips) * steps;
  int band = static_cast<int>(u / per_band);
  const long long rem = u - band * per_band;
  int strip = static_cast<int>(rem / steps);
  int step = static_cast<int>(rem - static_cast<long long>(strip) * steps);
  const long long plane = static_cast<long long>(H) * W;

  int base = 0;        // the ring row of this step's first input row
  bool fresh = true;   // the ring holds nothing of this strip
  for (; u < u_end; ++u) {
    const T* xb = x + band * plane;
    const int r0 = step * TH;
    const int c0 = strip * TW;
    if (fresh) {
      base = 0;
      stage<T, TW, NY>(ring, 0, n_ring, sw, xb, H, W, r0 - ph, TH + kh - 1,
                       c0 - pw);
      cp_async_commit();
    }
    const bool more = u + 1 < u_end && step + 1 < steps;
    if (more) {
      // the next step's TH new rows, into the ring rows this step and
      // the last one no longer share
      int next = base + TH + kh - 1;
      next = next >= n_ring ? next - n_ring : next;
      stage<T, TW, NY>(ring, next, n_ring, sw, xb, H, W, r0 + TH + kh - 1 - ph,
                       TH, c0 - pw);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    T acc[kR];
#pragma unroll
    for (int o = 0; o < kR; ++o) acc[o] = T(0);
    const int rbase = base + ty * kR;
    if constexpr (kFixed) {
#pragma unroll
      for (int q = 0; q < kR + KH - 1; ++q) {
        int p = rbase + q;
        p = p >= n_ring ? p - n_ring : p;
        const T* row = ring + p * sw + tx;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const T v = row[j];
#pragma unroll
          for (int o = 0; o < kR; ++o) {
            const int i = q - o;
            if (i >= 0 && i < KH) {
              acc[o] = add_rn(acc[o], mul_rn(wr[i * KW + j], v));
            }
          }
        }
      }
    } else {
      for (int q = 0; q < kR + kh - 1; ++q) {
        int p = rbase + q;
        p = p >= n_ring ? p - n_ring : p;
        const T* row = ring + p * sw + tx;
        for (int j = 0; j < kw; ++j) {
          const T v = row[j];
#pragma unroll
          for (int o = 0; o < kR; ++o) {
            const int i = q - o;
            if (i >= 0 && i < kh) {
              acc[o] = add_rn(acc[o], mul_rn(ws[i * kw + j], v));
            }
          }
        }
      }
    }

    const int c = c0 + tx;
    if (c < W) {
      T* ob = out + band * plane + c;
#pragma unroll
      for (int o = 0; o < kR; ++o) {
        const int r = r0 + ty * kR + o;
        if (r < H) __stcs(ob + static_cast<long long>(r) * W, acc[o]);
      }
    }
    __syncthreads();   // the ring rows read here are staged into next

    base += TH;
    base = base >= n_ring ? base - n_ring : base;
    fresh = !more;
    if (++step == steps) {
      step = 0;
      if (++strip == strips) {
        strip = 0;
        ++band;
      }
    }
  }
}

template <typename T, int KH, int KW, int TW, int NY>
int run(const T* x, int B, int H, int W, const T* w, int kh, int kw,
        T* out, cudaStream_t stream) {
  constexpr int TH = NY * kR;
  const size_t smem = sizeof(T) * smem_values(KH, TW, NY, kh, kw);
  void (*const kernel)(const T*, int, int, const T*, int, int, T*,
                       long long, int, int) =
      convolve_kernel<T, KH, KW, TW, NY>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, TW * NY, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int strips = (W + TW - 1) / TW;
  const int steps = (H + TH - 1) / TH;
  const long long units = static_cast<long long>(B) * strips * steps;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(units < slots ? units : slots);
  convolve_kernel<T, KH, KW, TW, NY><<<grid, dim3(TW, NY), smem, stream>>>(
      x, H, W, w, kh, kw, out, units, strips, steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int I>
int run_instance(const T* x, int B, int H, int W, const T* w, int kh,
                 int kw, T* out, cudaStream_t stream) {
  constexpr Instance in = kInstances[I];
  return run<T, in.kh, in.kw, in.tw, in.ny>(x, B, H, W, w, kh, kw, out,
                                            stream);
}

template <typename T>
int launch(const T* x, int B, int H, int W, const T* w, int kh, int kw,
           int instance, T* out, cudaStream_t stream) {
  if (instance < 0 || instance >= kNumInstances || kh < 1 || kw < 1 ||
      (kInstances[instance].kh > 0 &&
       (kInstances[instance].kh != kh || kInstances[instance].kw != kw))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  static_assert(kNumInstances == 6, "one case an instance");
  switch (instance) {
    case 0: return run_instance<T, 0>(x, B, H, W, w, kh, kw, out, stream);
    case 1: return run_instance<T, 1>(x, B, H, W, w, kh, kw, out, stream);
    case 2: return run_instance<T, 2>(x, B, H, W, w, kh, kw, out, stream);
    case 3: return run_instance<T, 3>(x, B, H, W, w, kh, kw, out, stream);
    case 4: return run_instance<T, 4>(x, B, H, W, w, kh, kw, out, stream);
    default: return run_instance<T, 5>(x, B, H, W, w, kh, kw, out, stream);
  }
}

}  // namespace

extern "C" {

// The instance table, five ints each (kh, kw, tw, ny, rows a thread; kh,
// kw 0 for a runtime-size instance), into `out` (room for n instances).
// Returns the number of instances.
int raster_convolve_instances(int* out, int n) {
  for (int i = 0; i < kNumInstances && i < n; ++i) {
    const Instance& in = kInstances[i];
    const int row[5] = {in.kh, in.kw, in.tw, in.ny, kR};
    for (int k = 0; k < 5; ++k) out[5 * i + k] = row[k];
  }
  return kNumInstances;
}

// x [B, H, W] and out [B, H, W], w [kh, kw], all contiguous on the device
// and of one type; `instance` indexes the instance table (the wrapper
// picks it, and checks the sizes and the shared memory).  Launches on
// `stream` and returns the first CUDA error of the launch's set-up or of
// the launch itself.
int raster_convolve_f64_launch(const double* x, int B, int H, int W,
                               const double* w, int kh, int kw,
                               int instance, double* out, void* stream) {
  return launch<double>(x, B, H, W, w, kh, kw, instance, out,
                        static_cast<cudaStream_t>(stream));
}

int raster_convolve_f32_launch(const float* x, int B, int H, int W,
                               const float* w, int kh, int kw, int instance,
                               float* out, void* stream) {
  return launch<float>(x, B, H, W, w, kh, kw, instance, out,
                       static_cast<cudaStream_t>(stream));
}

const char* raster_convolve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// adds w * 0 like any other.  convolve_ref adds the shifted slices of the
// zero-padded raster in the same order, so the two are bit-equal.
//
// What bounds it on an H100: its bytes.  At 3601 x 3601 f64 pixels (an
// SRTM 1-arc-second tile) the raster in and out is 207 MB, 62 us at
// HBM3's 3.35 TB/s; a 5 x 5 stencil's 324 M multiply-adds take 19 us at
// the FP64 rate.  A simple design that is right comes first: a thread per
// output pixel in 32 x 8 blocks, each reading its taps through the
// read-only cache, where the block's neighbours' reads of the same rows
// hit; the weights are read from global memory (every thread of a warp
// reads the same weight, one broadcast), so any kh x kw runs.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

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

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
    convolve_kernel(const T* __restrict__ x, int H, int W,
                    const T* __restrict__ w, int kh, int kw,
                    T* __restrict__ out) {
  const int c = blockIdx.x * kBX + threadIdx.x;
  const int r = blockIdx.y * kBY + threadIdx.y;
  if (c >= W || r >= H) return;
  const long long plane = (long long)H * W;
  const T* xb = x + (long long)blockIdx.z * plane;
  const int ph = (kh - 1) / 2;
  const int pw = (kw - 1) / 2;
  T acc = T(0);
  for (int i = 0; i < kh; ++i) {
    const int rr = r + i - ph;
    const bool row_in = rr >= 0 && rr < H;
    for (int j = 0; j < kw; ++j) {
      const int cc = c + j - pw;
      const T v = (row_in && cc >= 0 && cc < W)
                      ? __ldg(xb + (long long)rr * W + cc)
                      : T(0);
      acc = add_rn(acc, mul_rn(__ldg(w + i * kw + j), v));
    }
  }
  out[(long long)blockIdx.z * plane + (long long)r * W + c] = acc;
}

template <typename T>
int launch(const T* x, int B, int H, int W, const T* w, int kh, int kw,
           T* out, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, B);
  convolve_kernel<T><<<grid, dim3(kBX, kBY), 0, stream>>>(x, H, W, w, kh,
                                                          kw, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, H, W] and out [B, H, W], w [kh, kw], all contiguous on the device
// and of one type; B <= 65535, H <= 65535 * 8, kh, kw >= 1 (the wrapper
// checks).  Launches on `stream` and returns the launch's CUDA error.
int raster_convolve_f64_launch(const double* x, int B, int H, int W,
                               const double* w, int kh, int kw, double* out,
                               void* stream) {
  return launch<double>(x, B, H, W, w, kh, kw, out, (cudaStream_t)stream);
}

int raster_convolve_f32_launch(const float* x, int B, int H, int W,
                               const float* w, int kh, int kw, float* out,
                               void* stream) {
  return launch<float>(x, B, H, W, w, kh, kw, out, (cudaStream_t)stream);
}

const char* raster_convolve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

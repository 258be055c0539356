// H3 lattice projection for Hopper (sm_90a): origin-local lon/lat degrees
// -> (face, axial a, axial b, hex margin, face gap), one thread per point.
//
// Replaces the Pallas TPU kernel mosaic_tpu/ops/pallas_projection.py
// project_lattice_pallas (kernel body _make_kernel.kernel).  The plain
// PyTorch version of the same function is ops/projection.py
// project_lattice_ref; the df arithmetic and the per-point projection
// live in h3_df.cuh, which keeps its order of operations so the two
// agree bit for bit.  The main path runs the projection inside the
// fused join kernel (h3_dense_join.cu); this kernel serves callers that
// want the five outputs themselves.
//
// What bounds it on an H100: arithmetic issue (h3_df.cuh).  Design:
//   * one thread per point; the [N, 2] input is read as float2 in place
//     and the five outputs are written as separate coalesced arrays;
//   * the res-specific [2, 20, 9] hi/lo gnomonic basis table sits in shared
//     memory, loaded once per block; the 20 face centers in __constant__;
//   * the origin's df sin/cos and the other df constants arrive as kernel
//     arguments, computed on the host in f64, so one binary serves every
//     resolution and origin (the Pallas kernel bakes them in and
//     recompiles per (res, origin)).

#include <cuda_runtime.h>

#include "h3_df.cuh"

namespace {

using namespace h3df;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
project_kernel(const float2* __restrict__ xy, int n,
               const float* __restrict__ table, Consts k,
               int* __restrict__ face_out, int* __restrict__ a_out,
               int* __restrict__ b_out, float* __restrict__ margin_out,
               float* __restrict__ gap_out) {
  __shared__ float tbl[kTable];
  load_table(tbl, table);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Projection r = project_point(xy[i], tbl, k);
  face_out[i] = r.face;
  a_out[i] = r.a;
  b_out[i] = r.b;
  margin_out[i] = r.margin;
  gap_out[i] = r.gap;
}

}  // namespace

extern "C" {

// Upload the [20, 3] f32 face centers to this device's constant memory.
// Once per device before the first launch.
int h3_projection_set_faces(const float* faces_host) {
  cudaMemcpyToSymbol(c_face, faces_host, sizeof(float) * kFaces * 3);
  return (int)cudaGetLastError();
}

// xy [n, 2] f32 on the device; table [2, 20, 9] f32 on the device;
// consts_host [13] f32 in host memory; outputs [n] on the device.
// Launches on `stream` and returns the launch's CUDA error code.
int h3_project_lattice(const float* xy, int n, const float* table,
                       const float* consts_host, int* face, int* a, int* b,
                       float* margin, float* gap, void* stream) {
  Consts k;
  for (int i = 0; i < 13; ++i) k.v[i] = consts_host[i];
  int blocks = (n + kThreads - 1) / kThreads;
  project_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(xy), n, table, k, face, a, b, margin,
      gap);
  return (int)cudaGetLastError();
}

const char* h3_projection_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

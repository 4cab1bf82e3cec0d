// TPS-coordinate kernel K3 for Hopper (sm_90a).
//
// Replaces the TPU kernel stabstitch2_tpu/ops/pallas_warp.py:_kernel
// (tps_coords_fused). For every canvas pixel (i, j) of image b, with grid
// point (X, Y) = (gx[j], gy[i]), the TPS sample coordinates
//   x_s = T[0,0] + T[0,1] X + T[0,2] Y + sum_p T[0,3+p] U(|(X,Y) - src_p|^2),
//   U(d2) = d2 log(d2 + 1e-6), P = 63 points, and likewise y_s,
// without the [P+3, H*W] radial basis the matrix-product form streams
// through memory. Out: x_s, y_s, each [B, oh*ow] float32.
//
// Bound on the H100: operations. Per pixel and control point the spline
// needs the sum of two squares (each square once per column or row and
// point), +1e-6, a log, a product and a multiply and an add per
// coordinate: 7 float32 operations plus the log's own, 25 for the
// bit-equal core path of logf that K2 runs (warp_common.cuh:log_core;
// the full logf this kernel calls has 32), by chip_smoke.py's count of
// their SASS. On the main path's 16 x 448 x 608 canvas that is ~8.8
// GFLOP, ~0.13 ms at 67 TFLOP/s, against ~35 MB of output, ~10 us at
// 3.35 TB/s. The per-point loop, and in it the log, is the work.
//
// Design: one thread per canvas pixel, T[b] and src[b] in shared memory
// (every thread of a block reads the same point, a broadcast), the spline
// of warp_common.cuh, which K2 runs too. The TPU kernel's (8, W) row tiles
// and padded rows are not carried over: a block covers 256 consecutive
// pixels of one image and masks the ragged end. Every product and sum is
// rounded separately and the log is the accurate logf, so the coordinates
// equal, bit for bit, those of ops/tps.spline_eval run by PyTorch on the
// card (and those K2 computes internally).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {
constexpr int kThreads = 256;
}

extern "C" __global__ void tps_coords_kernel(
    const float* __restrict__ T, const float* __restrict__ src,
    const float* __restrict__ gx, const float* __restrict__ gy,
    float* __restrict__ xs, float* __restrict__ ys, int oh, int ow, int P) {
  extern __shared__ float sm[];
  const int b = blockIdx.y;
  stabstitch::load_spline(T, src, b, P, sm);

  const int npix = oh * ow;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  const int i = pix / ow;
  const int j = pix - i * ow;
  float x, y;
  stabstitch::spline_at(sm, P, gx[j], gy[i], &x, &y);
  const size_t o = static_cast<size_t>(b) * npix + pix;
  xs[o] = x;
  ys[o] = y;
}

// Launches on `stream` of card `device`; returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch (0 on success).
extern "C" int stabstitch_tps_coords(const float* T, const float* src,
                                     const float* gx, const float* gy,
                                     float* xs, float* ys, int B, int oh,
                                     int ow, int P, int device,
                                     void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = (2 * static_cast<size_t>(P + 3) + 2 * P) * sizeof(float);
  const unsigned npix = static_cast<unsigned>(oh) * ow;
  dim3 grid((npix + kThreads - 1) / kThreads, B);
  tps_coords_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(T, src, gx, gy, xs,
                                                           ys, oh, ow, P);
  return static_cast<int>(cudaGetLastError());
}

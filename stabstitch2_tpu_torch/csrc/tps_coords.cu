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
// coordinate: 7 float32 operations plus the log's own, 25 for
// warp_common.cuh:log_core by chip_smoke.py's count of its SASS. On the
// main path's 16 x 448 x 608 canvas that is ~8.8 GFLOP, ~0.13 ms at
// 67 TFLOP/s, against ~35 MB of output, ~10 us at 3.35 TB/s. The
// per-point loop, and in it the log, is the work; the 8 bytes stored per
// pixel are not.
//
// Design: the spline is warp_common.cuh:spline_tile, the evaluation K2
// (fused_warp.cu) also runs, on the same 16-row x 128-column tiles, and
// the kernel stores x_s, y_s of the tile's pixels inside the canvas. A
// lane's 4 pixels lie 32 columns apart, so each of a warp's stores covers
// 32 consecutive columns. The tables of separable squares take 48,384
// bytes at P = 63, so the launch raises the dynamic shared memory limit
// above its 48 KB default. The TPU kernel's (8, W) row tiles and padded
// rows are not carried over: the kernel masks the ragged edge itself.
//
// Bit equality: spline_tile rounds every product and sum separately, in
// ops/tps.spline_eval's order, with each square rounded once from the
// same difference, and takes log_core, which chip_smoke.py holds
// bit-equal to logf. So the coordinates equal, bit for bit, those of the
// plain version run by PyTorch on the card, and, since K2 calls the same
// routine, those K2 samples with: route B (K3 + K4) gives route A's (K2)
// frames by construction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

using stabstitch::kTileCols;
using stabstitch::kTilePix;
using stabstitch::kTileRows;
using stabstitch::kTileThreads;

extern "C" __global__ void __launch_bounds__(kTileThreads) tps_coords_kernel(
    const float* __restrict__ T, const float* __restrict__ src,
    const float* __restrict__ gx, const float* __restrict__ gy,
    float* __restrict__ xs, float* __restrict__ ys, int oh, int ow, int P) {
  extern __shared__ __align__(16) float sm[];
  float ax[kTilePix], ay[kTilePix];
  stabstitch::spline_tile(T, src, gx, gy, oh, ow, P, sm, ax, ay);
  const int i = blockIdx.y * kTileRows + (threadIdx.x >> 5);
  if (i >= oh) return;
  const size_t row = (static_cast<size_t>(blockIdx.z) * oh + i) * ow;
  const int j0 = blockIdx.x * kTileCols + (threadIdx.x & 31);
#pragma unroll
  for (int q = 0; q < kTilePix; ++q) {
    const int j = j0 + 32 * q;
    if (j < ow) {
      xs[row + j] = ax[q];
      ys[row + j] = ay[q];
    }
  }
}

// Launches on `stream` of card `device`; returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch (0 on success).
extern "C" int stabstitch_tps_coords(const float* T, const float* src,
                                     const float* gx, const float* gy,
                                     float* xs, float* ys, int B, int oh,
                                     int ow, int P, int device,
                                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = stabstitch::spline_tile_smem(P);
  e = cudaFuncSetAttribute(tps_coords_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((ow + kTileCols - 1) / kTileCols,
            (oh + kTileRows - 1) / kTileRows, B);
  tps_coords_kernel<<<grid, kTileThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(T, src, gx, gy, xs,
                                                           ys, oh, ow, P);
  return static_cast<int>(cudaGetLastError());
}

// Fused composite-warp kernel K2 for Hopper (sm_90a).
//
// Replaces the TPU kernel stabstitch2_tpu/ops/pallas_fused.py:_kernel.
// For every canvas pixel (i, j) of image b, with grid point
// (X, Y) = (gx[j], gy[i]):
//   1. the TPS spline x_s = T[0,0] + T[0,1] X + T[0,2] Y
//                           + sum_p T[0,3+p] U(|(X,Y) - src_p|^2),
//      U(d2) = d2 log(d2 + 1e-6), P = 63 points, and likewise y_s;
//   2. the corner/weight algebra of ops/interp._patch_weights_idx;
//   3. the four uint8 BGR corners read straight from the source image and
//      combined in the order of ops/interp._combine_patch_u8;
//   4. the coverage mask (the bilinear_mask algebra, no inside gate).
// Out: [B, 4, oh, ow] float32 planes B, G, R, mask. A pixel whose factored
// support (x1c-x0c)*(y1c-y0c) is 0, or whose low corner lies outside, is
// dead and its B, G, R are exact zeros.
//
// Bound on the H100: operations. Per pixel and control point the spline
// needs one sum of the two squares, +1e-6, a log, a product and a
// multiply and an add per coordinate: 7 float32 operations besides the
// log, whose own arithmetic (warp_common.cuh:log_core: 11 FMAs, a
// multiply, an add and a conversion, 25 operations by chip_smoke.py's
// count of its SASS; the full logf has 32) comes on top. Against that the
// bytes (at most 12 source bytes read and 16 written per pixel) are
// small: on the main path's 16 x 448 x 608 canvas the operations take ~6x
// the ~23 us of HBM traffic. The per-point loop, and in it the log, is
// the work; the gather is not.
//
// Design. Step 1 is warp_common.cuh:spline_tile, the evaluation K3
// (tps_coords.cu) also calls, on its tiles of 16 canvas rows x 128
// columns of one image: a warp takes one row and a lane 4 pixels of it,
// 32 columns apart (stores stay coalesced); the separable squares are
// tabulated in shared memory, with one broadcast float4 {T[0,3+p],
// T[1,3+p], dy^2, 0} per row and point; a lane runs 4 independent log
// chains; and the log is log_core, the accurate logf's core path without
// its branches for inputs a spline never gives it, held bit-equal to logf
// by chip_smoke.py. Its arithmetic is order-preserving, so the
// coordinates equal, bit for bit, those of K3 and of the plain version in
// ops/tps.spline_eval run by PyTorch on the card; a pixel on a view's
// border then cannot flip between live and dead across them. Steps 2-4
// are warp_common.cuh's, shared with K4. The TPU kernel's window
// placement, (8, 128) tiling and overflow plane are not carried over: a
// thread reads any source pixel from global memory, so nothing can
// overflow. Rows and columns past the canvas edge evaluate the last
// row/column and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

using stabstitch::kTileCols;
using stabstitch::kTilePix;
using stabstitch::kTileRows;
using stabstitch::kTileThreads;

extern "C" __global__ void __launch_bounds__(kTileThreads) fused_warp_kernel(
    const uint8_t* __restrict__ im, const float* __restrict__ T,
    const float* __restrict__ src, const float* __restrict__ gx,
    const float* __restrict__ gy, float* __restrict__ out, int H, int W,
    int oh, int ow, int P) {
  extern __shared__ __align__(16) float sm[];
  float ax[kTilePix], ay[kTilePix];
  stabstitch::spline_tile(T, src, gx, gy, oh, ow, P, sm, ax, ay);
  const int b = blockIdx.z;
  const int i = blockIdx.y * kTileRows + (threadIdx.x >> 5);
  const int j0 = blockIdx.x * kTileCols + (threadIdx.x & 31);
  if (i >= oh) return;

  const size_t plane = static_cast<size_t>(oh) * ow;
  const uint8_t* img = im + 3 * static_cast<size_t>(b) * H * W;
#pragma unroll
  for (int q = 0; q < kTilePix; ++q) {
    const int j = j0 + 32 * q;
    if (j >= ow) continue;
    // 2. + 4. corners, weights, coverage mask, support
    const stabstitch::Corners c =
        stabstitch::corner_weights(ax[q], ay[q], H, W);
    // 3. gather + combine of live pixels; dead ones are exact zeros
    float v[3] = {0.f, 0.f, 0.f};
    if (c.live) stabstitch::combine_bgr(img, W, c, v);
    float* o = out + static_cast<size_t>(b) * 4 * plane +
               static_cast<size_t>(i) * ow + j;
    o[0] = v[0];
    o[plane] = v[1];
    o[2 * plane] = v[2];
    o[3 * plane] = c.mask;
  }
}

// log_core against logf on the float32s with bits lo, lo+1, ..., lo+n-1
// (positive normal finite ones): counts the inputs where the two differ
// in any bit and keeps the smallest such bits.
extern "C" __global__ void log_core_check_kernel(unsigned lo, unsigned n,
                                                 unsigned long long* bad,
                                                 unsigned* first) {
  for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + k);
    if (__float_as_uint(logf(x)) != __float_as_uint(stabstitch::log_core(x))) {
      atomicAdd(bad, 1ull);
      atomicMin(first, lo + k);
    }
  }
}

extern "C" int stabstitch_log_core_check(unsigned lo, unsigned n,
                                         unsigned long long* bad,
                                         unsigned* first, int device,
                                         void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  log_core_check_kernel<<<132 * 16, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(lo, n, bad,
                                                               first);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` of card `device`; returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch (0 on success).
extern "C" int stabstitch_fused_warp(const uint8_t* im, const float* T,
                                     const float* src, const float* gx,
                                     const float* gy, float* out, int B,
                                     int H, int W, int oh, int ow, int P,
                                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = stabstitch::spline_tile_smem(P);
  e = cudaFuncSetAttribute(fused_warp_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((ow + kTileCols - 1) / kTileCols,
            (oh + kTileRows - 1) / kTileRows, B);
  fused_warp_kernel<<<grid, kTileThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(im, T, src, gx, gy,
                                                           out, H, W, oh, ow,
                                                           P);
  return static_cast<int>(cudaGetLastError());
}

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
// Bound on the H100: operations. A pixel costs 63 logs and about 800
// float32 operations (12 per control point) against at most 12 source
// bytes read and 16 bytes written: on the main path's 16 x 448 x 608
// canvas that is ~3.5 GFLOP, 52 us at 67 TFLOP/s, against ~23 us of HBM
// traffic. The per-point loop is the work; the gather is not.
//
// Design: one thread per canvas pixel, T[b] and src[b] in shared memory
// (every thread of a block reads the same point, a broadcast); the
// arithmetic of steps 1-4 is warp_common.cuh's, shared with K3 and K4.
// The TPU kernel's window placement, (8, 128) tiling and overflow plane
// are not carried over: a thread reads any source pixel from global
// memory, so nothing can overflow. Every product and sum is rounded separately
// (__fmul_rn / __fadd_rn, no FMA contraction) and the log is the accurate
// logf, so the coordinates equal, bit for bit, those of the plain version
// in ops/tps.spline_eval run by PyTorch on the card; a pixel on a view's
// border then cannot flip between live and dead across the two versions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {
constexpr int kThreads = 256;
}

extern "C" __global__ void fused_warp_kernel(
    const uint8_t* __restrict__ im, const float* __restrict__ T,
    const float* __restrict__ src, const float* __restrict__ gx,
    const float* __restrict__ gy, float* __restrict__ out, int H, int W,
    int oh, int ow, int P) {
  extern __shared__ float sm[];
  const int b = blockIdx.y;
  stabstitch::load_spline(T, src, b, P, sm);

  const int npix = oh * ow;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  const int i = pix / ow;
  const int j = pix - i * ow;

  // 1. spline, same order as ops/tps.spline_eval and the TPU kernel
  float xs, ys;
  stabstitch::spline_at(sm, P, gx[j], gy[i], &xs, &ys);
  // 2. + 4. corners, weights, coverage mask, support
  const stabstitch::Corners c = stabstitch::corner_weights(xs, ys, H, W);
  // 3. gather + combine of live pixels; dead ones are exact zeros
  float v[3] = {0.f, 0.f, 0.f};
  if (c.live)
    stabstitch::combine_bgr(im + 3 * static_cast<size_t>(b) * H * W, W, c, v);
  const size_t plane = static_cast<size_t>(npix);
  float* o = out + static_cast<size_t>(b) * 4 * plane + pix;
  o[0] = v[0];
  o[plane] = v[1];
  o[2 * plane] = v[2];
  o[3 * plane] = c.mask;
}

// Launches on `stream` of card `device`; returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch (0 on success).
extern "C" int stabstitch_fused_warp(const uint8_t* im, const float* T,
                                     const float* src, const float* gx,
                                     const float* gy, float* out, int B,
                                     int H, int W, int oh, int ow, int P,
                                     int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = (2 * static_cast<size_t>(P + 3) + 2 * P) * sizeof(float);
  const unsigned npix = static_cast<unsigned>(oh) * ow;
  dim3 grid((npix + kThreads - 1) / kThreads, B);
  fused_warp_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(im, T, src, gx, gy,
                                                           out, H, W, oh, ow,
                                                           P);
  return static_cast<int>(cudaGetLastError());
}

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
// log, whose own arithmetic (log_core below: 11 FMAs, a multiply, an add
// and a conversion, 25 operations by chip_smoke.py's count of its SASS;
// the full logf has 32) comes on top. Against that the bytes (at most 12
// source bytes read and 16 written per pixel) are small: on the main
// path's 16 x 448 x 608 canvas the operations take ~6x the ~23 us of HBM
// traffic. The per-point loop, and in it the log, is the work; the gather
// is not.
//
// Design. A block takes a tile of 16 canvas rows x 128 columns of one
// image; a warp takes one row and a lane 4 pixels of it, 32 columns apart
// (stores stay coalesced). X depends only on the column and Y only on the
// row, so the block first tabulates dx^2 = (X - sx_p)^2 for each of its
// columns and points, and dy^2 for each of its rows and points, in shared
// memory (each row's entry packed with T[0,3+p] and T[1,3+p] as one
// float4, which a warp reads as a broadcast). d2 is then one add of two
// table entries per pixel and point, and a lane's 4 pixels share the
// row's loads and run 4 independent log chains that hide each other's
// latency. The arithmetic is order-preserving: every product and sum is
// rounded separately (__fmul_rn / __fadd_rn, no FMA contraction), each
// square is the one warp_common.cuh:spline_at rounds per pixel, the sum is
// taken in its order, and the log is warp_common.cuh:log_core, the
// accurate logf's core path without its branches for inputs a spline
// never gives it (below 1e-6, subnormal, 0, negative), which chip_smoke.py
// holds bit-equal to logf on every float32 from 1e-6 up (8 of logf's 25
// instructions fewer per pixel and point). So the coordinates equal, bit
// for bit, those of spline_at (K3) and of the plain version in
// ops/tps.spline_eval run by PyTorch on the card; a pixel on a view's
// border then cannot flip between live and dead across them. Steps 2-4
// are warp_common.cuh's, shared with K3 and K4. The TPU kernel's window
// placement, (8, 128) tiling and overflow plane are not carried over: a
// thread reads any source pixel from global memory, so nothing can
// overflow. Rows and columns past the canvas edge evaluate the last
// row/column and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {
constexpr int kPix = 4;               // pixels per lane, 32 columns apart
constexpr int kTW = 32 * kPix;        // tile columns
constexpr int kTH = 16;               // tile rows, one warp each
constexpr int kThreads = 32 * kTH;

size_t smem_bytes(int P) {
  return static_cast<size_t>(P) * kTW * sizeof(float)      // dx^2
         + static_cast<size_t>(kTH) * P * sizeof(float4);  // tx, ty, dy^2
}
}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads) fused_warp_kernel(
    const uint8_t* __restrict__ im, const float* __restrict__ T,
    const float* __restrict__ src, const float* __restrict__ gx,
    const float* __restrict__ gy, float* __restrict__ out, int H, int W,
    int oh, int ow, int P) {
  extern __shared__ __align__(16) float sm[];
  float* sqx = sm;                                           // [P][kTW]
  float4* rows = reinterpret_cast<float4*>(sm + P * kTW);    // [kTH][P]
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTH;
  const int j0 = blockIdx.x * kTW;
  const float* tx = T + static_cast<size_t>(b) * 2 * (P + 3);
  const float* ty = tx + P + 3;
  const float* sS = src + static_cast<size_t>(b) * 2 * P;

  // the separable squares, rounded as spline_at rounds them
  for (int e = threadIdx.x; e < P * kTW; e += kThreads) {
    const int p = e / kTW;
    const int j = min(j0 + (e - p * kTW), ow - 1);
    const float dx = __fsub_rn(gx[j], sS[2 * p]);
    sqx[e] = __fmul_rn(dx, dx);
  }
  for (int e = threadIdx.x; e < kTH * P; e += kThreads) {
    const int r = e / P;
    const int p = e - r * P;
    const float dy = __fsub_rn(gy[min(i0 + r, oh - 1)], sS[2 * p + 1]);
    rows[e] = make_float4(tx[3 + p], ty[3 + p], __fmul_rn(dy, dy), 0.f);
  }
  __syncthreads();

  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = i0 + r;
  const float Y = gy[min(i, oh - 1)];
  float X[kPix], ax[kPix], ay[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    X[q] = gx[min(j0 + lane + 32 * q, ow - 1)];
    ax[q] = __fadd_rn(__fadd_rn(tx[0], __fmul_rn(tx[1], X[q])),
                      __fmul_rn(tx[2], Y));
    ay[q] = __fadd_rn(__fadd_rn(ty[0], __fmul_rn(ty[1], X[q])),
                      __fmul_rn(ty[2], Y));
  }
  const float4* rt = rows + r * P;
  const float* sx = sqx + lane;
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    const float4 t = rt[p];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const float d2 = __fadd_rn(sx[p * kTW + 32 * q], t.z);
      const float u =
          __fmul_rn(d2, stabstitch::log_core(__fadd_rn(d2, 1e-6f)));
      ax[q] = __fadd_rn(ax[q], __fmul_rn(t.x, u));
      ay[q] = __fadd_rn(ay[q], __fmul_rn(t.y, u));
    }
  }
  if (i >= oh) return;

  const size_t plane = static_cast<size_t>(oh) * ow;
  const uint8_t* img = im + 3 * static_cast<size_t>(b) * H * W;
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int j = j0 + lane + 32 * q;
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
  const size_t smem = smem_bytes(P);
  e = cudaFuncSetAttribute(fused_warp_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((ow + kTW - 1) / kTW, (oh + kTH - 1) / kTH, B);
  fused_warp_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(im, T, src, gx, gy,
                                                           out, H, W, oh, ow,
                                                           P);
  return static_cast<int>(cudaGetLastError());
}

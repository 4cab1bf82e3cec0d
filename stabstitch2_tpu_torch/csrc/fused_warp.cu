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
// (every thread of a block reads the same point, a broadcast). The TPU
// kernel's window placement, (8, 128) tiling and overflow plane are not
// carried over: a thread reads any source pixel from global memory, so
// nothing can overflow. Every product and sum is rounded separately
// (__fmul_rn / __fadd_rn, no FMA contraction) and the log is the accurate
// logf, so the coordinates equal, bit for bit, those of the plain version
// in ops/tps.spline_eval run by PyTorch on the card; a pixel on a view's
// border then cannot flip between live and dead across the two versions.

#include <cuda_runtime.h>
#include <stdint.h>

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
  const int nT = 2 * (P + 3);
  float* sT = sm;        // T[b]: rows x, y of P+3 coefficients
  float* sS = sm + nT;   // src[b]: P points (x, y)
  for (int t = threadIdx.x; t < nT; t += blockDim.x)
    sT[t] = T[static_cast<size_t>(b) * nT + t];
  for (int t = threadIdx.x; t < 2 * P; t += blockDim.x)
    sS[t] = src[static_cast<size_t>(b) * 2 * P + t];
  __syncthreads();

  const int npix = oh * ow;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  const int i = pix / ow;
  const int j = pix - i * ow;
  const float X = gx[j];
  const float Y = gy[i];
  const float* tx = sT;
  const float* ty = sT + P + 3;

  // 1. spline, same order as ops/tps.spline_eval and the TPU kernel
  float ax = __fadd_rn(__fadd_rn(tx[0], __fmul_rn(tx[1], X)), __fmul_rn(tx[2], Y));
  float ay = __fadd_rn(__fadd_rn(ty[0], __fmul_rn(ty[1], X)), __fmul_rn(ty[2], Y));
  for (int p = 0; p < P; ++p) {
    const float dx = __fsub_rn(X, sS[2 * p]);
    const float dy = __fsub_rn(Y, sS[2 * p + 1]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float u = __fmul_rn(d2, logf(__fadd_rn(d2, 1e-6f)));
    ax = __fadd_rn(ax, __fmul_rn(tx[3 + p], u));
    ay = __fadd_rn(ay, __fmul_rn(ty[3 + p], u));
  }

  // 2. corners and weights (ops/interp._patch_weights_idx)
  const float xf = __fmul_rn(__fadd_rn(ax, 1.f), 0.5f * static_cast<float>(W));
  const float yf = __fmul_rn(__fadd_rn(ay, 1.f), 0.5f * static_cast<float>(H));
  const float x0 = floorf(xf);
  const float y0 = floorf(yf);
  const float wmax = static_cast<float>(W - 1);
  const float hmax = static_cast<float>(H - 1);
  const float x0c = fminf(fmaxf(x0, 0.f), wmax);
  const float x1c = fminf(fmaxf(__fadd_rn(x0, 1.f), 0.f), wmax);
  const float y0c = fminf(fmaxf(y0, 0.f), hmax);
  const float y1c = fminf(fmaxf(__fadd_rn(y0, 1.f), 0.f), hmax);
  const float ax1 = __fsub_rn(x1c, xf), ax0 = __fsub_rn(xf, x0c);
  const float ay1 = __fsub_rn(y1c, yf), ay0 = __fsub_rn(yf, y0c);
  const float wa = __fmul_rn(ax1, ay1);
  const float wb = __fmul_rn(ax1, ay0);
  const float wc = __fmul_rn(ax0, ay1);
  const float wd = __fmul_rn(ax0, ay0);

  // 4. coverage mask: the four-weight sum, without the inside gate
  const float mask = __fadd_rn(__fadd_rn(__fadd_rn(wa, wb), wc), wd);

  // factored support: exactly zero at dead pixels, no cancellation noise
  const bool inside = (x0 >= 0.f) && (y0 >= 0.f);  // false for NaN
  const bool live =
      inside && __fmul_rn(__fsub_rn(x1c, x0c), __fsub_rn(y1c, y0c)) > 0.f;

  float vb = 0.f, vg = 0.f, vr = 0.f;
  if (live) {
    // 3. gather + combine (corners a=(y0,x0) b=(y1,x0) c=(y0,x1) d=(y1,x1))
    const int xi = static_cast<int>(x0c), yi = static_cast<int>(y0c);
    const size_t base = static_cast<size_t>(b) * H * W;
    const uint8_t* pa = im + 3 * (base + static_cast<size_t>(yi) * W + xi);
    const uint8_t* pc = pa + 3;
    const uint8_t* pb = pa + 3 * static_cast<size_t>(W);
    const uint8_t* pd = pb + 3;
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      v[ch] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(wa, static_cast<float>(pa[ch])),
                              __fmul_rn(wb, static_cast<float>(pb[ch]))),
                    __fmul_rn(wc, static_cast<float>(pc[ch]))),
          __fmul_rn(wd, static_cast<float>(pd[ch])));
    }
    vb = v[0];
    vg = v[1];
    vr = v[2];
  }
  const size_t plane = static_cast<size_t>(npix);
  float* o = out + static_cast<size_t>(b) * 4 * plane + pix;
  o[0] = vb;
  o[plane] = vg;
  o[2 * plane] = vr;
  o[3 * plane] = mask;
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

// Patch-gather kernel K4 for Hopper (sm_90a).
//
// Replaces the TPU kernel stabstitch2_tpu/ops/pallas_gather.py:_kernel
// (bilinear_sample_patch_u8_pallas): the NORMAL-mode bilinear sample of a
// uint8 BGR image at given normalized coordinates. For every output pixel
// n of image b, at (x, y) = (xs[b, n], ys[b, n]):
//   1. the corner/weight algebra of ops/interp._patch_weights_idx;
//   2. the four uint8 BGR corners read straight from the image (the +1
//      neighbours clamped to the last column and row, as
//      ops/interp._patch_corners_u8) and combined in the order of
//      ops/interp._combine_planes.
// A pixel outside the factored support, (x1c-x0c)*(y1c-y0c) == 0 or the
// low corner outside (NaN coordinates included), is dead: its B, G, R are
// exact zeros. Out: float32 interleaved [B, N, 3] (planes == 0) or three
// planes [B, 3, N] (planes != 0).
//
// Bound on the H100: bytes. A pixel reads 8 bytes of coordinates and at
// most 12 source bytes (mostly from L2: neighbouring pixels share
// corners) and writes 12 bytes, against ~30 float32 operations: on the
// main path's 16 x 448 x 608 canvas that is ~95 MB, ~29 us at 3.35 TB/s,
// against ~0.3 GFLOP, ~4 us at 67 TFLOP/s.
//
// Design: one thread per output pixel, reading its coordinates coalesced
// and its corners directly from the image in global memory. None of the
// TPU kernel's machinery is carried over: it exists because Mosaic cannot
// gather from HBM (window origins, the row-tile trip count, the int32
// BGR packing, the overflow flag and the repair leg). Nothing can
// overflow, so the wrapper's `viol` is constant False. The arithmetic is
// warp_common.cuh's, shared with K2, rounded op by op, so the samples
// equal those of the plain version run by PyTorch on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {
constexpr int kThreads = 256;
}

extern "C" __global__ void patch_gather_kernel(
    const uint8_t* __restrict__ im, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ out, int H, int W,
    int N, int planes) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t i = static_cast<size_t>(b) * N + n;
  const stabstitch::Corners c = stabstitch::corner_weights(xs[i], ys[i], H, W);
  float v[3] = {0.f, 0.f, 0.f};
  if (c.live)
    stabstitch::combine_bgr(im + 3 * static_cast<size_t>(b) * H * W, W, c, v);
  if (planes) {
    float* o = out + static_cast<size_t>(b) * 3 * N + n;
    o[0] = v[0];
    o[N] = v[1];
    o[2 * static_cast<size_t>(N)] = v[2];
  } else {
    float* o = out + 3 * i;
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
  }
}

// Launches on `stream` of card `device`; returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch (0 on success).
extern "C" int stabstitch_patch_gather(const uint8_t* im, const float* xs,
                                       const float* ys, float* out, int B,
                                       int H, int W, int N, int planes,
                                       int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((static_cast<unsigned>(N) + kThreads - 1) / kThreads, B);
  patch_gather_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(im, xs, ys, out,
                                                             H, W, N, planes);
  return static_cast<int>(cudaGetLastError());
}

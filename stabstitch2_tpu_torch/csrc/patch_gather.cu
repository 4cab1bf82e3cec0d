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
// against ~0.3 GFLOP, ~4 us at 67 TFLOP/s. The coordinates and the output
// are the traffic; the 16 source images (8.3 MB) stay in the 50 MB L2.
//
// Design. The work is the B x N pixels taken as one flat range, cut into
// pairs of consecutive pixels, one pair per thread per turn of a
// grid-stride loop over kWaves times the blocks the card holds at once,
// so the ragged end of an image idles no SM and a pair may straddle two
// images (N odd). A thread
//   - reads its pair's coordinates as one float2 from xs and one from ys
//     (neighbouring threads on neighbouring addresses), or as scalars
//     where the coordinate tensors are not 8-byte aligned (a contiguous
//     view at an odd offset) or the pair is the ragged tail;
//   - issues the corner reads of both its pixels before either combine. A
//     live pixel always has x1 == x0 + 1 and y1 == y0 + 1 (its support is
//     nonzero), so each of its two source rows is six adjacent bytes,
//     read as the two or three aligned words that hold them
//     (warp_common.cuh:load_bgr_pair: 4-6 loads a pixel, not 12), byte by
//     byte only where a word would leave the source tensor; dead pixels
//     read nothing;
//   - combines them with warp_common.cuh's arithmetic, rounded op by op in
//     the plain version's order (combine_bgr_pairs through combine_bgr's
//     blend_corners), so the samples equal those of the plain version run
//     by PyTorch on the card bit for bit;
//   - stores its 2 pixels x 3 channels as three float2s (24 contiguous
//     bytes, interleaved) or one float2 per plane (planar), where the
//     output is 8-byte aligned and the pair lies in one image; as scalars
//     where not.
// Two pixels a thread, not four: on the H100 four pixels a thread
// took over 60 registers, so half the threads an SM can hold, and its
// three float4 stores at a 48-byte stride ran slower than three float2s
// at 24 bytes; two pixels fit the 32 registers that keep the SM full
// (__launch_bounds__(kThreads, 8); with the planar path beside the
// interleaved one ptxas spills 8 bytes of the loop's state to L1). Stores
// staged through shared memory so that a warp writes 256 contiguous bytes
// were slower still. lab/k4_variants.py times these variants against
// this kernel.
// No shared-memory staging of the source, TMA or wgmma: the gather's
// addresses depend on each pixel's coordinates, so no source tile is
// known before they are read (the very reason the TPU kernel needed its
// window machinery); no matrix product is involved; and the one regular
// stream, the coordinates, is already read in vectors by neighbouring
// threads. None of the TPU kernel's machinery is carried over: it exists
// because Mosaic cannot gather from HBM (window origins, the row-tile
// trip count, the int32 BGR packing, the overflow flag and the repair
// leg). Nothing can overflow, so the wrapper's `viol` is constant False.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;    // 32 registers a thread: a full SM
constexpr int kWaves = 4;          // grid: this many times the resident blocks
constexpr int kPix = 2;            // consecutive pixels a thread
constexpr int kMaxDevices = 64;    // cards whose resident-block count is kept
}

extern "C" __global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    patch_gather_kernel(const uint8_t* __restrict__ im,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys, float* __restrict__ out,
                        int B, int H, int W, int N, int planes, int vec_xy,
                        int vec_out) {
  const size_t hw3 = 3 * static_cast<size_t>(H) * W;
  const uint8_t* im_end = im + hw3 * B;
  const int total = B * N;
  const int pairs = (total + kPix - 1) / kPix;
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < pairs;
       k += gridDim.x * kThreads) {
    const int i0 = k * kPix;
    const bool full = i0 + kPix <= total;
    float x[kPix], y[kPix];
    if (vec_xy && full) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(xs + i0));
      const float2 c = __ldg(reinterpret_cast<const float2*>(ys + i0));
      x[0] = a.x; x[1] = a.y;
      y[0] = c.x; y[1] = c.y;
    } else {
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const bool in = i0 + q < total;   // past the end: NaN, so dead
        x[q] = in ? __ldg(xs + i0 + q) : __int_as_float(0x7fc00000);
        y[q] = in ? __ldg(ys + i0 + q) : __int_as_float(0x7fc00000);
      }
    }
    // image and pixel of each of the pair's pixels
    int b[kPix], n[kPix];
    b[0] = i0 / N;
    n[0] = i0 - b[0] * N;
#pragma unroll
    for (int q = 1; q < kPix; ++q) {
      const bool wrap = n[q - 1] + 1 == N;
      b[q] = b[q - 1] + wrap;
      n[q] = wrap ? 0 : n[q - 1] + 1;
    }
    // every corner read issued before any combine
    stabstitch::Corners c[kPix];
    uint2 row0[kPix], row1[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      c[q] = stabstitch::corner_weights(x[q], y[q], H, W);
      row0[q] = row1[q] = make_uint2(0u, 0u);
      if (c[q].live) {
        const uint8_t* p =
            im + hw3 * b[q] + 3 * (static_cast<size_t>(c[q].y0) * W + c[q].x0);
        row0[q] = stabstitch::load_bgr_pair(p, im, im_end);
        row1[q] = stabstitch::load_bgr_pair(p + 3 * static_cast<size_t>(W),
                                            im, im_end);
      }
    }
    float v[kPix][3];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      v[q][0] = v[q][1] = v[q][2] = 0.f;
      if (c[q].live)
        stabstitch::combine_bgr_pairs(c[q], row0[q], row1[q], v[q]);
    }
    if (!planes) {
      float* o = out + 3 * static_cast<size_t>(i0);
      if (vec_out && full) {
        float2* o2 = reinterpret_cast<float2*>(o);
        o2[0] = make_float2(v[0][0], v[0][1]);
        o2[1] = make_float2(v[0][2], v[1][0]);
        o2[2] = make_float2(v[1][1], v[1][2]);
      } else {
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          if (i0 + q >= total) break;
          o[3 * q] = v[q][0];
          o[3 * q + 1] = v[q][1];
          o[3 * q + 2] = v[q][2];
        }
      }
    } else {
      const bool one_image = full && b[kPix - 1] == b[0];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const size_t at = (3 * static_cast<size_t>(b[0]) + ch) * N + n[0];
        if (vec_out && one_image && (at & 1) == 0) {
          *reinterpret_cast<float2*>(out + at) =
              make_float2(v[0][ch], v[1][ch]);
        } else {
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            if (i0 + q >= total) break;
            out[(3 * static_cast<size_t>(b[q]) + ch) * N + n[q]] = v[q][ch];
          }
        }
      }
    }
  }
}

// kWaves times the blocks of patch_gather_kernel that card `device` (the
// current one) holds at once, computed on its first launch there.
static int grid_blocks(int device, cudaError_t* e) {
  static int kept[kMaxDevices] = {0};
  if (device >= 0 && device < kMaxDevices && kept[device] > 0)
    return kept[device];
  int sms = 0, per_sm = 0;
  *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*e == cudaSuccess)
    *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, patch_gather_kernel, kThreads, 0);
  const int blocks = kWaves * sms * (per_sm > 0 ? per_sm : 1);
  if (*e == cudaSuccess && device >= 0 && device < kMaxDevices)
    kept[device] = blocks;
  return blocks;
}

// Launches on `stream` of card `device`, making it the current card only
// for the launch if it is not already; returns the first CUDA error of the
// set-up, the launch (cudaGetLastError()) or the restore (0 on success).
extern "C" int stabstitch_patch_gather(const uint8_t* im, const float* xs,
                                       const float* ys, float* out, int B,
                                       int H, int W, int N, int planes,
                                       int device, void* stream) {
  if (B <= 0 || N <= 0 ||
      static_cast<long long>(B) * N > INT_MAX - kPix)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = (B * N + kPix - 1) / kPix;
  int blocks = grid_blocks(device, &e);
  if (e == cudaSuccess) {
    const int needed = (pairs + kThreads - 1) / kThreads;
    blocks = blocks < needed ? blocks : needed;
    const int vec_xy =
        ((reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(ys)) &
         7) == 0;
    const int vec_out = (reinterpret_cast<uintptr_t>(out) & 7) == 0;
    patch_gather_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        im, xs, ys, out, B, H, W, N, planes, vec_xy, vec_out);
    e = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t r = cudaSetDevice(current);
    if (e == cudaSuccess) e = r;
  }
  return static_cast<int>(e);
}

// Design variants of the patch-gather kernel K4 (csrc/patch_gather.cu),
// timed against it on the card by lab/k4_variants.py. Every variant takes
// the interleaved layout of a contiguous [B, N] raster and computes the
// same samples as K4 (warp_common.cuh's arithmetic), except the "floor"
// ones, which move the same coordinate and output bytes and read no
// source: the time this traffic takes with no gather at all.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {
constexpr int kThreads = 256;
}

// K4 as first written: one pixel a thread, twelve byte loads a live pixel
__global__ void bytes_kernel(const uint8_t* __restrict__ im,
                           const float* __restrict__ xs,
                           const float* __restrict__ ys,
                           float* __restrict__ out, int H, int W, int N) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t i = static_cast<size_t>(b) * N + n;
  const stabstitch::Corners c = stabstitch::corner_weights(xs[i], ys[i], H, W);
  float v[3] = {0.f, 0.f, 0.f};
  if (c.live)
    stabstitch::combine_bgr(im + 3 * static_cast<size_t>(b) * H * W, W, c, v);
  out[3 * i] = v[0];
  out[3 * i + 1] = v[1];
  out[3 * i + 2] = v[2];
}

// P floats from/to 4P-byte-aligned memory as float2s (P == 2) or float4s
template <int P>
__device__ __forceinline__ void vload(const float* p, float (&v)[P]) {
  if constexpr (P == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (P == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  }
}

// 3P floats: three float2s (P == 2, 24 bytes) or three float4s (P == 4)
template <int P>
__device__ __forceinline__ void vstore(float* o, const float* f) {
  if constexpr (P == 4) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      reinterpret_cast<float4*>(o)[j] =
          make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
  } else if constexpr (P == 2) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      reinterpret_cast<float2*>(o)[j] = make_float2(f[2 * j], f[2 * j + 1]);
  }
}

// P consecutive pixels a thread (vector loads of P floats), grid-stride;
// kGather false: the floor; kStage: a warp's outputs staged through
// shared memory so that each store instruction writes 256 contiguous
// bytes (P == 2 only).
template <int P, int kMinBlocks, bool kGather, bool kStage>
__global__ void __launch_bounds__(kThreads, kMinBlocks) pix_kernel(
    const uint8_t* __restrict__ im, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ out, int B, int H,
    int W, int N) {
  __shared__ __align__(16) float stage[kStage ? kThreads * 3 * P : 1];
  const size_t hw3 = 3 * static_cast<size_t>(H) * W;
  const uint8_t* im_end = im + hw3 * B;
  const int total = B * N;
  const int units = (total + P - 1) / P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = blockIdx.x * kThreads + warp * 32; base < units;
       base += gridDim.x * kThreads) {
    const int k = base + lane;
    const int i0 = k * P;
    float v[P][3];
#pragma unroll
    for (int q = 0; q < P; ++q) v[q][0] = v[q][1] = v[q][2] = 0.f;
    if (k < units) {
      float x[P], y[P];
      if (P > 1 && i0 + P <= total) {   // aligned tensors: vector loads
        vload<P>(xs + i0, x);
        vload<P>(ys + i0, y);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const bool in = i0 + q < total;
          x[q] = in ? __ldg(xs + i0 + q) : __int_as_float(0x7fc00000);
          y[q] = in ? __ldg(ys + i0 + q) : __int_as_float(0x7fc00000);
        }
      }
      if (!kGather) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          v[q][0] = x[q];
          v[q][1] = y[q];
          v[q][2] = x[q] + y[q];
        }
      } else {
        int b[P], n[P];
        b[0] = i0 / N;
        n[0] = i0 - b[0] * N;
#pragma unroll
        for (int q = 1; q < P; ++q) {
          const bool wrap = n[q - 1] + 1 == N;
          b[q] = b[q - 1] + wrap;
          n[q] = wrap ? 0 : n[q - 1] + 1;
        }
        stabstitch::Corners c[P];
        uint2 r0[P], r1[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          c[q] = stabstitch::corner_weights(x[q], y[q], H, W);
          r0[q] = r1[q] = make_uint2(0u, 0u);
          if (c[q].live) {
            const uint8_t* p = im + hw3 * b[q] +
                               3 * (static_cast<size_t>(c[q].y0) * W + c[q].x0);
            r0[q] = stabstitch::load_bgr_pair(p, im, im_end);
            r1[q] = stabstitch::load_bgr_pair(p + 3 * static_cast<size_t>(W),
                                              im, im_end);
          }
        }
#pragma unroll
        for (int q = 0; q < P; ++q)
          if (c[q].live)
            stabstitch::combine_bgr_pairs(c[q], r0[q], r1[q], v[q]);
      }
    }
    const bool warp_full = (base + 32) * P <= total;
    if (kStage && warp_full) {
      float* s = stage + warp * 32 * 3 * P;
      vstore<P>(s + 3 * P * lane, &v[0][0]);
      __syncwarp();
      float2* o =
          reinterpret_cast<float2*>(out + 3 * static_cast<size_t>(base) * P);
      const float2* s2 = reinterpret_cast<const float2*>(s);
#pragma unroll
      for (int j = 0; j < 3 * P / 2; ++j) o[lane + 32 * j] = s2[lane + 32 * j];
      __syncwarp();
    } else if (k < units && P > 1 && i0 + P <= total) {
      vstore<P>(out + 3 * static_cast<size_t>(i0), &v[0][0]);
    } else if (k < units) {
      float* o = out + 3 * static_cast<size_t>(i0);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (i0 + q >= total) break;
        o[3 * q] = v[q][0];
        o[3 * q + 1] = v[q][1];
        o[3 * q + 2] = v[q][2];
      }
    }
  }
}

template <typename K>
static int launch(K kernel, int P, int waves, const uint8_t* im,
                  const float* xs, const float* ys, float* out, int B, int H,
                  int W, int N, void* stream) {
  const int needed = ((B * N + P - 1) / P + kThreads - 1) / kThreads;
  int blocks = needed;
  if (waves > 0) {
    int sms = 0, per = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0);
    blocks = waves * sms * per < needed ? waves * sms * per : needed;
  }
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      im, xs, ys, out, B, H, W, N);
  return static_cast<int>(cudaGetLastError());
}

// variant v: 0 the first K4, 1 one pixel a thread with word reads, 2
// four pixels a thread (registers unbounded), 3 two pixels with staged
// stores, 4 the floor of two pixels a thread over 4 waves, 5 the same
// floor with one pair a thread over the whole grid, 6 two pixels a
// thread interleaved only (K4 without its planar path) at 32 registers,
// 7 the same at 40
extern "C" int k4_variant(int v, const uint8_t* im, const float* xs,
                          const float* ys, float* out, int B, int H, int W,
                          int N, void* stream) {
  switch (v) {
    case 0: {
      dim3 grid((N + kThreads - 1) / kThreads, B);
      bytes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          im, xs, ys, out, H, W, N);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return launch(pix_kernel<1, 8, true, false>, 1, 4, im, xs, ys,
                          out, B, H, W, N, stream);
    case 2: return launch(pix_kernel<4, 1, true, false>, 4, 4, im, xs, ys,
                          out, B, H, W, N, stream);
    case 3: return launch(pix_kernel<2, 8, true, true>, 2, 4, im, xs, ys,
                          out, B, H, W, N, stream);
    case 4: return launch(pix_kernel<2, 8, false, false>, 2, 4, im, xs, ys,
                          out, B, H, W, N, stream);
    case 5: return launch(pix_kernel<2, 8, false, false>, 2, 0, im, xs, ys,
                          out, B, H, W, N, stream);
    case 6: return launch(pix_kernel<2, 8, true, false>, 2, 4, im, xs, ys,
                          out, B, H, W, N, stream);
    case 7: return launch(pix_kernel<2, 6, true, false>, 2, 4, im, xs, ys,
                          out, B, H, W, N, stream);
  }
  return -1;
}

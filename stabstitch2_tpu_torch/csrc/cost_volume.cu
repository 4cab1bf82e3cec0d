// Cost-volume kernel K1 for Hopper (sm_90a).
//
// Replaces the TPU kernel stabstitch2_tpu/ops/pallas_corr.py:_cv_kernel.
// out[b, y, x, dy*k + dx] = leaky_relu_0.1( mean_c x1[b, y, x, c] *
//                                           x2[b, y+dy-r, x+dx-r, c] ),
// k = 2r+1, with x2 zero outside the map. NHWC float32 in and out.
//
// Bound on the H100: balanced between memory and arithmetic. At
// [8, 45, 60, 128] and r = 5 the function reads 22.1 MB and writes 10.5 MB
// (9.7 us at 3.35 TB/s) and does 0.67 GFLOP, a multiply and an add per
// channel and shift (10.1 us at 67 TFLOP/s float32); at r = 3 on
// [16, 45, 60, 128] the bytes bound it (15.7 us against 8.2 us).
//
// Design: one block per (image b, output row y, row shift dy). The block
// stages x1's row y and x2's row y+dy-r in shared memory (2*W*C floats,
// 61 KB at W=60, C=128), so each map row is read from device memory once
// and re-read from L2 by the k blocks that share it. Each warp computes
// one (x, dx) dot product over C at a time: lane l takes channels
// l, l+32, ..., so the shared-memory reads are conflict-free, and a
// shuffle tree sums the lanes. A row of x2 outside the map is the zero
// padding: the block writes zeros and never builds a padded copy. Rows
// are staged with plain loads; TMA staging and wider tiles are later work.

#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 256;
}

extern "C" __global__ void cost_volume_kernel(const float* __restrict__ x1,
                                              const float* __restrict__ x2,
                                              float* __restrict__ out,
                                              int H, int W, int C, int r) {
  extern __shared__ float smem[];
  const int k = 2 * r + 1;
  const int kk = k * k;
  const int dy = blockIdx.x % k;
  const int row = blockIdx.x / k;  // b * H + y
  const int y = row % H;
  const int b = row / H;
  const int yy = y + dy - r;
  float* out_row = out + static_cast<size_t>(row) * W * kk;

  if (yy < 0 || yy >= H) {  // zero padding: every product is 0
    for (int o = threadIdx.x; o < W * k; o += blockDim.x) {
      const int x = o / k, dx = o - (o / k) * k;
      out_row[x * kk + dy * k + dx] = 0.f;
    }
    return;
  }

  float* s1 = smem;
  float* s2 = smem + W * C;
  const float* g1 = x1 + static_cast<size_t>(row) * W * C;
  const float* g2 = x2 + (static_cast<size_t>(b) * H + yy) * W * C;
  for (int i = threadIdx.x; i < W * C; i += blockDim.x) {
    s1[i] = g1[i];
    s2[i] = g2[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float inv_c = 1.f / static_cast<float>(C);
  for (int o = warp; o < W * k; o += nwarps) {
    const int x = o / k, dx = o - (o / k) * k;
    const int xx = x + dx - r;
    float v = 0.f;
    if (xx >= 0 && xx < W) {  // uniform across the warp
      const float* a = s1 + x * C;
      const float* c2 = s2 + xx * C;
      float acc = 0.f;
      for (int c = lane; c < C; c += 32) acc = fmaf(a[c], c2[c], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      v = acc * inv_c;
    }
    if (lane == 0) out_row[x * kk + dy * k + dx] = v >= 0.f ? v : 0.1f * v;
  }
}

// Launches on `stream` of card `device`; returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch (0 on success).
extern "C" int stabstitch_cost_volume(const float* x1, const float* x2,
                                      float* out, int B, int H, int W, int C,
                                      int r, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = 2 * static_cast<size_t>(W) * C * sizeof(float);
  e = cudaFuncSetAttribute(
      cost_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(B) * H * (2 * r + 1);
  cost_volume_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(x1, x2, out, H, W,
                                                            C, r);
  return static_cast<int>(cudaGetLastError());
}

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
// Design. A block owns kRows output rows (2 at r >= 4, 4 below) of one
// 32-column segment: the main path's [8, 45, 60, 128] at r = 5 is 368
// blocks of 176 threads, [16, 45, 60, 128] at r = 3 384 of 224, each grid
// one wave at 3 blocks per SM. The kRows rows share the k+kRows-1 rows of
// x2 they read, so each x2 row comes from L2 about (k+kRows-1)/kRows
// times instead of k times: with one row per block, moving those rows in
// took as long as the products. The block walks the channels in chunks
// of 16, staging its x1 rows and x2 rows (columns -r .. 32+r) in shared
// memory, channel-major, with the zero padding (rows and columns outside
// the map, channels past C) written as zeros, so the inner loop has no
// branches. A thread owns 4 consecutive columns of one output row and one
// dy, and all k dx: 4k accumulators in registers, fed per channel by one
// float4 of x1 and the 4+2r x2 values its columns slide over (float4
// reads; the 8 lanes of a quarter warp read 8 consecutive 16-byte words:
// no bank conflicts). Each output is summed in one thread, in channel
// order, with FMAs (the plain version's mean sums in another order:
// within 1e-5). The epilogue scales by 1/C, applies the leaky ReLU,
// collects each row's outputs in shared memory and writes them in one
// coalesced pass (float4 where aligned). Threads whose x2 row lies outside
// the map skip the products. The search range is a template parameter
// (0..7), so the accumulators stay in registers.
//
// Staging: the maps are channel-fastest (NHWC), the products want
// channel-major rows, so the copy transposes: a thread loads 16 bytes (4
// channels of one column; a warp reads 8 columns x 64 contiguous bytes),
// with a group of rows in flight, and stores them as 4 words. Variants
// with cp.async were slower on the H100: 4-byte copies into this layout
// cost 4x the instructions, and 16-byte copies need a channel-fastest
// layout whose reads conflict unless swizzled, which cost registers and
// spilled. With 3 blocks per SM, another block's products overlap a
// block's copy, and a second chunk buffer gained nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kXT = 4;                // consecutive columns per thread
constexpr int kSeg = 32;              // output columns per block
constexpr int kGroups = kSeg / kXT;   // column groups (threads per row, dy)
constexpr int kCC = 16;               // channels per staged chunk
constexpr int kQuads = kCC / 4;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// a row stride of 4 (mod 8) floats: a thread's column run starts on a
// 16-byte boundary, and stores from neighbouring channels spread over
// the banks
__host__ __device__ constexpr int row_stride(int n) {
  return n % 8 == 4 ? n : n + 4;
}

template <int R>
struct Geom {
  static constexpr int K = 2 * R + 1;
  // output rows per block: they share the x2 rows they read
  static constexpr int kRows = R >= 4 ? 2 : 4;
  static constexpr int KK = K * K;
  static constexpr int kRun = round_up(kXT + 2 * R, 4);  // x2 values / ch
  static constexpr int kW2 = kSeg - kXT + kRun;  // staged x2 columns
  static constexpr int kRows2 = K + kRows - 1;   // staged x2 rows
  static constexpr int kS1 = row_stride(kSeg);
  static constexpr int kS2 = row_stride(kW2);
  static constexpr int kStage =
      kRows * kCC * kS1 + kRows2 * kCC * kS2;  // floats
  static constexpr int kOut = kRows * kSeg * KK;
  static constexpr int kSmemFloats = kStage > kOut ? kStage : kOut;
  static constexpr int kThreads = kRows * K * kGroups;
  // blocks an SM must hold, so that the main path's grids run in one
  // wave on 132 SMs: 368 blocks of 176 threads at r = 5 and 384 of 224 at
  // r = 3, 3 per SM
  static constexpr int kMinBlocks = R >= 6 ? 1 : 3;
  // column lanes of the staging copy, a channel quad each
  static constexpr int kLanes = kThreads / kQuads;
};

// 4 channels from p on, zeros where !ok: one 16-byte load where VEC
// (C % 4 == 0 and both maps 16-byte aligned), else a word each, `left`
// of them (the channels before C); predicated loads, no branches
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool ok,
                                        int left) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (ok) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (ok) v.x = __ldg(p);
    if (ok && left > 1) v.y = __ldg(p + 1);
    if (ok && left > 2) v.z = __ldg(p + 2);
    if (ok && left > 3) v.w = __ldg(p + 3);
  }
  return v;
}

__device__ __forceinline__ void store4(float* dst, int stride, float4 v) {
  dst[0] = v.x;
  dst[stride] = v.y;
  dst[2 * stride] = v.z;
  dst[3 * stride] = v.w;
}

// Rows [D0, D1) of a staged column: 16-byte loads from `src` (a row,
// W*C floats, apart), all in flight before the transposing stores.
template <int D0, int D1, bool VEC>
__device__ __forceinline__ void copy_rows(float* dst, int dstride,
                                          const float* __restrict__ src,
                                          ptrdiff_t row, int y0, int H,
                                          bool x_ok, int left, int sstride) {
  float4 v[D1 - D0];
#pragma unroll
  for (int d = D0; d < D1; ++d) {
    const bool ok = x_ok && y0 + d >= 0 && y0 + d < H;
    v[d - D0] = load4<VEC>(src + d * row, ok, left);
  }
#pragma unroll
  for (int d = D0; d < D1; ++d)
    store4(dst + d * dstride, sstride, v[d - D0]);
}

// Stages channels c0..c0+kCC-1 of the block's kRows x1 rows ([row][c]
// [col], stride kS1) and of the k+kRows-1 x2 rows they need ([row][c]
// [col], stride kS2, columns -r ..), zeros outside the map. A thread
// takes one channel quad of one column (consecutive threads: the 4 quads
// of a column, 64 contiguous bytes) and walks the rows, 4 loads at a time.
template <int R, bool VEC>
__device__ __forceinline__ void stage_chunk(
    float* buf, const float* __restrict__ x1, const float* __restrict__ x2,
    int b, int y0, int xs, int H, int W, int C, int c0) {
  using G = Geom<R>;
  constexpr int N = G::kRows2;
  const int quad = threadIdx.x % kQuads;
  const int c = c0 + 4 * quad;
  const int left = C - c;
  const ptrdiff_t row = static_cast<ptrdiff_t>(W) * C;
  const ptrdiff_t base = static_cast<ptrdiff_t>(b) * H * row + c;
  for (int p = threadIdx.x / kQuads; p < G::kW2; p += G::kLanes) {
    if (p < kSeg) {
      const int x = xs + p;
      const bool ok = x < W && left > 0;
      const float* src =
          x1 + (ok ? base + y0 * row + static_cast<ptrdiff_t>(x) * C : 0);
      copy_rows<0, G::kRows, VEC>(buf + 4 * quad * G::kS1 + p, kCC * G::kS1,
                               src, ok ? row : 0, y0, H, ok, left, G::kS1);
    }
    const int x = xs - R + p;
    const bool ok = x >= 0 && x < W && left > 0;
    const float* src =
        x2 + (ok ? base + (y0 - R) * row + static_cast<ptrdiff_t>(x) * C : 0);
    float* dst = buf + G::kRows * kCC * G::kS1 + 4 * quad * G::kS2 + p;
    const ptrdiff_t step = ok ? row : 0;
    copy_rows<0, N < 4 ? N : 4, VEC>(dst, kCC * G::kS2, src, step, y0 - R, H,
                                     ok, left, G::kS2);
    if constexpr (N > 4)
      copy_rows<4, N < 8 ? N : 8, VEC>(dst, kCC * G::kS2, src, step, y0 - R,
                                       H, ok, left, G::kS2);
    if constexpr (N > 8)
      copy_rows<8, N < 12 ? N : 12, VEC>(dst, kCC * G::kS2, src, step,
                                         y0 - R, H, ok, left, G::kS2);
    if constexpr (N > 12)
      copy_rows<12, N < 16 ? N : 16, VEC>(dst, kCC * G::kS2, src, step,
                                          y0 - R, H, ok, left, G::kS2);
    if constexpr (N > 16)
      copy_rows<16, N, VEC>(dst, kCC * G::kS2, src, step, y0 - R, H, ok,
                            left, G::kS2);
  }
}

// A staged chunk into the accumulators: per channel one float4 of x1 (the
// thread's 4 columns) and the 4+2r x2 values they slide over.
template <int R>
__device__ __forceinline__ void multiply(const float* s1, const float* s2,
                                         float (&acc)[kXT][2 * R + 1]) {
  using G = Geom<R>;
#pragma unroll
  for (int c = 0; c < kCC; ++c) {
    const float4 av = *reinterpret_cast<const float4*>(s1 + c * G::kS1);
    const float a[kXT] = {av.x, av.y, av.z, av.w};
    float v[G::kRun];
#pragma unroll
    for (int q = 0; q < G::kRun / 4; ++q) {
      const float4 t =
          *reinterpret_cast<const float4*>(s2 + c * G::kS2 + 4 * q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < kXT; ++j)
#pragma unroll
      for (int d = 0; d < G::K; ++d)
        acc[j][d] = fmaf(a[j], v[j + d], acc[j][d]);
  }
}

}  // namespace

template <int R, bool VEC>
__global__ void __launch_bounds__(Geom<R>::kThreads, Geom<R>::kMinBlocks)
    cost_volume_kernel(const float* __restrict__ x1,
                       const float* __restrict__ x2, float* __restrict__ out,
                       int H, int W, int C) {
  using G = Geom<R>;
  constexpr int K = G::K;
  extern __shared__ __align__(16) float smem[];
  const int nseg = (W + kSeg - 1) / kSeg;
  const int nrow = (H + G::kRows - 1) / G::kRows;
  const int seg = blockIdx.x % nseg;
  const int rb = blockIdx.x / nseg;  // b * nrow + row group
  const int b = rb / nrow;
  const int y0 = (rb - b * nrow) * G::kRows;
  const int xs = seg * kSeg;
  const int seg_w = min(kSeg, W - xs);

  const int g = threadIdx.x % kGroups;
  const int dy = threadIdx.x / kGroups % K;
  const int ri = threadIdx.x / (kGroups * K);
  const int y = y0 + ri;
  const bool active =
      kXT * g < seg_w && y < H && y + dy - R >= 0 && y + dy - R < H;

  float acc[kXT][K];
#pragma unroll
  for (int j = 0; j < kXT; ++j)
#pragma unroll
    for (int d = 0; d < K; ++d) acc[j][d] = 0.f;

  const float* s1 = smem + ri * kCC * G::kS1 + kXT * g;
  const float* s2 =
      smem + G::kRows * kCC * G::kS1 + (ri + dy) * kCC * G::kS2 + kXT * g;
  for (int c0 = 0; c0 < C; c0 += kCC) {
    stage_chunk<R, VEC>(smem, x1, x2, b, y0, xs, H, W, C, c0);
    __syncthreads();
    if (active) multiply<R>(s1, s2, acc);
    __syncthreads();  // the buffer is free for the next chunk
  }

  // epilogue: scale, leaky ReLU, each row's segment of outputs through
  // shared memory ([row][col][dy*k + dx], the output row's order), then
  // one coalesced pass per row
  const float inv_c = 1.f / static_cast<float>(C);
#pragma unroll
  for (int j = 0; j < kXT; ++j)
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const float v = acc[j][d] * inv_c;
      smem[(ri * kSeg + kXT * g + j) * G::KK + dy * K + d] =
          v >= 0.f ? v : 0.1f * v;
    }
  __syncthreads();
  const int n = seg_w * G::KK;
  for (int r = 0; r < G::kRows && y0 + r < H; ++r) {
    const float* so = smem + r * kSeg * G::KK;
    float* dst =
        out + ((static_cast<size_t>(b) * H + y0 + r) * W + xs) * G::KK;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (n & 3) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(so);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = so[i];
    }
  }
}

namespace {

template <int R, bool VEC>
cudaError_t launch_as(const float* x1, const float* x2, float* out, int B,
                      int H, int W, int C, cudaStream_t stream) {
  using G = Geom<R>;
  const size_t smem = G::kSmemFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      cost_volume_kernel<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const unsigned blocks = static_cast<unsigned>(B) *
                          ((H + G::kRows - 1) / G::kRows) *
                          ((W + kSeg - 1) / kSeg);
  cost_volume_kernel<R, VEC><<<blocks, G::kThreads, smem, stream>>>(
      x1, x2, out, H, W, C);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch(const float* x1, const float* x2, float* out, int B, int H,
                   int W, int C, cudaStream_t stream) {
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(x1) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(x2) & 15) == 0;
  return vec ? launch_as<R, true>(x1, x2, out, B, H, W, C, stream)
             : launch_as<R, false>(x1, x2, out, B, H, W, C, stream);
}

}  // namespace

// Launches on `stream` of card `device`; returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch (0 on success), and
// cudaErrorInvalidValue for a search range outside 0..7
// (ops/corr_cuda.py MAX_SEARCH_RANGE).
extern "C" int stabstitch_cost_volume(const float* x1, const float* x2,
                                      float* out, int B, int H, int W, int C,
                                      int r, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 0: return static_cast<int>(launch<0>(x1, x2, out, B, H, W, C, s));
    case 1: return static_cast<int>(launch<1>(x1, x2, out, B, H, W, C, s));
    case 2: return static_cast<int>(launch<2>(x1, x2, out, B, H, W, C, s));
    case 3: return static_cast<int>(launch<3>(x1, x2, out, B, H, W, C, s));
    case 4: return static_cast<int>(launch<4>(x1, x2, out, B, H, W, C, s));
    case 5: return static_cast<int>(launch<5>(x1, x2, out, B, H, W, C, s));
    case 6: return static_cast<int>(launch<6>(x1, x2, out, B, H, W, C, s));
    case 7: return static_cast<int>(launch<7>(x1, x2, out, B, H, W, C, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

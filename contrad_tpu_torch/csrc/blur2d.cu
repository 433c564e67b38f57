// Separable 2-D FIR blur for NHWC tensors on Hopper (sm_90a).
//
// Replaces the TPU kernel contrad_tpu/ops/pallas_blur.py::pallas_blur2d
// (pl.pallas_call at pallas_blur.py:116): zero-pad x by (pad0, pad1) on both
// spatial dims, correlate with the vertical taps, then the horizontal taps,
// accumulating in f32. Output per dim: size + pad0 + pad1 - k + 1.
//
// What bounds it: HBM bytes. A 4-tap separable filter is 8 multiply-adds per
// output element, against at least 2 * sizeof(T) bytes of device memory
// traffic per element (~1 flop/byte in f32, far below the card's ~20
// flop/byte f32 ridge). So the design moves each byte once:
//   * a block owns one (n, TILE_H x TILE_W output tile, 32-channel slice) and
//     stages the (TILE_H + k - 1) x (TILE_W + k - 1) input window in shared
//     memory; the halo re-reads of neighbouring tiles hit L2, not HBM;
//   * zero padding is a mask on the load, never a padded copy in HBM;
//   * threadIdx.x walks channels, which are contiguous in NHWC, so each warp
//     load and store is one coalesced run of 32 channels;
//   * any C is accepted (the TPU's 128-lane rule does not apply): the last
//     channel slice masks its tail.
// The taps arrive by value as kernel arguments (no device buffer).
//
// C interface for ctypes: blur2d_nhwc(...) launches on the given stream and
// returns cudaGetLastError() (0 on success); it never synchronises and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 4;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kChan = 32;  // channels per block = blockDim.x
constexpr int kRows = 8;   // blockDim.y

struct Taps {
  float v[kMaxTaps];
  float h[kMaxTaps];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(kChan * kRows)
blur2d_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int C,
              int Ho, int Wo, int pad0, int tiles_w, Taps taps) {
  constexpr int kWinH = kTileH + K - 1;
  constexpr int kWinW = kTileW + K - 1;
  __shared__ float win[kWinH * kWinW][kChan];   // zero-padded input window
  __shared__ float vert[kTileH * kWinW][kChan];  // after the vertical taps

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.x * kChan + tx;
  const int oh0 = (blockIdx.y / tiles_w) * kTileH;
  const int ow0 = (blockIdx.y % tiles_w) * kTileW;
  const int64_t n = blockIdx.z;
  const bool c_ok = c < C;

  const T* xn = x + n * H * W * C;
  for (int p = ty; p < kWinH * kWinW; p += kRows) {
    const int ih = oh0 + p / kWinW - pad0;
    const int iw = ow0 + p % kWinW - pad0;
    float v = 0.f;
    if (c_ok && ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = load(xn + ((int64_t)ih * W + iw) * C + c);
    win[p][tx] = v;
  }
  __syncthreads();

  for (int p = ty; p < kTileH * kWinW; p += kRows) {
    const int r = p / kWinW;
    const int col = p % kWinW;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < K; ++a) acc += taps.v[a] * win[(r + a) * kWinW + col][tx];
    vert[p][tx] = acc;
  }
  __syncthreads();

  if (!c_ok) return;
  T* yn = y + n * Ho * Wo * C;
  for (int p = ty; p < kTileH * kTileW; p += kRows) {
    const int r = p / kTileW;
    const int col = p % kTileW;
    const int oh = oh0 + r;
    const int ow = ow0 + col;
    if (oh >= Ho || ow >= Wo) continue;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < K; ++b) acc += taps.h[b] * vert[r * kWinW + col + b][tx];
    store(yn + ((int64_t)oh * Wo + ow) * C + c, acc);
  }
}

template <typename T>
void launch(const void* x, void* y, int n, int h, int w, int c, int ho, int wo,
            int pad0, int k, const Taps& taps, cudaStream_t stream) {
  const int tiles_w = (wo + kTileW - 1) / kTileW;
  const int tiles_h = (ho + kTileH - 1) / kTileH;
  const dim3 grid((c + kChan - 1) / kChan, tiles_h * tiles_w, n);
  const dim3 block(kChan, kRows);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (k) {
    case 2:
      blur2d_kernel<T, 2><<<grid, block, 0, stream>>>(xt, yt, h, w, c, ho, wo, pad0, tiles_w, taps);
      break;
    case 3:
      blur2d_kernel<T, 3><<<grid, block, 0, stream>>>(xt, yt, h, w, c, ho, wo, pad0, tiles_w, taps);
      break;
    case 4:
      blur2d_kernel<T, 4><<<grid, block, 0, stream>>>(xt, yt, h, w, c, ho, wo, pad0, tiles_w, taps);
      break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. taps: k vertical taps then k horizontal.
extern "C" int blur2d_nhwc(const void* x, void* y, int n, int h, int w, int c,
                           int ho, int wo, int pad0, int k, const float* taps,
                           int dtype, void* stream) {
  if (k < 2 || k > kMaxTaps || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < k; ++i) {
    t.v[i] = taps[i];
    t.h[i] = taps[k + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, y, n, h, w, c, ho, wo, pad0, k, t, s);
  else
    launch<__nv_bfloat16>(x, y, n, h, w, c, ho, wo, pad0, k, t, s);
  return (int)cudaGetLastError();
}

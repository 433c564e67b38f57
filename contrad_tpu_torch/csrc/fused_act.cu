// Bias + leaky ReLU + gain for channels-last tensors on Hopper (sm_90a): one
// elementwise pass forward, one for the gradient with the bias gradient's
// partial sums taken in the same pass.
//
// Replaces no TPU kernel. The JAX package computes StyleGAN2's activation
// (contrad_tpu/ops/fused_act.py: x + b, leaky_relu, * gain) as an XLA
// expression, which XLA fuses into one pass and its gradient into another.
// Run as three PyTorch operators it costs three passes over the activation
// forward and three backward (the gain's, the leaky ReLU's, the bias sum).
//
// What bounds it: device-memory bytes. An element costs 2-3 flops against
// 2 * sizeof(T) bytes forward (read x, write out) and 3 * sizeof(T) for the
// gradient (read g and ref, write y), far below the card's ~20 flop/byte f32
// ridge. So the design moves each byte once and keeps loads in flight:
//   * mode act: out = (t > 0 ? t : t * slope) * gain, t = x + b[c].
//   * mode grad: y = (g + b[c]) * gain, times slope where ref <= 0; ref is
//     the forward's output, whose sign is that of x + b because gain > 0, so
//     the forward saves only its output. b is optional; (y, sum_rows y) is
//     the gradient (dx, db). The same mode with b = the upstream bias
//     gradient is this map's adjoint, so every derivative order (R1's double
//     backward) runs this kernel and no other.
//   * two memory layouts, as the port's activations come: channels
//     innermost (NHWC memory, and the MLP's (N, C)), and channel planes
//     (NCHW memory of an NHWC-shaped tensor: cuDNN returns it where its
//     input was, as D's images are). The output keeps the input's layout.
//     A gradient may arrive in the other layout than the forward's output
//     (a blur's adjoint gives channels innermost for D's channel planes at
//     512x512): bias_act_tiled_elementwise_kernel then reads it through
//     a 32 x 32 tile in shared memory and writes the output's layout, in
//     the same one pass, where a copy into that layout would be two more.
//   * a thread's channels stay fixed through its grid-stride loop, so their
//     bias values are loaded once and, in mode grad, their running sums stay
//     in registers: on rows, a thread owns one pack of channels and strides
//     over the rows; on planes, a block owns one channel (blockIdx.y) and its
//     threads stride over that channel's packs of every image. A block adds
//     its threads' sums in shared memory in a fixed order and writes one row
//     of partial sums; bias_grad_sum_kernel adds the partial rows in a fixed
//     order. The bias gradient is deterministic: no atomics.
//   * a thread moves 16 bytes at a time (4 float32 or 8 bfloat16 values of
//     one row's channels, or of one plane) and issues four such loads (two
//     of 8 bfloat16 values; two streams in mode grad) before it uses any,
//     within 64 registers and no spills. Neighbouring threads take
//     neighbouring packs, so a warp reads one contiguous run of 512 bytes.
//     Tensors where C * sizeof(T) (rows) or the plane's bytes (planes) are
//     not a multiple of 16, or whose data is not 16-byte aligned, take the
//     scalar path of this same source (one value a pack).
//   * float32 arithmetic in the plain expression's order (x + b, the branch,
//     then the gain; backward the gain, then the slope), with the rounding
//     intrinsics, which nvcc never contracts into an FMA, and each operator's
//     result rounded to the tensor's dtype as PyTorch's three operators round
//     it: outputs and input gradients equal the plain expression bitwise, in
//     float32 and in bfloat16.
//   * occupancy: blocks of at most 256 threads, at most 64 registers a thread
//     (__launch_bounds__), at most 8 KB of shared memory; the wrapper sizes
//     the grid to the tensor, at most about four blocks per SM
//     (ops/fused_act.py), so a small tensor takes few blocks and a large one
//     is one wave.
// Each kernel's name holds "elementwise" and none of "transpose", "copy",
// "sum" or "norm" (the benchmark's name -> class table, harness/trace.py),
// so its time counts as the elementwise passes it replaces; the partials'
// bias_grad_sum_kernel counts as a reduction.
// The wrapper (ops/fused_act.py::launch_plan) chooses the path and the work
// split and passes them as a BiasActPlan.
//
// C interface for ctypes: fused_act_nhwc(...) launches on the given stream
// and returns cudaGetLastError() (0 on success); it never synchronises and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch plan; field for field ops/fused_act.py::LaunchPlan. Outside the
// unnamed namespace: the C entry point takes it, and must keep its linkage.
struct BiasActPlan {
  int rows, c, inner, dtype, vector, planes, transpose, mode, has_bias;
  int partials, packs, cw, ry, threads, gx, gy, device;
};

namespace {

constexpr int kMaxThreads = 256;  // ops/fused_act.py::_MAX_THREADS
constexpr int kMinBlocks = 4;     // per SM: at most 64 registers a thread
constexpr int kUnroll = 4;        // ops/fused_act.py::_UNROLL; two where a
                                  // pack holds 8 bfloat16 values, whose
                                  // float32 sums would otherwise spill
constexpr int kSumLanes = 8;      // partial rows a sum block adds side by side
constexpr int kTile = 32;         // channels and pixels of a transposed tile
constexpr int kLines = kTile / (kMaxThreads / 32);  // tile lines a warp takes

// V values of one row or plane: 16 bytes on the vector path, one on the
// scalar.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T (a no-op for float32), as a PyTorch operator on a T
// tensor rounds its result.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// One value: mode act from x, mode grad from g and the forward's output r,
// in the plain expression's order and with its roundings.
template <typename T, bool kGrad>
__device__ __forceinline__ float bias_act(float v, float r, float b,
                                          bool has_bias, float slope,
                                          float gain) {
  if (has_bias) v = round_to<T>(__fadd_rn(v, b));
  if constexpr (kGrad) {
    v = round_to<T>(__fmul_rn(v, gain));
    if (!(r > 0.f)) v = round_to<T>(__fmul_rn(v, slope));
  } else {
    if (!(v > 0.f)) v = round_to<T>(__fmul_rn(v, slope));
    v = round_to<T>(__fmul_rn(v, gain));
  }
  return v;
}

// Channels innermost: the tensor is (rows, c). in: x (act) or g (grad);
// ref: the forward's output (grad); bias: b or null; partial: (gx, c)
// float32 partial sums of out over rows (grad with p.partials). Thread t of
// a block owns pack t % cw of the block's channel chunk and row lane t / cw;
// the block takes chunks of ry rows, chunk q of the tensor going to block
// q % gx.
template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
bias_act_elementwise_kernel(const T* __restrict__ in,
                            const T* __restrict__ ref,
                            const T* __restrict__ bias, T* __restrict__ out,
                            float* __restrict__ partial, const BiasActPlan p,
                            const float slope, const float gain) {
  using P = Pack<T, V>;
  __shared__ float lanes[kMaxThreads * V];
  const int tx = threadIdx.x % p.cw;
  const int ty = threadIdx.x / p.cw;
  const int pk = blockIdx.y * p.cw + tx;
  const bool own = pk < p.packs;
  const int64_t col = (int64_t)pk * V;

  P bv;  // this thread's channels' bias
#pragma unroll
  for (int i = 0; i < V; ++i)
    bv.v[i] = (own && p.has_bias) ? bias[col + i] : from_f<T>(0.f);
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  const int64_t chunks = ((int64_t)p.rows + p.ry - 1) / p.ry;
  const int64_t stride = p.gx;
  constexpr int U = V > 4 ? 2 : kUnroll;
  for (int64_t q0 = blockIdx.x; q0 < chunks; q0 += stride * U) {
    P a[U], r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = (q0 + u * stride) * p.ry + ty;
      if (own && row < p.rows) {
        a[u] = *reinterpret_cast<const P*>(in + row * p.c + col);
        if constexpr (kGrad)
          r[u] = *reinterpret_cast<const P*>(ref + row * p.c + col);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = (q0 + u * stride) * p.ry + ty;
      if (!own || row >= p.rows) continue;
      P o;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        o.v[i] = from_f<T>(bias_act<T, kGrad>(
            to_f(a[u].v[i]), kGrad ? to_f(r[u].v[i]) : 0.f, to_f(bv.v[i]),
            p.has_bias, slope, gain));
        if constexpr (kGrad) acc[i] = __fadd_rn(acc[i], to_f(o.v[i]));
      }
      *reinterpret_cast<P*>(out + row * p.c + col) = o;
    }
  }

  if constexpr (kGrad) {
    if (p.partials) {  // the same for the whole grid
#pragma unroll
      for (int i = 0; i < V; ++i) lanes[threadIdx.x * V + i] = acc[i];
      __syncthreads();
      if (ty == 0 && own) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float s = 0.f;
          for (int j = 0; j < p.ry; ++j)
            s = __fadd_rn(s, lanes[(j * p.cw + tx) * V + i]);
          partial[(int64_t)blockIdx.x * p.c + col + i] = s;
        }
      }
    }
  }
}

// Channel planes: the tensor is (rows, c, inner) in memory, rows the
// images, inner the pixels of a plane, p.packs packs a plane. Block (bx, c)
// takes channel c's packs j = bx * threads + t, then every gx * threads
// further, over the planes of every image in turn; partial[bx][c] is its
// threads' sum.
template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
bias_act_planes_elementwise_kernel(const T* __restrict__ in,
                                   const T* __restrict__ ref,
                                   const T* __restrict__ bias,
                                   T* __restrict__ out,
                                   float* __restrict__ partial,
                                   const BiasActPlan p, const float slope,
                                   const float gain) {
  using P = Pack<T, V>;
  __shared__ float lanes[kMaxThreads];
  const int c = blockIdx.y;
  const float bc = p.has_bias ? to_f(bias[c]) : 0.f;
  const unsigned spk = p.packs;
  const unsigned total = (unsigned)p.rows * spk;  // < 2**31: ops/fused_act.py
  const unsigned step = p.gx * blockDim.x;
  float acc = 0.f;
  constexpr int U = V > 4 ? 2 : kUnroll;
  for (unsigned j0 = blockIdx.x * blockDim.x + threadIdx.x; j0 < total;
       j0 += step * U) {
    P a[U], r[U];
    int64_t off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned j = j0 + u * step;
      off[u] = -1;
      if (j < total) {
        const unsigned n = j / spk;
        off[u] = ((int64_t)n * p.c + c) * p.inner + (int64_t)(j - n * spk) * V;
        a[u] = *reinterpret_cast<const P*>(in + off[u]);
        if constexpr (kGrad) r[u] = *reinterpret_cast<const P*>(ref + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (off[u] < 0) continue;
      P o;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        o.v[i] = from_f<T>(bias_act<T, kGrad>(
            to_f(a[u].v[i]), kGrad ? to_f(r[u].v[i]) : 0.f, bc, p.has_bias,
            slope, gain));
        if constexpr (kGrad) acc = __fadd_rn(acc, to_f(o.v[i]));
      }
      *reinterpret_cast<P*>(out + off[u]) = o;
    }
  }

  if constexpr (kGrad) {
    if (p.partials) {  // the same for the whole grid
      lanes[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int j = 0; j < (int)blockDim.x; ++j) s = __fadd_rn(s, lanes[j]);
        partial[(int64_t)blockIdx.x * p.c + c] = s;
      }
    }
  }
}

// Mode grad with g in the other layout than ref and out: the tensor is
// rows images of p.inner pixels and c channels; kRefPlanes: ref and out in
// channel planes, g channels innermost; else the reverse. Block (bx, ct)
// takes the tiles of channels [32 ct, 32 ct + 32) and 32 pixels of one
// image, tile t = bx, bx + gx, ...: it loads g's tile into shared memory
// (warp w its lines 4w .. 4w + 3, each a coalesced run in g's layout) and
// ref's values in ref's layout into registers, then computes and stores in
// ref's layout. A thread's channels stay fixed (kRefPlanes: the channels of
// its lines; else its lane's), so its bias values and sums do;
// partial[bx][c] adds them over the block in a fixed order.
template <typename T, bool kRefPlanes>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
bias_act_tiled_elementwise_kernel(const T* __restrict__ in,
                                      const T* __restrict__ ref,
                                      const T* __restrict__ bias,
                                      T* __restrict__ out,
                                      float* __restrict__ partial,
                                      const BiasActPlan p, const float slope,
                                      const float gain) {
  __shared__ float tile[kTile][kTile + 1];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c0 = blockIdx.y * kTile;
  const int64_t S = p.inner, C = p.c;
  const int64_t stiles = (S + kTile - 1) / kTile;
  const int64_t tiles = (int64_t)p.rows * stiles;

  // the channel of line k of this warp's (kRefPlanes) or of its lane
  float bv[kLines], acc[kLines];
#pragma unroll
  for (int k = 0; k < kLines; ++k) {
    const int64_t c = kRefPlanes ? c0 + warp * kLines + k : c0 + lane;
    bv[k] = (p.has_bias && c < C) ? to_f(bias[c]) : 0.f;
    acc[k] = 0.f;
  }
  for (int64_t t = blockIdx.x; t < tiles; t += p.gx) {
    const int64_t n = t / stiles;
    const int64_t s0 = (t - n * stiles) * kTile;
    float r[kLines];
    int64_t off[kLines];
#pragma unroll
    for (int k = 0; k < kLines; ++k) {
      const int line = warp * kLines + k;
      // g's line: a pixel's channels (g innermost) or a channel's pixels
      const int64_t gs = kRefPlanes ? s0 + line : s0 + lane;
      const int64_t gc = kRefPlanes ? c0 + lane : c0 + line;
      tile[line][lane] =
          (gs < S && gc < C)
              ? to_f(in[kRefPlanes ? (n * S + gs) * C + gc
                                   : (n * C + gc) * S + gs])
              : 0.f;
      // ref's line, in ref's layout: a channel's pixels or a pixel's channels
      const int64_t rs = kRefPlanes ? s0 + lane : s0 + line;
      const int64_t rc = kRefPlanes ? c0 + line : c0 + lane;
      off[k] = (rs < S && rc < C) ? (kRefPlanes ? (n * C + rc) * S + rs
                                                : (n * S + rs) * C + rc)
                                  : -1;
      r[k] = off[k] >= 0 ? to_f(ref[off[k]]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kLines; ++k) {
      if (off[k] < 0) continue;
      const T o = from_f<T>(bias_act<T, true>(tile[lane][warp * kLines + k],
                                           r[k], bv[k], p.has_bias, slope,
                                           gain));
      out[off[k]] = o;
      acc[k] = __fadd_rn(acc[k], to_f(o));
    }
    __syncthreads();
  }

  if (p.partials) {  // the same for the whole grid
    // kRefPlanes: tile[channel][lane] = a lane's sum; else
    // tile[warp][channel] = a warp's sum of its lines
    if (kRefPlanes) {
#pragma unroll
      for (int k = 0; k < kLines; ++k) tile[warp * kLines + k][lane] = acc[k];
    } else {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kLines; ++k) s = __fadd_rn(s, acc[k]);
      tile[warp][lane] = s;
    }
    __syncthreads();
    if (threadIdx.x < kTile && c0 + threadIdx.x < C) {
      float s = 0.f;
      const int m = kRefPlanes ? 32 : kMaxThreads / 32;
      for (int j = 0; j < m; ++j)
        s = __fadd_rn(s, kRefPlanes ? tile[threadIdx.x][j]
                                    : tile[j][threadIdx.x]);
      partial[(int64_t)blockIdx.x * C + c0 + threadIdx.x] = s;
    }
  }
}

// db[c] = the sum of partial[k][c] over the gx partial rows: lane l of a
// block's 32 channels adds rows k = l, l + kSumLanes, ... in order, then the
// kSumLanes lanes' sums are added in order.
template <typename T>
__global__ void __launch_bounds__(32 * kSumLanes)
bias_grad_sum_kernel(const float* __restrict__ partial, T* __restrict__ db,
                     const int rows, const int c) {
  __shared__ float lanes[kSumLanes][32];
  const int l = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + threadIdx.x % 32;
  float s = 0.f;
  if (ch < c)
    for (int k = l; k < rows; k += kSumLanes)
      s = __fadd_rn(s, partial[(int64_t)k * c + ch]);
  lanes[l][threadIdx.x % 32] = s;
  __syncthreads();
  if (l == 0 && ch < c) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kSumLanes; ++j)
      t = __fadd_rn(t, lanes[j][threadIdx.x]);
    db[ch] = from_f<T>(t);
  }
}

template <typename T, int V>
void launch(const void* in, const void* ref, const void* bias, void* out,
            void* partial, void* db, const BiasActPlan& p, float slope,
            float gain, cudaStream_t stream) {
  const dim3 grid(p.gx, p.gy);
  const T* x = static_cast<const T*>(in);
  const T* rf = static_cast<const T*>(ref);
  const T* b = static_cast<const T*>(bias);
  T* y = static_cast<T*>(out);
  float* part = static_cast<float*>(partial);
  if (p.transpose) {
    if (p.planes)
      bias_act_tiled_elementwise_kernel<T, true>
          <<<grid, p.threads, 0, stream>>>(x, rf, b, y, part, p, slope, gain);
    else
      bias_act_tiled_elementwise_kernel<T, false>
          <<<grid, p.threads, 0, stream>>>(x, rf, b, y, part, p, slope, gain);
  } else if (p.planes) {
    if (p.mode == 0)
      bias_act_planes_elementwise_kernel<T, V, false>
          <<<grid, p.threads, 0, stream>>>(x, rf, b, y, part, p, slope, gain);
    else
      bias_act_planes_elementwise_kernel<T, V, true>
          <<<grid, p.threads, 0, stream>>>(x, rf, b, y, part, p, slope, gain);
  } else {
    if (p.mode == 0)
      bias_act_elementwise_kernel<T, V, false>
          <<<grid, p.threads, 0, stream>>>(x, rf, b, y, part, p, slope, gain);
    else
      bias_act_elementwise_kernel<T, V, true>
          <<<grid, p.threads, 0, stream>>>(x, rf, b, y, part, p, slope, gain);
  }
  if (p.partials) {
    bias_grad_sum_kernel<T><<<(p.c + 31) / 32, 32 * kSumLanes, 0, stream>>>(
        part, static_cast<T*>(db), p.gx, p.c);
  }
}

}  // namespace

// plan->dtype: 0 = float32, 1 = bfloat16; plan->vector: 16-byte packs (1)
// or one value (0); plan->planes: ref and out in channel planes (1) or
// channels innermost (0); plan->transpose: in (g) in the other layout
// (mode grad); plan->mode: 0 = act, 1 = grad. partial is (gx, c)
// float32 scratch and db the (c,) bias gradient, both used only in mode
// grad with plan->partials.
extern "C" int fused_act_nhwc(const void* in, const void* ref,
                              const void* bias, void* out, void* partial,
                              void* db, const BiasActPlan* plan, float slope,
                              float gain, void* stream) {
  const BiasActPlan& p = *plan;
  if ((p.dtype != 0 && p.dtype != 1) || (p.mode != 0 && p.mode != 1) ||
      p.threads < 1 || p.threads > kMaxThreads ||
      (p.transpose && (p.mode != 1 || p.threads != kMaxThreads ||
                       p.gy != (p.c + kTile - 1) / kTile)) ||
      (!p.transpose && !p.planes && p.cw * p.ry != p.threads) ||
      (!p.transpose && p.planes && p.gy != p.c) ||
      p.gx < 1 || p.gy < 1 || (p.partials && p.mode != 1) ||
      (p.mode == 1 && ref == nullptr) || (p.has_bias && bias == nullptr) ||
      (p.partials && (partial == nullptr || db == nullptr)))
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  if (current != p.device) cudaSetDevice(p.device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (p.dtype == 0 && p.vector)
    launch<float, 4>(in, ref, bias, out, partial, db, p, slope, gain, s);
  else if (p.dtype == 0)
    launch<float, 1>(in, ref, bias, out, partial, db, p, slope, gain, s);
  else if (p.vector)
    launch<BF, 8>(in, ref, bias, out, partial, db, p, slope, gain, s);
  else
    launch<BF, 1>(in, ref, bias, out, partial, db, p, slope, gain, s);
  const int err = (int)cudaGetLastError();
  if (current != p.device) cudaSetDevice(current);
  return err;
}

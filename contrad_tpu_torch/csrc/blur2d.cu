// Separable 2-D FIR blur for NHWC tensors on Hopper (sm_90a): a row stream.
//
// Replaces the TPU kernel contrad_tpu/ops/pallas_blur.py::pallas_blur2d
// (pl.pallas_call at pallas_blur.py:116): zero-pad x by (pad0, pad1) on both
// spatial dims and correlate with k <= 4 vertical and k horizontal taps,
// accumulating in f32. Output per dim: size + pad0 + pad1 - k + 1.
//
// What bounds it: HBM bytes. A 4-tap separable filter is 8 multiply-adds per
// output element against at least 2 * sizeof(T) bytes of device memory
// traffic (~1 flop/byte in f32, far below the card's ~20 flop/byte f32
// ridge). So the design reads each input byte once, keeps every load in
// flight early, and wastes no thread on a slot outside the output:
//   * work items fit the output: a block owns one image, a strip of `rows`
//     output rows, a segment of `wseg` output columns (the full width where
//     it fits in one block) and a range of `gb` channel packs; each thread
//     owns one (column, pack) for the whole strip. No 2-D tile is rounded
//     up; only the block's last warp can hold idle threads.
//   * the strip's input rows stream through a ring of kStages row buffers in
//     shared memory, filled with cp.async 16-byte copies kStages - 1 rows
//     ahead of the arithmetic. The copy's zero fill (src-size 0) is the zero
//     padding, at the row ends and above and below the image alike. cp.async
//     rather than TMA: its per-thread masks take any width and any pad, and
//     the scalar path below needs the same ring without TMA's 16-byte
//     stride rule.
//   * each row is summed horizontally from shared memory, then added into a
//     sliding window of k vertical partial sums held in registers and
//     rolled row by row; one __syncthreads per row. The input is re-read
//     only at strip edges (k - 1 rows) and segment edges (k - 1 columns),
//     from L2. Summing horizontally first changes the f32 summation order
//     against the TPU kernel's vertical-then-horizontal; the difference
//     stays within a few ulps, inside the stated 1e-5 tolerances.
//   * a thread moves 16 bytes at a time: 4 float32 or 8 bfloat16 channels.
//     Threads walk (column, pack) with the pack fastest, so where a block
//     holds all of C the warp spans neighbouring pixels, contiguous in NHWC:
//     every warp access is one coalesced run of 512 bytes.
//   * tensors where C * sizeof(T) is not a multiple of 16, or whose data is
//     not 16-byte aligned, take the scalar path of this same source (one
//     channel per pack, plain loads into the same ring).
//   * occupancy: a block has at most 256 threads, at most 64 registers a
//     thread (__launch_bounds__) and at most 22.5 KB of shared memory (4
//     rows of (wseg + 3) * gb packs of 16 bytes, wseg * gb <= 256, gb <=
//     32), so four blocks (32 warps) share an SM. The wrapper cuts strips
//     of at least 8 rows until the grid holds about eight blocks per SM.
//     These sizes were chosen on the card against 512-576-thread blocks,
//     4-row strips and 2- and 8-row rings.
// The wrapper (ops/blur.py::launch_plan) chooses the path and the work split
// and passes it as a Blur2dPlan; the taps arrive by value.
//
// C interface for ctypes: blur2d_nhwc(...) launches on the given stream and
// returns cudaGetLastError() (0 on success); it never synchronises and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch plan; field for field ops/blur.py::LaunchPlan. Outside the
// unnamed namespace: the C entry point takes it, and must keep its linkage.
struct Blur2dPlan {
  int n, h, w, c, ho, wo, pad0, k, dtype, vector;
  int groups, gb, csplit, wseg, nseg, rows, strips, threads, smem, device;
};

namespace {

constexpr int kMaxTaps = 4;
constexpr int kStages = 4;        // input rows in the shared-memory ring
constexpr int kMaxThreads = 256;  // ops/blur.py::_MAX_THREADS
constexpr int kMinBlocks = 4;     // per SM: at most 64 registers a thread
static_assert((kStages & (kStages - 1)) == 0, "the ring index is a mask");

struct Taps {
  float v[kMaxTaps];
  float h[kMaxTaps];
};

// V channels of one pixel: 16 bytes on the vector path, one on the scalar.
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

// One pack from device memory into the ring; zeros where !ok.
template <typename T, int V>
__device__ __forceinline__ void copy_pack(Pack<T, V>* dst, const T* src,
                                          bool ok) {
  if constexpr (sizeof(Pack<T, V>) == 16) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
  } else {
    Pack<T, V> p;
#pragma unroll
    for (int i = 0; i < V; ++i) p.v[i] = ok ? src[i] : from_f<T>(0.f);
    *dst = p;
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int V, int K>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
blur2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Blur2dPlan p,
              const Taps taps) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  P* ring = reinterpret_cast<P*>(smem);
  const int stage = (p.wseg + K - 1) * p.gb;  // packs per ring row

  int b = blockIdx.x;
  const int cs = b % p.csplit;
  b /= p.csplit;
  const int seg = b % p.nseg;
  const int strip = b / p.nseg;
  const int64_t n = blockIdx.y;
  const int oh0 = strip * p.rows;
  const int ow0 = seg * p.wseg;
  const int g0 = cs * p.gb;
  const int rows_in = min(p.rows, p.ho - oh0) + K - 1;
  const int t = threadIdx.x;

  // The packs this thread copies into every ring row: at most K, since a row
  // holds (wseg + K - 1) * gb <= K * blockDim.x packs. src[j] is the pack's
  // offset in an input row, -1 where it lies in the padding, -2 for none.
  int src[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = t + j * blockDim.x;
    src[j] = -2;
    if (s < stage) {
      const int lc = s / p.gb;
      const int g = g0 + s - lc * p.gb;
      const int iw = ow0 - p.pad0 + lc;
      src[j] = (iw >= 0 && iw < p.w && g < p.groups) ? iw * p.c + g * V : -1;
    }
  }
  const T* xn = x + n * p.h * p.w * p.c;
  auto load_row = [&](int r) {
    const int ih = oh0 + r - p.pad0;
    const bool row_ok = ih >= 0 && ih < p.h;
    const T* xr = xn + (int64_t)(row_ok ? ih : 0) * p.w * p.c;
    P* dst = ring + (r & (kStages - 1)) * stage + t;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (src[j] == -2) continue;
      const bool ok = row_ok && src[j] >= 0;
      copy_pack<T, V>(dst + j * blockDim.x, ok ? xr + src[j] : x, ok);
    }
  };

  // The output column and channel pack this thread computes.
  const int col = t / p.gb;
  const int gl = t - col * p.gb;
  const bool active = col < min(p.wseg, p.wo - ow0) && g0 + gl < p.groups;
  const int64_t y_row = (int64_t)p.wo * p.c;
  T* yp = y + (n * p.ho + oh0) * y_row + (int64_t)(ow0 + col) * p.c +
          (g0 + gl) * V;

  // acc[j]: the partial sum of output row r - (K - 1) + j after input row r.
  float acc[K][V];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) {
    if (r < rows_in) load_row(r);
    commit_copies();
  }
  for (int r = 0; r < rows_in; ++r) {
    wait_copies<kStages - 2>();  // row r has landed (this thread's copies)
    __syncthreads();             // ... everyone's; and row r - 1 is consumed
    if (r + kStages - 1 < rows_in) load_row(r + kStages - 1);
    commit_copies();
    if (!active) continue;
    const P* q = ring + (r & (kStages - 1)) * stage + col * p.gb + gl;
    float hs[V];
#pragma unroll
    for (int i = 0; i < V; ++i) hs[i] = 0.f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const P v = q[a * p.gb];
#pragma unroll
      for (int i = 0; i < V; ++i) hs[i] = fmaf(taps.h[a], to_f(v.v[i]), hs[i]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[j][i] = fmaf(taps.v[K - 1 - j], hs[i], acc[j][i]);
    if (r >= K - 1) {
      P out;
#pragma unroll
      for (int i = 0; i < V; ++i) out.v[i] = from_f<T>(acc[0][i]);
      *reinterpret_cast<P*>(yp + (r - (K - 1)) * y_row) = out;
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j][i] = acc[j + 1][i];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[K - 1][i] = 0.f;
  }
}

template <typename T, int V, int K>
void launch_k(const void* x, void* y, const Blur2dPlan& p, const Taps& taps,
              cudaStream_t stream) {
  const dim3 grid(p.strips * p.nseg * p.csplit, p.n);
  blur2d_kernel<T, V, K><<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p, taps);
}

template <typename T, int V>
void launch(const void* x, void* y, const Blur2dPlan& p, const Taps& taps,
            cudaStream_t stream) {
  switch (p.k) {
    case 1: launch_k<T, V, 1>(x, y, p, taps, stream); break;
    case 2: launch_k<T, V, 2>(x, y, p, taps, stream); break;
    case 3: launch_k<T, V, 3>(x, y, p, taps, stream); break;
    case 4: launch_k<T, V, 4>(x, y, p, taps, stream); break;
  }
}

}  // namespace

// taps: k vertical taps then k horizontal. plan->dtype: 0 = float32,
// 1 = bfloat16; plan->vector: 16-byte packs (1) or one channel (0).
extern "C" int blur2d_nhwc(const void* x, void* y, const Blur2dPlan* plan,
                           const float* taps, void* stream) {
  const Blur2dPlan& p = *plan;
  if (p.k < 1 || p.k > kMaxTaps || (p.dtype != 0 && p.dtype != 1) ||
      p.threads < 1 || p.threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int i = 0; i < p.k; ++i) {
    t.v[i] = taps[i];
    t.h[i] = taps[p.k + i];
  }
  int current = 0;
  cudaGetDevice(&current);
  if (current != p.device) cudaSetDevice(p.device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0) {
    if (p.vector) launch<float, 4>(x, y, p, t, s);
    else launch<float, 1>(x, y, p, t, s);
  } else {
    if (p.vector) launch<__nv_bfloat16, 8>(x, y, p, t, s);
    else launch<__nv_bfloat16, 1>(x, y, p, t, s);
  }
  const int err = (int)cudaGetLastError();
  if (current != p.device) cudaSetDevice(current);
  return err;
}

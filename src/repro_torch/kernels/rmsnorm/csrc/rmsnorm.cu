// Hand-written Hopper (sm_90a) kernels for row RMSNorm.
//
// Replaces (JAX package) kernels/rmsnorm/kernel.py::rmsnorm (:27, pallas_call
// :33): out = x * rsqrt(mean(x^2) + eps) * w per row, computed in f32 and
// stored in x's dtype.  Takes x and w in f32 or bf16 (independently).  Plain
// C interface (extern "C", raw pointers, the stream as void*), built by nvcc
// at first use and bound with ctypes by ../kernel.py; the entry point returns
// the CUDA error of its launch.
//
// What bounds it on this card: a few flops per element, so bytes (x read
// once, out written once, w read once): 9.4 MB at smollm's prefill (4096 x
// 576 bf16, 2.8 us at 3.35 TB/s), 33.6 MB at falcon's (2048 x 4096, 10.0
// us), 9 KB at a decode step's 8 x 576 rows, where the launch itself is the
// bound.  Measured (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3 at a 700 W
// power limit): 0.0036 ms of device time per launch at 4096 x 576,
// 0.0078-0.0080 ms at 2048 x 4096 (under the HBM bound: the repeated calls
// find their input in the 50 MB L2), 0.0022-0.0023 ms at 8 x 576.
//
// Design (rmsnorm_row_kernel, the path of every row whose 16-byte vectors
// line up: D * sizeof(x) a multiple of 16, at most 1024 vectors; x and out
// must then be 16-byte aligned, as ../kernel.py sees to, else the launch
// returns cudaErrorMisalignedAddress).  One pass: each row is read from
// device memory once, into registers, its sum of squares reduced with warp
// shuffles (and shared memory across the row's warps), then scaled and
// stored from the same registers.  A row of D <= 1024 bf16 has one warp; a
// wider row enough warps (a power of two up to 8) that a thread holds at
// most 4 vectors (32 bf16 as f32): 4 warps at D = 4096.  The vectors per
// thread are a compile-time 1..4, chosen at launch (3 at D = 576: 72
// vectors over 32 lanes, so lanes past the row's last vector hold zeros and
// store nothing).  The weight vector is converted to f32 into shared memory
// once per block, and each block of 256 threads strides over rows: a grid
// of at most 4 blocks per SM (one sweep at both prefill shapes), one block
// at the decode rows.  Rows off the vector (D * sizeof(x) not a multiple of
// 16) or over 1024 vectors take rmsnorm_generic_kernel: the same layout with
// scalar or vector loads and a second read of the row, from L1/L2, to
// scale.  The order is the reference's: (x * r) * w.

#include "../../model_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;
constexpr int kMaxVecs = 4;  // 16-byte vectors a thread holds on the one-pass path

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                   int R, int D, int warps_per_row, float eps) {
  constexpr int V = model::Vec16<T>::N;
  extern __shared__ float ws[];  // w as f32, [D]
  __shared__ float partial[kThreads / 32];
  for (int c = threadIdx.x; c < D; c += kThreads) ws[c] = model::to_f(w[c]);
  __syncthreads();

  const int group = 32 * warps_per_row;  // threads that own one row
  const int rows_per_block = kThreads / group;
  const int gi = threadIdx.x / group;
  const int t = threadIdx.x % group;
  const int nvec = D / V;
  for (long long base = (long long)blockIdx.x * rows_per_block; base < R;
       base += (long long)gridDim.x * rows_per_block) {
    const long long row = base + gi;
    const bool live = row < R;
    float f[VPT][V];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * group;
      if (live && c < nvec) {
        model::load16(x + (size_t)row * D + (size_t)c * V, f[i]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) f[i][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(f[i][e], f[i][e], ss);
    }
    ss = warp_sum(ss);
    if (warps_per_row > 1) {
      if ((threadIdx.x & 31) == 0) partial[threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < warps_per_row; ++i) ss += partial[gi * warps_per_row + i];
      __syncthreads();  // partial is written again for the next row
    }
    if (!live) continue;
    const float r = rsqrtf(ss / (float)D + eps);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * group;
      if (c < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) f[i][e] = (f[i][e] * r) * ws[c * V + e];
        model::store16(out + (size_t)row * D + (size_t)c * V, f[i]);
      }
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_generic_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                       int R, int D, int warps_per_row, int vec, float eps) {
  __shared__ float partial[kThreads / 32];
  const int group = 32 * warps_per_row;  // threads that own one row
  const int gi = threadIdx.x / group;
  const int t = threadIdx.x % group;
  const long long row = (long long)blockIdx.x * (kThreads / group) + gi;
  const bool live = row < R;
  const T* xr = x + (size_t)(live ? row : 0) * D;
  T* orow = out + (size_t)(live ? row : 0) * D;
  constexpr int V = model::Vec16<T>::N;

  float ss = 0.f;
  if (live) {
    if (vec) {
      for (int c = t; c < D / V; c += group) {
        float f[V];
        model::load16(xr + (size_t)c * V, f);
#pragma unroll
        for (int i = 0; i < V; ++i) ss = fmaf(f[i], f[i], ss);
      }
    } else {
      for (int c = t; c < D; c += group) {
        const float f = model::to_f(xr[c]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  ss = warp_sum(ss);
  if (warps_per_row > 1) {
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < warps_per_row; ++i) ss += partial[gi * warps_per_row + i];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)D + eps);

  if (vec) {
    for (int c = t; c < D / V; c += group) {
      float f[V];
      model::load16(xr + (size_t)c * V, f);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = (f[i] * r) * model::to_f(w[c * V + i]);
      model::store16(orow + (size_t)c * V, f);
    }
  } else {
    for (int c = t; c < D; c += group)
      orow[c] = model::from_f<T>((model::to_f(xr[c]) * r) * model::to_f(w[c]));
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

template <typename T, typename W, int VPT>
int launch_row(const T* x, const W* w, T* out, int R, int D, int warps_per_row, float eps,
               cudaStream_t stream) {
  const int rows_per_block = kThreads / (32 * warps_per_row);
  const long long need = ((long long)R + rows_per_block - 1) / rows_per_block;
  const int blocks = (int)(need < (long long)kBlocksPerSM * sm_count()
                               ? need : (long long)kBlocksPerSM * sm_count());
  rmsnorm_row_kernel<T, W, VPT><<<blocks, kThreads, D * sizeof(float), stream>>>(
      x, w, out, R, D, warps_per_row, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* xv, const void* wv, void* outv, int R, int D, float eps,
           cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const W* w = static_cast<const W*>(wv);
  T* out = static_cast<T*>(outv);
  constexpr int V = model::Vec16<T>::N;
  // 16-byte vectors need every row start aligned: D * sizeof(T) a multiple
  // of 16 and both base pointers 16-byte aligned
  const int vec = (D * (int)sizeof(T)) % 16 == 0;
  if (vec && ((uintptr_t)x | (uintptr_t)out) % 16) return (int)cudaErrorMisalignedAddress;
  const int nvec = D / V;
  if (vec && nvec <= kMaxVecs * kThreads) {
    int warps_per_row = 1;
    while (32 * warps_per_row * kMaxVecs < nvec) warps_per_row *= 2;
    switch ((nvec + 32 * warps_per_row - 1) / (32 * warps_per_row)) {
      case 1: return launch_row<T, W, 1>(x, w, out, R, D, warps_per_row, eps, stream);
      case 2: return launch_row<T, W, 2>(x, w, out, R, D, warps_per_row, eps, stream);
      case 3: return launch_row<T, W, 3>(x, w, out, R, D, warps_per_row, eps, stream);
      default: return launch_row<T, W, 4>(x, w, out, R, D, warps_per_row, eps, stream);
    }
  }
  const int warps_per_row = D <= 1024 ? 1 : kThreads / 32;
  const int rows_per_block = kThreads / (32 * warps_per_row);
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  rmsnorm_generic_kernel<T, W><<<blocks, kThreads, 0, stream>>>(x, w, out, R, D,
                                                                warps_per_row, vec, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
// The port's own kernels (the reference differentiates its jnp RMSNorm and
// has no backward Pallas kernel).  With r = rsqrt(mean(x^2) + eps),
// xhat = x r and g = dy w per row:
//   dx = r (g - xhat mean(g xhat)),   dw = sum over rows of dy xhat,
// in f32, dx stored in x's dtype and dw in w's.  rmsnorm_bwd_kernel gives
// each of kBwdBlocks blocks a contiguous run of rows; the block's threads
// share a row, thread i holding columns i, i + 256, ... (at most
// kBwdMaxCols of them, so D <= 8192), and two block-wide sums per row give
// mean(x^2) and mean(g xhat).  Each thread sums its columns' dy xhat over
// the block's rows in registers and writes them as the block's partial row
// of dw (kBwdBlocks x D f32); rmsnorm_dw_kernel then sums the partials of
// each column in block order.  No atomics: two runs give the same bits.
//
// What bounds it: bytes (x and dy read once, dx written once: 3 R D
// elements; the partials are 256 D f32), a few flops an element.  The
// block-wide sums per row cost two barriers; at 16,384 rows that is 64
// rows a block.
constexpr int kBwdBlocks = 256;
constexpr int kBwdMaxCols = 32;  // columns a thread holds (D <= 8192)

__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    t.x += scratch[i].x;
    t.y += scratch[i].y;
  }
  __syncthreads();  // scratch is written again for the next row
  return t;
}

template <typename T, typename W, int CPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, int R, int D, float eps) {
  __shared__ float2 scratch[kThreads / 32];
  const long long r0 = (long long)R * blockIdx.x / gridDim.x;
  const long long r1 = (long long)R * (blockIdx.x + 1) / gridDim.x;
  float wc[CPT], dw[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = threadIdx.x + j * kThreads;
    wc[j] = c < D ? model::to_f(w[c]) : 0.f;
    dw[j] = 0.f;
  }
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + (size_t)row * D;
    const T* gr = dy + (size_t)row * D;
    float xv[CPT], gv[CPT];
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * kThreads;
      xv[j] = c < D ? model::to_f(xr[c]) : 0.f;
      gv[j] = c < D ? model::to_f(gr[c]) : 0.f;
      ss = fmaf(xv[j], xv[j], ss);
      gx = fmaf(gv[j] * wc[j], xv[j], gx);  // sum of g x; mean(g xhat) = r gx / D
    }
    const float2 t = block_sum2(ss, gx, scratch);
    const float r = rsqrtf(t.x / (float)D + eps);
    const float c_mean = r * t.y / (float)D;  // mean(g xhat)
    T* dr = dx + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < D) {
        const float xh = xv[j] * r;
        dr[c] = model::from_f<T>(r * (gv[j] * wc[j] - xh * c_mean));
        dw[j] = fmaf(gv[j], xh, dw[j]);
      }
    }
  }
  float* pr = partial + (size_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < D) pr[c] = dw[j];
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ partial, W* __restrict__ dw, int blocks, int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  for (int i = 0; i < blocks; ++i) acc += partial[(size_t)i * D + c];
  dw[c] = model::from_f<W>(acc);
}

template <typename T, typename W, int CPT>
int launch_bwd_cols(const void* x, const void* w, const void* dy, void* dx, void* dw,
                    float* partial, int R, int D, float eps, cudaStream_t stream) {
  const int blocks = R < kBwdBlocks ? R : kBwdBlocks;
  rmsnorm_bwd_kernel<T, W, CPT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, R, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_dw_kernel<W><<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, static_cast<W*>(dw), blocks, D);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
               float* partial, int R, int D, float eps, cudaStream_t stream) {
  const int cols = (D + kThreads - 1) / kThreads;
#define BWD_ARGS x, w, dy, dx, dw, partial, R, D, eps, stream
  if (cols <= 1) return launch_bwd_cols<T, W, 1>(BWD_ARGS);
  if (cols <= 2) return launch_bwd_cols<T, W, 2>(BWD_ARGS);
  if (cols <= 4) return launch_bwd_cols<T, W, 4>(BWD_ARGS);
  if (cols <= 8) return launch_bwd_cols<T, W, 8>(BWD_ARGS);
  if (cols <= 16) return launch_bwd_cols<T, W, 16>(BWD_ARGS);
  if (cols <= kBwdMaxCols) return launch_bwd_cols<T, W, kBwdMaxCols>(BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int R, int D,
                           int x_bf16, int w_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, s);
  if (x_bf16) return launch<__nv_bfloat16, float>(x, w, out, R, D, eps, s);
  if (w_bf16) return launch<float, __nv_bfloat16>(x, w, out, R, D, eps, s);
  return launch<float, float>(x, w, out, R, D, eps, s);
}

// The backward: x, dy, dx (R, D) in x's dtype; w, dw (D,) in w's; partial
// (min(R, 256), D) f32 scratch.  Two launches: dx and the partials, then dw.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                           float* partial, int R, int D, int x_bf16, int w_bf16, float eps,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  if (x_bf16 && w_bf16) return launch_bwd<bf, bf>(x, w, dy, dx, dw, partial, R, D, eps, s);
  if (x_bf16) return launch_bwd<bf, float>(x, w, dy, dx, dw, partial, R, D, eps, s);
  if (w_bf16) return launch_bwd<float, bf>(x, w, dy, dx, dw, partial, R, D, eps, s);
  return launch_bwd<float, float>(x, w, dy, dx, dw, partial, R, D, eps, s);
}

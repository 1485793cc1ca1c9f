// Hand-written Hopper (sm_90a) kernel for row RMSNorm.
//
// Replaces (JAX package) kernels/rmsnorm/kernel.py::rmsnorm (:27, pallas_call
// :33): out = x * rsqrt(mean(x^2) + eps) * w per row, computed in f32 and
// stored in x's dtype.  Takes x and w in f32 or bf16 (independently).  Plain
// C interface (extern "C", raw pointers, the stream as void*), built by nvcc
// at first use and bound with ctypes by ../kernel.py; the entry point returns
// cudaGetLastError() of its launch.
//
// What bounds it on this card, and what the design does about it: a few
// flops per element, so bytes (x read once, out written once, w read once):
// at the model's shapes 9.4 MB (prefill, 4096 x 576 bf16) down to 9 KB
// (decode, 8 x 576), where the launch itself is the bound.  The TPU kernel
// holds a block of rows in VMEM and reduces it there; here each row is owned
// by one warp (D <= 1024) or by all eight warps of a 256-thread block
// (larger D), read with 16-byte loads, its sum of squares reduced with warp
// shuffles (and shared memory across the row's warps), then read again --
// from L1/L2, the row is at most 32 KB -- to scale and store.  A single pass
// that kept the row in registers would save the second read from cache, not
// from device memory.  The order is the reference's: (x * r) * w.

#include "../../model_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
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
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
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

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int R, int D, float eps,
           cudaStream_t stream) {
  const int warps_per_row = D <= 1024 ? 1 : kThreads / 32;
  const int rows_per_block = kThreads / (32 * warps_per_row);
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  // 16-byte vectors need every row start aligned: D * sizeof(T) a multiple
  // of 16 and both base pointers 16-byte aligned
  const int vec = (D * (int)sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  rmsnorm_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), R, D,
      warps_per_row, vec, eps);
  return (int)cudaGetLastError();
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

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
// in f32, dx stored in x's dtype and dw in w's.  Two launches a call: the
// rows (dx, and one partial row of dw a block), then rmsnorm_dw_kernel,
// which sums each column's partial rows in block order.  No atomics: every
// sum runs in a fixed order, so two runs give the same bits.
//
// What bounds it: bytes (x and dy read once, dx written once: 3 R D
// elements; the partial rows are at most kBwdBlocks x D f32) and a few flops
// an element: 0.0169 ms at smollm's training rows (16,384 x 576 bf16), 0.120
// ms at falcon-mamba's (16,384 x 4,096), at 3.35 TB/s.
//
// Design (rmsnorm_bwd_row_kernel: rows on the 16-byte vector, at most 1024
// vectors, the forward's one-pass layout).  A row belongs to one warp (up
// to 128 vectors: D <= 1024 in bf16) or to a power-of-two group of warps (4
// at D = 4096 in bf16), each thread holding at most 4 vectors of x and of dy
// in registers as loaded.  The row's two sums (x^2 and g x) are warp
// shuffles, and across a group's warps shared memory behind a named barrier
// of that group alone (double-buffered by row parity: one barrier a row), so
// no row waits for another.  dx is stored from the same registers as
// 16-byte vectors.  The rows are dealt to the row groups in a fixed order
// (block i's groups take rows i G .. i G + G - 1, then i G + grid G, ...),
// and each thread sums dy xhat for its columns over its rows in registers;
// at the end the block's groups add theirs in group order into the block's
// partial row.  Rows off the vector (or over 1024 vectors) take
// rmsnorm_bwd_kernel: one block a run of rows, its threads sharing a row,
// two block-wide sums a row.  Up to 3 vectors a thread, a
// group loads its next row while it works on this one.  rmsnorm_dw_kernel splits each column's
// partial rows into kDwSlices contiguous ranges, sums each in order and adds
// the ranges in order.  Measured (chip_smoke.py phase 15 (d), NVIDIA
// H100 80GB HBM3 at a 700 W power limit): 0.021-0.033 ms of device a call
// at 16,384 x 576 bf16 (bound 0.017 by bytes), 0.148 ms at 16,384 x 4,096
// (bound 0.120); autograd of F.rms_norm takes 0.084 / 0.310.
constexpr int kBwdBlocks = 512;         // most row-path blocks: rows of the dw partials
constexpr int kBwdGenericBlocks = 256;  // the generic path's blocks
constexpr int kBwdMaxCols = 32;         // generic: columns a thread holds (D <= 8192)
constexpr int kDwCols = 8;                  // rmsnorm_dw_kernel: columns of a block ...
constexpr int kDwSlices = kThreads / kDwCols;  // ... and the block ranges of each

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

// the threads of one row group (barrier id 1 + the group's index)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < model::Vec16<T>::N; ++i) f[i] = model::to_f(e[i]);
}

template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_row_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int R, int D, int warps_per_row, float eps) {
  constexpr int V = model::Vec16<T>::N;
  extern __shared__ float smem[];  // w as f32 [D]; at the end the groups' dw [groups][D]
  __shared__ float2 sums[2][kThreads / 32];  // each warp's (sum x^2, sum g x), by row parity
  for (int c = threadIdx.x; c < D; c += kThreads) smem[c] = model::to_f(w[c]);
  __syncthreads();

  const int group = 32 * warps_per_row;  // threads that own one row
  const int groups = kThreads / group;
  const int gi = threadIdx.x / group, t = threadIdx.x % group, warp = threadIdx.x / 32;
  const int nvec = D / V;
  float dw[VPT][V];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) dw[i][e] = 0.f;

  // x and dy of a row as loaded (zeros past R and past the row's vectors)
  auto load_row = [&](long long row, uint4 (&xr)[VPT], uint4 (&gr)[VPT]) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * group;
      xr[i] = gr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (row < R && c < nvec) {
        xr[i] = *reinterpret_cast<const uint4*>(x + (size_t)row * D + (size_t)c * V);
        gr[i] = *reinterpret_cast<const uint4*>(dy + (size_t)row * D + (size_t)c * V);
      }
    }
  };
  // up to 3 vectors a thread, the group's next row loads while it works on
  // this one (at 4 the registers it takes cost more than it hides)
  constexpr bool kPrefetch = VPT < 4;
  const long long stride = (long long)gridDim.x * groups;
  uint4 xr[VPT], gr[VPT], xn[VPT], gn[VPT];
  if constexpr (kPrefetch) load_row((long long)blockIdx.x * groups + gi, xr, gr);
  int parity = 0;
  for (long long base = (long long)blockIdx.x * groups; base < R;
       base += stride, parity ^= 1) {
    const long long row = base + gi;
    const bool live = row < R;
    if constexpr (kPrefetch)
      load_row(row + stride, xn, gn);
    else
      load_row(row, xr, gr);
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * group;
      if (c < nvec) {
        float xf[V], gf[V];
        unpack16<T>(xr[i], xf);
        unpack16<T>(gr[i], gf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(xf[e], xf[e], ss);
          gx = fmaf(gf[e] * smem[c * V + e], xf[e], gx);  // sum of g x
        }
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if (warps_per_row > 1) {
      if ((threadIdx.x & 31) == 0) sums[parity][warp] = make_float2(ss, gx);
      group_sync(1 + gi, group);
      ss = gx = 0.f;
      for (int i = 0; i < warps_per_row; ++i) {
        const float2 s = sums[parity][gi * warps_per_row + i];
        ss += s.x;
        gx += s.y;
      }
    }
    const float r = rsqrtf(ss / (float)D + eps);
    const float c_mean = r * gx / (float)D;  // mean(g xhat)
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * group;
      if (live && c < nvec) {
        float xf[V], gf[V];
        unpack16<T>(xr[i], xf);
        unpack16<T>(gr[i], gf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = xf[e] * r;
          const float g = gf[e] * smem[c * V + e];
          dw[i][e] = fmaf(gf[e], xh, dw[i][e]);
          xf[e] = r * (g - xh * c_mean);
        }
        model::store16(dx + (size_t)row * D + (size_t)c * V, xf);
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        xr[i] = xn[i];
        gr[i] = gn[i];
      }
    }
  }
  __syncthreads();  // every group is done with w: the buffer takes the groups' dw
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * group;
    if (c < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) smem[gi * D + c * V + e] = dw[i][e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += smem[g * D + c];
    partial[(size_t)blockIdx.x * D + c] = acc;
  }
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

// dw: kDwCols columns a block, each column's partial rows cut into
// kDwSlices contiguous ranges (a thread each), each range summed in order,
// the ranges added in order
template <typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ partial, W* __restrict__ dw, int blocks, int D) {
  __shared__ float sums[kDwSlices][kDwCols];
  const int lane = threadIdx.x % kDwCols, slice = threadIdx.x / kDwCols;
  const int c = blockIdx.x * kDwCols + lane;
  const int per = (blocks + kDwSlices - 1) / kDwSlices;
  const int b1 = min(blocks, (slice + 1) * per);
  float acc = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int i = slice * per; i < b1; ++i) acc += partial[(size_t)i * D + c];
  }
  sums[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int s = 0; s < kDwSlices; ++s) t += sums[s][lane];
    dw[c] = model::from_f<W>(t);
  }
}

template <typename W>
int launch_dw(const float* partial, void* dw, int blocks, int D, cudaStream_t stream) {
  rmsnorm_dw_kernel<W><<<(D + kDwCols - 1) / kDwCols, kThreads, 0, stream>>>(
      partial, static_cast<W*>(dw), blocks, D);
  return (int)cudaGetLastError();
}

template <typename T, typename W, int VPT>
int launch_bwd_row(const void* x, const void* w, const void* dy, void* dx, void* dw,
                   float* partial, int R, int D, int warps_per_row, float eps,
                   cudaStream_t stream) {
  const int groups = kThreads / (32 * warps_per_row);
  const long long need = ((long long)R + groups - 1) / groups;
  const int blocks = (int)(need < kBwdBlocks ? need : kBwdBlocks);
  rmsnorm_bwd_row_kernel<T, W, VPT><<<blocks, kThreads, (size_t)groups * D * sizeof(float),
                                      stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, R, D, warps_per_row, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dw<W>(partial, dw, blocks, D, stream);
}

template <typename T, typename W, int CPT>
int launch_bwd_cols(const void* x, const void* w, const void* dy, void* dx, void* dw,
                    float* partial, int R, int D, float eps, cudaStream_t stream) {
  const int blocks = R < kBwdGenericBlocks ? R : kBwdGenericBlocks;
  rmsnorm_bwd_kernel<T, W, CPT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, R, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dw<W>(partial, dw, blocks, D, stream);
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
               float* partial, int R, int D, float eps, cudaStream_t stream) {
  constexpr int V = model::Vec16<T>::N;
  const int nvec = D / V;
  if ((D * (int)sizeof(T)) % 16 == 0 && nvec <= kMaxVecs * kThreads) {
    if (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) % 16)
      return (int)cudaErrorMisalignedAddress;
    int warps_per_row = 1;
    while (32 * warps_per_row * kMaxVecs < nvec) warps_per_row *= 2;
#define ROW_ARGS x, w, dy, dx, dw, partial, R, D, warps_per_row, eps, stream
    switch ((nvec + 32 * warps_per_row - 1) / (32 * warps_per_row)) {
      case 1: return launch_bwd_row<T, W, 1>(ROW_ARGS);
      case 2: return launch_bwd_row<T, W, 2>(ROW_ARGS);
      case 3: return launch_bwd_row<T, W, 3>(ROW_ARGS);
      default: return launch_bwd_row<T, W, 4>(ROW_ARGS);
    }
#undef ROW_ARGS
  }
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

// The backward: x, dy, dx (R, D) in x's dtype, 16-byte aligned where a row
// is a whole number of 16-byte vectors; w, dw (D,) in w's; partial
// (min(R, 512), D) f32 scratch.  Two launches: dx and the partials, then dw.
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

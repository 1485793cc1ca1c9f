// Hand-written Hopper (sm_90a) kernel for the mamba1 selective scan.
//
// Replaces (JAX package) kernels/mamba_scan/kernel.py::selective_scan (:51,
// pallas_call :64).  Per batch row b and channel d, from h = 0:
//   h_t = exp(dt_t * -exp(A_log[d])) * h_{t-1} + (dt_t * x_t) * B_t   (N states)
//   y_t = sum_n h_t[n] * C_t[n] + D[d] * x_t
// all in f32.  The state after the last step, h_S (B, DI, N) f32, is a
// second output (the TPU kernel keeps it in VMEM scratch; the model's
// prefill hands it to decode).  Two modes from one templated kernel:
//
//   base   dt and x in f32 or bf16 (one dtype T), B and C in f32 or bf16;
//          y stored in T.  The TPU kernel's function.
//   fused  the mamba1 block's prefill around the scan, rounding where the
//          PyTorch sequence it replaces rounds (models/mamba.py; ../ref.py):
//            dt = T(softplus(T(dt_pre + dt_bias)))   (threshold 20)
//            y  = T((sum_n h C + D x) * silu(z))     (the gate in f32)
//          dt_pre, dt_bias, x, z, B and C in T; z may be the strided half of
//          the in_proj output (row stride z_stride elements, e.g. 2 DI).
//
// Plain C interface (extern "C", raw pointers, the stream as void*), built
// by nvcc at first use and bound with ctypes by ../kernel.py; the entry
// point returns cudaGetLastError() of its launch.
//
// What bounds it on this card: the special-function units (SFUs).  Every
// state and step takes one exp: at the serving path's prefill (B 4, S 512,
// DI 8192, N 16) 268 M of them, and the SFUs retire 16 a clock per SM (132
// SMs at up to 1.98 GHz: 64 us).  The bytes (dt_pre, x, z read and y written
// once in bf16, 134 MB) take 40 us at 3.35 TB/s, the 6 f32 operations per
// state and step (two multiplies, two FMAs) 24 us at 67 TFLOP/s.  Issue
// slots come close behind the SFUs: the 5 instructions per state and step
// are issued at one per clock and warp scheduler, against 8 clocks of a
// scheduler's 4 SFU lanes per exp of a warp.
//
// Design.  A block holds 64 neighbouring channels of one batch row (512
// blocks at the serving shape, 4 resident on each SM: 16 warps).  Warps 0
// and 1 scan channels 0-31, warps 2 and 3 channels 32-63; a thread holds 8
// of its channel's 16 states (warp w the half w & 1) and A_log's a * log2(e)
// for them in registers, so B and C are read at one address per warp.  The
// recurrence is serial in t; the parallelism is the 8 independent states of
// a step, whose exps issue back to back, and the 4 warps on each scheduler.
// Each exp is one ex2.approx.ftz (MUFU.EX2) of dt * (a log2 e): no range
// reduction.  States past N get a = 0 and B = C = 0, so every step runs 8
// states without a predicate.  Time goes in chunks (32 steps in bf16, 16 in
// f32): the block's dt, x (and z) tiles (steps x 64 channels) and B, C rows
// go to shared memory by cp.async, 16 bytes a thread, double-buffered, so
// chunk k + 1 loads while chunk k is scanned.  Each chunk has three phases
// between barriers: B and C to f32 (zero past N) and, fused, dt in place;
// the scan, each thread storing its half's sum of C h per step to shared
// memory; the output, y = both halves + D x (times silu(z), fused) for 8
// neighbouring channels a thread, stored as 16-byte rows.  The fused bf16
// softplus is a lookup in a table of all 65536 bf16 inputs, filled once per
// device by softplus_table with PyTorch's expression (log1p and exp in f32
// take dozens of instructions an element); in f32 it is computed.  A ragged
// last chunk scans only its steps; channels past DI stage, scan and store
// nothing; where DI, z_stride or a pointer is off the 16-byte vector, the
// tiles are copied and y stored element by element instead.  The scan over
// t is sequential, where the JAX model's reference is an associative scan:
// they agree to float rounding, not bit for bit.

#include <math.h>

#include <type_traits>

#include "../../model_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kCh = 64;        // channels per block: warps 0, 1 scan 0-31, warps 2, 3 32-63
constexpr int kMaxN = 16;      // states per channel
constexpr int kHalf = 8;       // states per thread: warp w holds half w & 1 of them
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

struct ScanArgs {
  const void* dt;       // (B, S, DI) T: dt (base) or dt_pre (fused)
  const float* a_log;   // (DI, N)
  const void* bm;       // (B, S, N) TB
  const void* cm;       // (B, S, N) TB
  const void* x;        // (B, S, DI) T
  const float* d_skip;  // (DI)
  const void* dt_bias;  // (DI) T, fused only
  const void* z;        // (B, S, DI) T at row stride z_stride, fused only
  void* y;              // (B, S, DI) T
  float* h;             // (B, DI, N)
  long long z_stride;
  int S, DI, N;
  int vec_act;  // dt, x, z tiles and y rows may be copied as 16-byte vectors
  int vec_bc;   // B and C chunks may be copied as 16-byte vectors
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// bf16(softplus(u)) for each of the 65536 bf16 values u, indexed by u's bits:
// the fused mode's dt in bf16, with the expression PyTorch's CUDA softplus
// evaluates (threshold 20, log1p(exp(u)) in f32), filled by softplus_table.
__device__ __nv_bfloat16 g_softplus[1 << 16];

__global__ void softplus_table() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float u = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(i)));
  g_softplus[i] = __float2bfloat16_rn(u > 20.f ? u : log1pf(expf(u)));
}

// the bits of a bf16 value held in a float
__device__ __forceinline__ unsigned bf16_bits(float v) { return __float_as_uint(v) >> 16; }

// v rounded to T and back (the identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return model::to_f(model::from_f<T>(v));
}

// Shared memory of one block: two buffers of staged inputs, each the (kT,
// kCh) tiles dt, x (, z) in T and the (kT, N) rows of B and C in TB; then B
// and C in f32 as (kT, 16) zero past N, the two state halves' partial sums
// Yp (2, kT, kCh), and D and dt_bias of the block's channels in f32.
template <typename T, typename TB, bool kFused> struct Smem {
  static constexpr int kT = 64 / sizeof(T);  // steps per chunk: 32 in bf16, 16 in f32
  static constexpr int kActTiles = kFused ? 3 : 2;
  static constexpr int kTile = kT * kCh;
  static constexpr int kRows = kT * kMaxN;
  static constexpr size_t kBufBytes = kActTiles * kTile * sizeof(T) + 2 * kRows * sizeof(TB);
  static constexpr size_t kBytes =
      2 * kBufBytes + (2 * kRows + 2 * kTile + 2 * kCh) * sizeof(float);
};

// rows [0, len) of a (len, kCh) tile of channels d0.. from src (row i at
// src + i * stride); columns past nch are not copied
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long stride, int len,
                                           int nch, bool vec) {
  if (vec) {
    constexpr int V = model::Vec16<T>::N, PER_ROW = kCh / V;
    for (int e = threadIdx.x; e < len * PER_ROW; e += kThreads) {
      const int i = e / PER_ROW, c = (e % PER_ROW) * V;
      if (c < nch) model::cp_async16(dst + i * kCh + c, src + i * stride + c, 16);
    }
  } else {
    for (int e = threadIdx.x; e < len * kCh; e += kThreads) {
      const int i = e / kCh, c = e % kCh;
      if (c < nch) dst[i * kCh + c] = src[i * stride + c];
    }
  }
}

// count contiguous elements from src
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int count, bool vec) {
  constexpr int V = model::Vec16<T>::N;
  const int nv = vec ? count / V : 0;
  for (int e = threadIdx.x; e < nv; e += kThreads)
    model::cp_async16(dst + e * V, src + e * V, 16);
  for (int e = nv * V + threadIdx.x; e < count; e += kThreads) dst[e] = src[e];
}

template <typename T, typename TB, bool kFused>
__global__ void __launch_bounds__(kThreads, 4) scan_kernel(const ScanArgs p) {
  using L = Smem<T, TB, kFused>;
  constexpr int kT = L::kT, V = model::Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Bf = reinterpret_cast<float*>(smem + 2 * L::kBufBytes);
  float* Cf = Bf + L::kRows;
  float* Yp = Cf + L::kRows;
  float* Ds = Yp + 2 * L::kTile;
  float* Bias = Ds + kCh;
  auto act = [&](int buf, int tile) {  // tile 0 dt, 1 x, 2 z of buffer buf
    return reinterpret_cast<T*>(smem + buf * L::kBufBytes) + tile * L::kTile;
  };
  auto rows = [&](int buf, int which) {  // 0 B, 1 C of buffer buf
    return reinterpret_cast<TB*>(smem + buf * L::kBufBytes +
                                 L::kActTiles * L::kTile * sizeof(T)) + which * L::kRows;
  };

  const int S = p.S, DI = p.DI, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int half = warp & 1;                     // this thread's states: 8 half .. 8 half + 7
  const int c = (warp >> 1) * 32 + (tid & 31);  // ... of channel d0 + c
  const int b = blockIdx.y, d0 = blockIdx.x * kCh;
  const int nch = min(kCh, DI - d0);
  const bool live = c < nch;
  const T* dt = static_cast<const T*>(p.dt);
  const T* x = static_cast<const T*>(p.x);
  const T* z = static_cast<const T*>(p.z);
  const TB* bm = static_cast<const TB*>(p.bm);
  const TB* cm = static_cast<const TB*>(p.cm);
  T* y = static_cast<T*>(p.y);

  auto stage = [&](int t0, int buf) {
    const int len = min(kT, S - t0);
    const size_t row0 = (size_t)b * S + t0;
    stage_tile(act(buf, 0), dt + row0 * DI + d0, DI, len, nch, p.vec_act);
    stage_tile(act(buf, 1), x + row0 * DI + d0, DI, len, nch, p.vec_act);
    if (kFused)
      stage_tile(act(buf, 2), z + (long long)row0 * p.z_stride + d0, p.z_stride, len, nch,
                 p.vec_act);
    stage_rows(rows(buf, 0), bm + row0 * N, len * N, p.vec_bc);
    stage_rows(rows(buf, 1), cm + row0 * N, len * N, p.vec_bc);
  };

  stage(0, 0);
  model::cp_async_commit();
  if (tid < kCh) {
    Ds[tid] = tid < nch ? p.d_skip[d0 + tid] : 0.f;
    if (kFused)
      Bias[tid] = tid < nch ? model::to_f(static_cast<const T*>(p.dt_bias)[d0 + tid]) : 0.f;
  }
  float a2[kHalf], h[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int n = half * kHalf + j;
    a2[j] = (live && n < N) ? -expf(p.a_log[(size_t)(d0 + c) * N + n]) * kLog2e : 0.f;
    h[j] = 0.f;
  }

  const int chunks = (S + kT - 1) / kT;
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * kT, len = min(kT, S - t0), buf = k & 1;
    model::cp_async_wait<0>();  // chunk k has landed (this thread's copies)
    __syncthreads();  // ... and every thread's; chunk k - 1's epilogue is done
    if (k + 1 < chunks) stage(t0 + kT, buf ^ 1);  // loads while chunk k is scanned
    model::cp_async_commit();

    // B and C to f32, zero past N; in the fused mode dt = T(softplus(T(dt_pre
    // + dt_bias))), in place
    const TB* braw = rows(buf, 0);
    const TB* craw = rows(buf, 1);
    for (int e = tid; e < L::kRows; e += kThreads) {
      const int i = e / kMaxN, n = e % kMaxN;
      const bool in = i < len && n < N;
      Bf[e] = in ? model::to_f(braw[i * N + n]) : 0.f;
      Cf[e] = in ? model::to_f(craw[i * N + n]) : 0.f;
    }
    T* dts = act(buf, 0);
    if (kFused) {  // V neighbouring channels a thread, independent of each other
      for (int e = tid * V; e < len * kCh; e += kThreads * V) {
        float v[V];
        model::load16(dts + e, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float u = round_to<T>(v[j] + Bias[e % kCh + j]);
          if constexpr (std::is_same<T, __nv_bfloat16>::value)
            v[j] = __bfloat162float(g_softplus[bf16_bits(u)]);
          else
            v[j] = u > 20.f ? u : log1pf(expf(u));
        }
        model::store16(dts + e, v);
      }
    }
    __syncthreads();

    // the scan: this thread's 8 states of channel c, its partial sum of y
    // (two partial sums halve the chain of FMAs)
    if (live) {
      const T* __restrict__ dtc = dts + c;
      const T* __restrict__ xc = act(buf, 1) + c;
      const float* __restrict__ bh = Bf + half * kHalf;
      const float* __restrict__ ch = Cf + half * kHalf;
      float* __restrict__ yp = Yp + half * L::kTile + c;
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        const float dtv = model::to_f(dtc[i * kCh]);
        const float dx = dtv * model::to_f(xc[i * kCh]);
        const float4 b0 = *reinterpret_cast<const float4*>(bh + i * kMaxN);
        const float4 b1 = *reinterpret_cast<const float4*>(bh + i * kMaxN + 4);
        const float4 c0 = *reinterpret_cast<const float4*>(ch + i * kMaxN);
        const float4 c1 = *reinterpret_cast<const float4*>(ch + i * kMaxN + 4);
        const float bv[kHalf] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float cv[kHalf] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        float acc[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          h[j] = fmaf(ex2(dtv * a2[j]), h[j], dx * bv[j]);
          acc[j & 1] = fmaf(h[j], cv[j], acc[j & 1]);
        }
        yp[i * kCh] = acc[0] + acc[1];
      }
    }
    __syncthreads();

    // y = (both halves + D x) [* silu(z)] in T, V neighbouring channels a thread
    const T* xs = act(buf, 1);
    const T* zs = act(buf, 2);
    for (int e = tid * V; e < len * kCh; e += kThreads * V) {
      const int i = e / kCh, cc = e % kCh;
      float v[V], xv[V], zv[V];
      model::load16(xs + e, xv);
      if (kFused) model::load16(zs + e, zv);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 y0 = *reinterpret_cast<const float4*>(Yp + e + j);
        const float4 y1 = *reinterpret_cast<const float4*>(Yp + L::kTile + e + j);
        const float4 dk = *reinterpret_cast<const float4*>(Ds + cc + j);
        v[j] = y0.x + y1.x + dk.x * xv[j];
        v[j + 1] = y0.y + y1.y + dk.y * xv[j + 1];
        v[j + 2] = y0.z + y1.z + dk.z * xv[j + 2];
        v[j + 3] = y0.w + y1.w + dk.w * xv[j + 3];
      }
      if (kFused) {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = v[j] * (zv[j] / (1.f + expf(-zv[j])));
      }
      T* out = y + ((size_t)b * S + t0 + i) * DI + d0 + cc;
      if (p.vec_act && cc + V <= nch) {
        model::store16(out, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (cc + j < nch) out[j] = model::from_f<T>(v[j]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int n = half * kHalf + j;
    if (n < N) p.h[((size_t)b * DI + d0 + c) * N + n] = h[j];
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T, typename TB, bool kFused>
int launch(ScanArgs p, int B, cudaStream_t stream) {
  using L = Smem<T, TB, kFused>;
  p.vec_act = p.DI % model::Vec16<T>::N == 0 && aligned16(p.dt) && aligned16(p.x) &&
              aligned16(p.y) &&
              (!kFused || (p.z_stride % model::Vec16<T>::N == 0 && aligned16(p.z)));
  // a chunk of B or C starts at (b S + t0) N elements, t0 a multiple of 16
  p.vec_bc = (long long)p.S * p.N % model::Vec16<TB>::N == 0 && aligned16(p.bm) &&
             aligned16(p.cm);
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_kernel<T, TB, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  if constexpr (kFused && std::is_same<T, __nv_bfloat16>::value) {
    static bool tabulated[kMaxDevices] = {};  // once per device, before its first use
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || dev >= kMaxDevices) return (int)(e ? e : cudaErrorInvalidDevice);
    if (!tabulated[dev]) {
      softplus_table<<<(1 << 16) / 256, 256, 0, stream>>>();
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      tabulated[dev] = true;
    }
  }
  const dim3 grid((p.DI + kCh - 1) / kCh, B);
  scan_kernel<T, TB, kFused><<<grid, kThreads, L::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dt/x/y (B,S,DI), a_log (DI,N), b/c (B,S,N), d_skip (DI), h (B,DI,N); N <= 16.
// Fused when z is not null: dt is dt_pre, dt_bias (DI) and z (B,S,DI) at row
// stride z_stride are in dt's dtype, and so are B and C.
extern "C" int selective_scan_fwd(const void* dt, const void* a_log, const void* bm,
                                  const void* cm, const void* x, const void* d_skip,
                                  const void* dt_bias, const void* z, long long z_stride,
                                  void* y, void* h, int B, int S, int DI, int N, int x_bf16,
                                  int bc_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  if (z != nullptr && (dt_bias == nullptr || x_bf16 != bc_bf16 || z_stride < DI))
    return (int)cudaErrorInvalidValue;
  const ScanArgs p{dt, static_cast<const float*>(a_log), bm, cm, x,
                   static_cast<const float*>(d_skip), dt_bias, z, y, static_cast<float*>(h),
                   z_stride, S, DI, N, 0, 0};
  using bf16 = __nv_bfloat16;
  if (z != nullptr)
    return x_bf16 ? launch<bf16, bf16, true>(p, B, s) : launch<float, float, true>(p, B, s);
  if (x_bf16 && bc_bf16) return launch<bf16, bf16, false>(p, B, s);
  if (x_bf16) return launch<bf16, float, false>(p, B, s);
  if (bc_bf16) return launch<float, bf16, false>(p, B, s);
  return launch<float, float, false>(p, B, s);
}

// Hand-written Hopper (sm_90a) kernel for the mamba1 selective scan.
//
// Replaces (JAX package) kernels/mamba_scan/kernel.py::selective_scan (:51,
// pallas_call :64).  Per batch row b and channel d, from h = 0:
//   h_t = exp(dt_t * -exp(A_log[d])) * h_{t-1} + (dt_t * x_t) * B_t   (N states)
//   y_t = sum_n h_t[n] * C_t[n] + D[d] * x_t
// all in f32; y is stored in dt's dtype.  Two departures from the TPU kernel,
// both needed by the model path: the state after the last step, h_S
// (B, DI, N) f32, is a second output (the TPU kernel keeps it in VMEM
// scratch; the model's prefill hands it to decode), and the kernel takes dt
// and x in f32 as well as bf16, so the model can keep y in f32 for its gate.
// B and C may be f32 or bf16 independently of dt and x; A_log and D are f32.
// Plain C interface (extern "C", raw pointers, the stream as void*), built
// by nvcc at first use and bound with ctypes by ../kernel.py; the entry
// point returns cudaGetLastError() of its launch.
//
// What bounds it on this card: bytes.  Each (b, t, d) reads dt and x and
// writes y once (12 bytes in f32), and B and C are small (N per (b, t)); at
// the serving path's prefill (B 4, S 512, DI 8192, N 16, f32) that is 204 MB,
// 61 us at 3.35 TB/s, against 28 us for the 1.9 G operations (an exp, two
// multiplies and two FMAs per state and step) at the f32 rate.  The
// recurrence is serial in t, so the parallelism is over (b, d): one thread
// per channel, its N
// states and -exp(A_log) in registers, walking t with coalesced reads of dt
// and x (neighbouring threads, neighbouring channels).  The TPU kernel's
// sequential grid axis over sequence chunks becomes this loop; each block
// stages a chunk of 64 steps of B and C (shared by all its channels) in
// shared memory as f32.  The scan over t is sequential, where the JAX model's
// reference is an associative scan: they agree to float rounding, not bit
// for bit.

#include <math.h>

#include "../../model_common.cuh"

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kMaxN = 16;      // states per channel held in registers
constexpr int kChunk = 64;     // time steps of B and C staged per refill

template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ dt, const float* __restrict__ a_log,
            const TB* __restrict__ bm, const TB* __restrict__ cm,
            const T* __restrict__ x, const float* __restrict__ d_skip,
            T* __restrict__ y, float* __restrict__ h_out, int S, int DI, int N) {
  __shared__ float Bs[kChunk * kMaxN];
  __shared__ float Cs[kChunk * kMaxN];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < DI;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = (live && n < N) ? -expf(a_log[(size_t)d * N + n]) : 0.f;
    h[n] = 0.f;
  }
  const float dsk = live ? d_skip[d] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    const size_t base = ((size_t)b * S + t0) * N;
    for (int e = threadIdx.x; e < len * N; e += kThreads) {
      Bs[e] = model::to_f(bm[base + e]);
      Cs[e] = model::to_f(cm[base + e]);
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < len; ++i) {
      const size_t off = ((size_t)b * S + t0 + i) * DI + d;
      const float dtv = model::to_f(dt[off]);
      const float xv = model::to_f(x[off]);
      const float dx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const float abar = expf(dtv * a[n]);
          h[n] = abar * h[n] + dx * Bs[i * N + n];
          acc = fmaf(h[n], Cs[i * N + n], acc);
        }
      }
      y[off] = model::from_f<T>(acc + dsk * xv);
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n)
    if (n < N) h_out[((size_t)b * DI + d) * N + n] = h[n];
}

template <typename T, typename TB>
int launch(const void* dt, const void* a_log, const void* bm, const void* cm, const void* x,
           const void* d_skip, void* y, void* h, int B, int S, int DI, int N,
           cudaStream_t stream) {
  const dim3 grid((DI + kThreads - 1) / kThreads, B);
  scan_kernel<T, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const float*>(a_log),
      static_cast<const TB*>(bm), static_cast<const TB*>(cm), static_cast<const T*>(x),
      static_cast<const float*>(d_skip), static_cast<T*>(y), static_cast<float*>(h), S, DI,
      N);
  return (int)cudaGetLastError();
}

}  // namespace

// dt/x/y (B,S,DI), a_log (DI,N), b/c (B,S,N), d_skip (DI), h (B,DI,N); N <= 16
extern "C" int selective_scan_fwd(const void* dt, const void* a_log, const void* bm,
                                  const void* cm, const void* x, const void* d_skip,
                                  void* y, void* h, int B, int S, int DI, int N,
                                  int x_bf16, int bc_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_bf16 && bc_bf16)
    return launch<bf16, bf16>(dt, a_log, bm, cm, x, d_skip, y, h, B, S, DI, N, s);
  if (x_bf16) return launch<bf16, float>(dt, a_log, bm, cm, x, d_skip, y, h, B, S, DI, N, s);
  if (bc_bf16) return launch<float, bf16>(dt, a_log, bm, cm, x, d_skip, y, h, B, S, DI, N, s);
  return launch<float, float>(dt, a_log, bm, cm, x, d_skip, y, h, B, S, DI, N, s);
}

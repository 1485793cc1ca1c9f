// Hand-written Hopper (sm_90a) kernels for the mamba1 selective scan: the
// forward (scan_kernel) and, for training, its backward (scan_bwd_kernel,
// then scan_bwd_reduce_kernel; described with them below).
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
// by nvcc at first use and bound with ctypes by ../kernel.py; each entry
// point returns cudaGetLastError() of its launches.  Given a pointer for
// them, the forward also stores the state entering each chunk of steps, the
// backward's starting points.
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

#include <algorithm>
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
  float* hs;            // (B, chunks, DI, N): the state at each chunk's start, or null
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
    if (p.hs != nullptr && live) {  // the state entering chunk k, for the backward
      float* dst = p.hs + (((size_t)b * chunks + k) * DI + d0 + c) * N + half * kHalf;
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
        if (half * kHalf + j < N) dst[j] = h[j];
    }
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

// ------------------------------------------------------------------ backward
// The port's own: the reference differentiates its jnp scan.  One block a
// batch row and 64 channels as in the forward, but warp w holds channels
// 16 w .. 16 w + 15 and lane l the states 8 (l >> 4) .. 8 (l >> 4) + 7 of
// channel 16 w + (l & 15), so the two halves of a channel meet in one
// shuffle.  Chunks go from last to first, each staged by cp.async while the
// one after it is worked (double-buffered in reverse order).  In a chunk the
// states are recomputed forward from the forward's saved chunk-start state
// (never by inverting the recurrence: h_{t-1} = (h_t - bx_t) / abar_t blows
// up where abar is small), kSubSteps steps at a time into shared memory: one
// pass keeps each sub-chunk's start, then each sub-chunk, last first, is
// recomputed and swept back with the carried G = dL/dh:
//   G_t = abar_{t+1} G_{t+1} + dy_t C_t,  dC_t = sum_d dy_t h_t,
//   dB_t = sum_d G_t dt_t x_t,  q_t = G_t h_{t-1} abar_t,
//   d dt_t = x_t sum_n G_t B_t + sum_n a q_t,  dx_t = dt_t sum_n G_t B_t + D dy_t,
//   d a += dt_t q_t,  dD += dy_t x_t,
// the fused mode's dy_t being dout_t silu(z_t), with dz_t = dout_t y_t silu'(z_t)
// (y recomputed as sum_n h C + D x) and d dt_pre = d dt e/(e + 1), e = exp(u),
// u = T(dt_pre + dt_bias) (softplus's threshold of 20), rounded to T where
// the plain version rounds.  Every sum runs in a fixed order, so two launches
// give the same bits: dB and dC are summed over a half-warp's 16 channels by
// a transposing shuffle tree, over the block's four warps in warp order, and
// written per block to f32 partials; d a, dD and d dt_bias are summed over
// time in registers and written per batch row; scan_bwd_reduce_kernel then
// sums the partials in block and row order and rounds each gradient to its
// dtype.  No atomics.
//
// What bounds it: at the training shape (B 8, S 2048, DI 8192, N 16, bf16,
// fused) the bytes (dt_pre, x, z, dout, the chunk states read; d dt_pre, dx,
// dz written: about 2.15 GB, 0.64 ms at 3.35 TB/s) and the exps (one abar a
// state and step, 2.15 G, 0.51 ms on the SFUs).  This kernel spends 2.75
// exps a state and step (the sub-chunk starts, the recompute, the sweep),
// plus 17 shuffles a step a thread, for shared memory that leaves two blocks
// an SM; a first, simple design.
constexpr int kSubSteps = 8;  // steps whose states a block keeps at once
constexpr int kWarps = kThreads / 32;

struct ScanBwdArgs {
  const void* dt;       // (B, S, DI) T: dt (base) or dt_pre (fused)
  const float* a_log;   // (DI, N)
  const void* bm;       // (B, S, N) TB
  const void* cm;       // (B, S, N) TB
  const void* x;        // (B, S, DI) T
  const float* d_skip;  // (DI)
  const void* dt_bias;  // (DI) T, fused only
  const void* z;        // (B, S, DI) T at row stride z_stride, fused only
  const void* dy;       // (B, S, DI) T: the output's gradient
  const float* dh;      // (B, DI, N): h_S's gradient, or null for zero
  const float* hs;      // (B, chunks, DI, N): the forward's chunk-start states
  void* ddt;            // (B, S, DI) T: d dt (base) or d dt_pre (fused)
  void* dx;             // (B, S, DI) T
  void* dz;             // (B, S, DI) T, contiguous, fused only
  float* part_b;        // (blocks, B, S, N): dB summed over each block's channels
  float* part_c;        // (blocks, B, S, N): dC likewise
  float* part_a;        // (B, DI, N): the gradient of a = -exp(A_log), over time
  float* part_d;        // (B, DI): dD over time
  float* part_bias;     // (B, DI): d dt_bias over time, fused only
  long long z_stride;
  int B, S, DI, N;
  int vec_act;  // dt, x, dy, z tiles may be copied as 16-byte vectors
  int vec_bc;   // B and C chunks may be copied as 16-byte vectors
};

// Shared memory of one backward block: two buffers of staged inputs (the
// (kT, kCh) tiles dt, x, dy (, z) in T, the (kT, N) rows of B and C in TB);
// dt as the scan sees it in T; then in f32: B and C (kT, 16) zero past N, dy
// as the scan sees it (kT, kCh), one sub-chunk's states and the chunk's
// sub-chunk starts (each thread its own 8 states); of one sub-chunk, each
// channel's sum_n h C, sum_n G B and sum_n a q (kSubSteps, kCh) and the
// warps' dB / dC sums; D and dt_bias.
template <typename T, typename TB, bool kFused> struct BwdSmem {
  static constexpr int kT = Smem<T, TB, kFused>::kT;  // the forward's chunk
  static constexpr int kSubs = kT / kSubSteps;
  static constexpr int kActTiles = kFused ? 4 : 3;
  static constexpr int kTile = kT * kCh;
  static constexpr int kRows = kT * kMaxN;
  static constexpr int kStates = kHalf * kThreads;  // one state of every thread
  static constexpr size_t kBufBytes = kActTiles * kTile * sizeof(T) + 2 * kRows * sizeof(TB);
  static constexpr size_t kFloats = 2 * kRows + kTile + (kSubSteps + kSubs) * kStates +
                                    3 * kSubSteps * kCh + kWarps * kSubSteps * 32 + 2 * kCh;
  static constexpr size_t kBytes = 2 * kBufBytes + kTile * sizeof(T) + kFloats * sizeof(float);
};

// v[0, 2W) on each lane -> v[0, W) summed with the partner lane's (lane ^ W)
// other half: a lane whose bit W is set keeps and receives the upper W values,
// so after W = 8, 4, 2, 1 (15 shuffles, a fixed order) v[0] holds element
// (lane & 15) summed over the 16 lanes of the lane's half-warp
template <int W> __device__ __forceinline__ void fold16(float (&v)[16], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = up ? v[j] : v[j + W];
    const float keep = up ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
  if constexpr (W > 1) fold16<W / 2>(v, lane);
}

template <typename T, typename TB, bool kFused>
__global__ void __launch_bounds__(kThreads, 2) scan_bwd_kernel(const ScanBwdArgs p) {
  using L = BwdSmem<T, TB, kFused>;
  constexpr int kT = L::kT, V = model::Vec16<T>::N, kSt = L::kStates;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Dts = reinterpret_cast<T*>(smem + 2 * L::kBufBytes);
  float* Bf = reinterpret_cast<float*>(smem + 2 * L::kBufBytes + L::kTile * sizeof(T));
  float* Cf = Bf + L::kRows;
  float* Dyf = Cf + L::kRows;
  float* Hs = Dyf + L::kTile;          // [i][j][tid]: state j after sub-chunk step i
  float* Hb = Hs + kSubSteps * kSt;    // [s][j][tid]: state j entering sub-chunk s
  float* Ys = Hb + L::kSubs * kSt;     // [i][c]: sum_n h C at sub-chunk step i
  float* SB = Ys + kSubSteps * kCh;    // [i][c]: sum_n G B
  float* SA = SB + kSubSteps * kCh;    // [i][c]: sum_n a q
  float* Red = SA + kSubSteps * kCh;   // [warp][i][lane]: its dB / dC sums
  float* Ds = Red + kWarps * kSubSteps * 32;
  float* Bias = Ds + kCh;
  auto act = [&](int buf, int tile) {  // tile 0 dt, 1 x, 2 dy, 3 z of buffer buf
    return reinterpret_cast<T*>(smem + buf * L::kBufBytes) + tile * L::kTile;
  };
  auto rows = [&](int buf, int which) {  // 0 B, 1 C of buffer buf
    return reinterpret_cast<TB*>(smem + buf * L::kBufBytes +
                                 L::kActTiles * L::kTile * sizeof(T)) + which * L::kRows;
  };

  const int S = p.S, DI = p.DI, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4;                 // this thread's states: 8 half .. 8 half + 7
  const int c = warp * 16 + (lane & 15);      // ... of channel d0 + c
  const int b = blockIdx.y, blk = blockIdx.x, d0 = blk * kCh;
  const int nch = min(kCh, DI - d0);
  const bool live = c < nch;
  const T* dt = static_cast<const T*>(p.dt);
  const T* x = static_cast<const T*>(p.x);
  const T* z = static_cast<const T*>(p.z);
  const T* dy = static_cast<const T*>(p.dy);
  const TB* bm = static_cast<const TB*>(p.bm);
  const TB* cm = static_cast<const TB*>(p.cm);
  T* ddt = static_cast<T*>(p.ddt);
  T* dxo = static_cast<T*>(p.dx);
  T* dzo = static_cast<T*>(p.dz);

  auto stage = [&](int t0, int buf) {
    const int len = min(kT, S - t0);
    const size_t row0 = (size_t)b * S + t0;
    stage_tile(act(buf, 0), dt + row0 * DI + d0, DI, len, nch, p.vec_act);
    stage_tile(act(buf, 1), x + row0 * DI + d0, DI, len, nch, p.vec_act);
    stage_tile(act(buf, 2), dy + row0 * DI + d0, DI, len, nch, p.vec_act);
    if (kFused)
      stage_tile(act(buf, 3), z + (long long)row0 * p.z_stride + d0, p.z_stride, len, nch,
                 p.vec_act);
    stage_rows(rows(buf, 0), bm + row0 * N, len * N, p.vec_bc);
    stage_rows(rows(buf, 1), cm + row0 * N, len * N, p.vec_bc);
  };

  const int chunks = (S + kT - 1) / kT;
  stage((chunks - 1) * kT, (chunks - 1) & 1);
  model::cp_async_commit();
  if (tid < kCh) {
    Ds[tid] = tid < nch ? p.d_skip[d0 + tid] : 0.f;
    if (kFused)
      Bias[tid] = tid < nch ? model::to_f(static_cast<const T*>(p.dt_bias)[d0 + tid]) : 0.f;
  }
  float a[kHalf], a2[kHalf], g[kHalf], da[kHalf], h[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int n = half * kHalf + j;
    const bool in = live && n < N;
    a[j] = in ? -expf(p.a_log[(size_t)(d0 + c) * N + n]) : 0.f;
    a2[j] = a[j] * kLog2e;  // the forward's exponent, bit for bit
    g[j] = in && p.dh != nullptr ? p.dh[((size_t)b * DI + d0 + c) * N + n] : 0.f;
    da[j] = 0.f;
  }
  float acc_d = 0.f, acc_bias = 0.f;

  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * kT, len = min(kT, S - t0), buf = k & 1;
    model::cp_async_wait<0>();  // chunk k has landed (this thread's copies)
    __syncthreads();  // ... and every thread's; chunk k + 1 is done with
    if (k > 0) stage(t0 - kT, buf ^ 1);  // loads while chunk k is worked
    model::cp_async_commit();

    // B and C to f32, zero past N; dt as the scan sees it (fused: T(softplus(
    // T(dt_pre + dt_bias))), as the forward computes it); dy as the scan sees
    // it (fused: dout silu(z)) in f32; dt, dy and x zero past the block's
    // channels, so those lanes carry zeros
    const TB* braw = rows(buf, 0);
    const TB* craw = rows(buf, 1);
    for (int e = tid; e < L::kRows; e += kThreads) {
      const int i = e / kMaxN, n = e % kMaxN;
      const bool in = i < len && n < N;
      Bf[e] = in ? model::to_f(braw[i * N + n]) : 0.f;
      Cf[e] = in ? model::to_f(craw[i * N + n]) : 0.f;
    }
    T* xs = act(buf, 1);
    for (int e = tid * V; e < len * kCh; e += kThreads * V) {
      const int cc = e % kCh;
      float v[V], gv[V], zv[V];
      model::load16(act(buf, 0) + e, v);
      model::load16(act(buf, 2) + e, gv);
      if (kFused) model::load16(act(buf, 3) + e, zv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (kFused) {
          const float u = round_to<T>(v[j] + Bias[cc + j]);
          if constexpr (std::is_same<T, __nv_bfloat16>::value)
            v[j] = __bfloat162float(g_softplus[bf16_bits(u)]);
          else
            v[j] = u > 20.f ? u : log1pf(expf(u));
          gv[j] = gv[j] * (zv[j] / (1.f + expf(-zv[j])));
        }
        if (cc + j >= nch) {
          v[j] = gv[j] = 0.f;
          xs[e + j] = model::from_f<T>(0.f);
        }
        Dyf[e + j] = gv[j];
      }
      model::store16(Dts + e, v);
    }
    __syncthreads();

    // the recurrence's step i of the chunk, as the forward takes it
    auto step = [&](int i) {
      const float dtv = model::to_f(Dts[i * kCh + c]);
      const float dx = dtv * model::to_f(xs[i * kCh + c]);
      const float4 b0 = *reinterpret_cast<const float4*>(Bf + i * kMaxN + half * kHalf);
      const float4 b1 = *reinterpret_cast<const float4*>(Bf + i * kMaxN + half * kHalf + 4);
      const float bv[kHalf] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < kHalf; ++j) h[j] = fmaf(ex2(dtv * a2[j]), h[j], dx * bv[j]);
    };

    // the sub-chunks' starts, from the state the forward saved for chunk k
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int n = half * kHalf + j;
      h[j] = live && n < N ? p.hs[(((size_t)b * chunks + k) * DI + d0 + c) * N + n] : 0.f;
      Hb[j * kThreads + tid] = h[j];
    }
    const int nsub = (len + kSubSteps - 1) / kSubSteps;
    for (int i = 0; i < (nsub - 1) * kSubSteps; ++i) {
      step(i);
      if ((i + 1) % kSubSteps == 0) {
#pragma unroll
        for (int j = 0; j < kHalf; ++j)
          Hb[(((i + 1) / kSubSteps) * kHalf + j) * kThreads + tid] = h[j];
      }
    }

    for (int s = nsub - 1; s >= 0; --s) {
      const int i0 = s * kSubSteps, ns = min(kSubSteps, len - i0);
      const float* hb = Hb + s * kSt + tid;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) h[j] = hb[j * kThreads];
      for (int i = 0; i < ns; ++i) {  // the sub-chunk's states (and y) again
        step(i0 + i);
#pragma unroll
        for (int j = 0; j < kHalf; ++j) Hs[(i * kHalf + j) * kThreads + tid] = h[j];
        if (kFused) {
          const float* ch = Cf + (i0 + i) * kMaxN + half * kHalf;
          float acc[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kHalf; ++j) acc[j & 1] = fmaf(h[j], ch[j], acc[j & 1]);
          float yp = acc[0] + acc[1];
          yp += __shfl_xor_sync(0xffffffffu, yp, 16);
          if (half == 0) Ys[i * kCh + c] = yp;
        }
      }
      float hc[kHalf];  // the states after step i, carried back from the last
#pragma unroll
      for (int j = 0; j < kHalf; ++j) hc[j] = h[j];
#pragma unroll 2
      for (int i = ns - 1; i >= 0; --i) {  // back over it
        const int t = i0 + i;
        const float dtv = model::to_f(Dts[t * kCh + c]);
        const float xv = model::to_f(xs[t * kCh + c]);
        const float dyv = Dyf[t * kCh + c];
        const float dxv = dtv * xv;
        const float4 b0 = *reinterpret_cast<const float4*>(Bf + t * kMaxN + half * kHalf);
        const float4 b1 = *reinterpret_cast<const float4*>(Bf + t * kMaxN + half * kHalf + 4);
        const float4 c0 = *reinterpret_cast<const float4*>(Cf + t * kMaxN + half * kHalf);
        const float4 c1 = *reinterpret_cast<const float4*>(Cf + t * kMaxN + half * kHalf + 4);
        const float bh[kHalf] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float ch[kHalf] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float* hp = i ? Hs + (i - 1) * kSt + tid : hb;
        float v[16], sb[2] = {0.f, 0.f}, sa[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const float hpj = hp[j * kThreads];  // the state before step i
          g[j] = fmaf(dyv, ch[j], g[j]);
          v[kHalf + j] = dyv * hc[j];
          v[j] = g[j] * dxv;
          sb[j & 1] = fmaf(g[j], bh[j], sb[j & 1]);
          const float ab = ex2(dtv * a2[j]);
          const float q = g[j] * hpj * ab;
          da[j] = fmaf(dtv, q, da[j]);
          sa[j & 1] = fmaf(a[j], q, sa[j & 1]);
          g[j] *= ab;
          hc[j] = hpj;
        }
        fold16<8>(v, lane);
        Red[(warp * kSubSteps + i) * 32 + lane] = v[0];
        float s_b = sb[0] + sb[1], s_a = sa[0] + sa[1];
        s_b += __shfl_xor_sync(0xffffffffu, s_b, 16);
        s_a += __shfl_xor_sync(0xffffffffu, s_a, 16);
        if (half == 0) {
          SB[i * kCh + c] = s_b;
          SA[i * kCh + c] = s_a;
        }
      }
      __syncthreads();  // the sub-chunk's sums are in
      for (int e = tid; e < ns * 32; e += kThreads) {  // dB, dC: the warps in order
        const int i = e >> 5, l = e & 31;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += Red[(w * kSubSteps + i) * 32 + l];
        const int n = (l >> 4) * kHalf + (l & 7);
        if (n < N) {
          float* dst = (l & 8) ? p.part_c : p.part_b;
          dst[(((size_t)blk * p.B + b) * S + t0 + i0 + i) * N + n] = sum;
        }
      }
      // the elementwise gradients, a thread a channel: threads 0-63 d dt
      // (fused: d dt_pre) and dx, 64-127 dz (fused)
      const int ce = tid & (kCh - 1);
      if (ce < nch && (tid < kCh || kFused)) {
        for (int i = 0; i < ns; ++i) {
          const int t = i0 + i, at = t * kCh + ce;
          const size_t o = ((size_t)b * S + t0 + t) * DI + d0 + ce;
          const float xv = model::to_f(xs[at]), dyv = Dyf[at];
          if (tid < kCh) {
            const float dtv = model::to_f(Dts[at]), s_b = SB[i * kCh + ce];
            const float gdt = xv * s_b + SA[i * kCh + ce];
            acc_d = fmaf(dyv, xv, acc_d);
            if constexpr (kFused) {
              const float gr = round_to<T>(gdt);
              const float u = round_to<T>(model::to_f(act(buf, 0)[at]) + Bias[ce]);
              const float e = expf(u);
              const T du = model::from_f<T>(u > 20.f ? gr : gr * e / (e + 1.f));
              acc_bias += model::to_f(du);
              ddt[o] = du;
            } else {
              ddt[o] = model::from_f<T>(gdt);
            }
            dxo[o] = model::from_f<T>(dtv * s_b + Ds[ce] * dyv);
          } else {
            const float zv = model::to_f(act(buf, 3)[at]);
            const float gout = model::to_f(act(buf, 2)[at]);
            const float sg = 1.f / (1.f + expf(-zv));
            const float yv = Ys[i * kCh + ce] + Ds[ce] * xv;
            dzo[o] = model::from_f<T>(gout * yv * (sg * (1.f + zv * (1.f - sg))));
          }
        }
      }
      __syncthreads();  // before the sub-chunk buffers are written again
    }
  }
  if (tid < kCh && tid < nch) {
    p.part_d[(size_t)b * DI + d0 + tid] = acc_d;
    if (kFused) p.part_bias[(size_t)b * DI + d0 + tid] = acc_bias;
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int n = half * kHalf + j;
    if (n < N) p.part_a[((size_t)b * DI + d0 + c) * N + n] = da[j];
  }
}

struct ScanReduceArgs {
  const float* part_b;     // (blocks, B, S, N)
  const float* part_c;     // (blocks, B, S, N)
  const float* part_a;     // (B, DI, N)
  const float* part_d;     // (B, DI)
  const float* part_bias;  // (B, DI), fused only
  const float* a_log;      // (DI, N)
  void* dbm;               // (B, S, N) TB
  void* dcm;               // (B, S, N) TB
  float* da_log;           // (DI, N)
  float* dd;               // (DI)
  void* dbias;             // (DI) T, fused only
  int blocks, B, S, DI, N;
};

// The partials summed in block order (dB, dC) and row order (dA_log, dD,
// d dt_bias), each rounded once to its gradient's dtype; one thread an
// element, the elements of all five gradients in one grid-stride loop.
template <typename T, typename TB, bool kFused>
__global__ void scan_bwd_reduce_kernel(const ScanReduceArgs p) {
  const size_t nbc = (size_t)p.B * p.S * p.N, na = (size_t)p.DI * p.N;
  const size_t total = 2 * nbc + na + (kFused ? 2 : 1) * (size_t)p.DI;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (e < 2 * nbc) {
      const bool is_c = e >= nbc;
      const size_t r = is_c ? e - nbc : e;
      const float* src = (is_c ? p.part_c : p.part_b) + r;
      for (int k = 0; k < p.blocks; ++k) acc += src[k * nbc];
      static_cast<TB*>(is_c ? p.dcm : p.dbm)[r] = model::from_f<TB>(acc);
    } else if (e < 2 * nbc + na) {
      const size_t r = e - 2 * nbc;
      for (int bb = 0; bb < p.B; ++bb) acc += p.part_a[bb * na + r];
      p.da_log[r] = acc * -expf(p.a_log[r]);  // d a_log = d a * a
    } else if (e < 2 * nbc + na + p.DI) {
      const size_t r = e - 2 * nbc - na;
      for (int bb = 0; bb < p.B; ++bb) acc += p.part_d[(size_t)bb * p.DI + r];
      p.dd[r] = acc;
    } else {
      const size_t r = e - 2 * nbc - na - p.DI;
      for (int bb = 0; bb < p.B; ++bb) acc += p.part_bias[(size_t)bb * p.DI + r];
      static_cast<T*>(p.dbias)[r] = model::from_f<T>(acc);
    }
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// the fused bf16 softplus table, filled once per device before its first use
int ensure_softplus_table(cudaStream_t stream) {
  static bool tabulated[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= kMaxDevices) return (int)(e ? e : cudaErrorInvalidDevice);
  if (!tabulated[dev]) {
    softplus_table<<<(1 << 16) / 256, 256, 0, stream>>>();
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    tabulated[dev] = true;
  }
  return 0;
}

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
    if (const int e = ensure_softplus_table(stream)) return e;
  }
  const dim3 grid((p.DI + kCh - 1) / kCh, B);
  scan_kernel<T, TB, kFused><<<grid, kThreads, L::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TB, bool kFused>
int launch_bwd(ScanBwdArgs p, ScanReduceArgs r, cudaStream_t stream) {
  using L = BwdSmem<T, TB, kFused>;
  p.vec_act = p.DI % model::Vec16<T>::N == 0 && aligned16(p.dt) && aligned16(p.x) &&
              aligned16(p.dy) &&
              (!kFused || (p.z_stride % model::Vec16<T>::N == 0 && aligned16(p.z)));
  p.vec_bc = (long long)p.S * p.N % model::Vec16<TB>::N == 0 && aligned16(p.bm) &&
             aligned16(p.cm);
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_bwd_kernel<T, TB, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  if constexpr (kFused && std::is_same<T, __nv_bfloat16>::value) {
    if (const int e = ensure_softplus_table(stream)) return e;
  }
  const dim3 grid(r.blocks, p.B);
  scan_bwd_kernel<T, TB, kFused><<<grid, kThreads, L::kBytes, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = 2 * (size_t)p.B * p.S * p.N + (size_t)p.DI * p.N + 2 * (size_t)p.DI;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 8);
  scan_bwd_reduce_kernel<T, TB, kFused><<<blocks, 256, 0, stream>>>(r);
  return (int)cudaGetLastError();
}

}  // namespace

// dt/x/y (B,S,DI), a_log (DI,N), b/c (B,S,N), d_skip (DI), h (B,DI,N); N <= 16.
// Fused when z is not null: dt is dt_pre, dt_bias (DI) and z (B,S,DI) at row
// stride z_stride are in dt's dtype, and so are B and C.  hs, if not null,
// receives the state entering each chunk of 64 / sizeof(T) steps (B, chunks,
// DI, N), for the backward; y and h are the same bits with or without it.
extern "C" int selective_scan_fwd(const void* dt, const void* a_log, const void* bm,
                                  const void* cm, const void* x, const void* d_skip,
                                  const void* dt_bias, const void* z, long long z_stride,
                                  void* y, void* h, void* hs, int B, int S, int DI, int N,
                                  int x_bf16, int bc_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  if (z != nullptr && (dt_bias == nullptr || x_bf16 != bc_bf16 || z_stride < DI))
    return (int)cudaErrorInvalidValue;
  const ScanArgs p{dt, static_cast<const float*>(a_log), bm, cm, x,
                   static_cast<const float*>(d_skip), dt_bias, z, y, static_cast<float*>(h),
                   static_cast<float*>(hs), z_stride, S, DI, N, 0, 0};
  using bf16 = __nv_bfloat16;
  if (z != nullptr)
    return x_bf16 ? launch<bf16, bf16, true>(p, B, s) : launch<float, float, true>(p, B, s);
  if (x_bf16 && bc_bf16) return launch<bf16, bf16, false>(p, B, s);
  if (x_bf16) return launch<bf16, float, false>(p, B, s);
  if (bc_bf16) return launch<float, bf16, false>(p, B, s);
  return launch<float, float, false>(p, B, s);
}

// The backward: the forward's inputs, dy (B,S,DI) in dt's dtype, dh (B,DI,N)
// or null, hs the forward's chunk states -> ddt, dx (and dz, contiguous,
// fused) (B,S,DI) in dt's dtype, db/dc (B,S,N) in B's, da_log (DI,N) and dd
// (DI) f32, dbias (DI) in dt's dtype (fused).  part_bc holds 2 x blocks x
// B x S x N floats, part_row B x DI x N + 2 x B x DI (blocks = ceil(DI/64)).
extern "C" int selective_scan_bwd(const void* dt, const void* a_log, const void* bm,
                                  const void* cm, const void* x, const void* d_skip,
                                  const void* dt_bias, const void* z, long long z_stride,
                                  const void* dy, const void* dh, const void* hs, void* ddt,
                                  void* da_log, void* dbm, void* dcm, void* dx, void* dd,
                                  void* dbias, void* dz, void* part_bc, void* part_row, int B,
                                  int S, int DI, int N, int x_bf16, int bc_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN || S < 1 || hs == nullptr) return (int)cudaErrorInvalidValue;
  if (z != nullptr && (dt_bias == nullptr || dz == nullptr || dbias == nullptr ||
                       x_bf16 != bc_bf16 || z_stride < DI))
    return (int)cudaErrorInvalidValue;
  const int blocks = (DI + kCh - 1) / kCh;
  float* pb = static_cast<float*>(part_bc);
  const size_t nbc = (size_t)B * S * N;
  float* pr = static_cast<float*>(part_row);
  float* pa = pr;
  float* pd = pa + (size_t)B * DI * N;
  float* pbias = pd + (size_t)B * DI;
  const ScanBwdArgs p{dt, static_cast<const float*>(a_log), bm, cm, x,
                      static_cast<const float*>(d_skip), dt_bias, z, dy,
                      static_cast<const float*>(dh), static_cast<const float*>(hs), ddt, dx, dz,
                      pb, pb + (size_t)blocks * nbc, pa, pd, pbias, z_stride, B, S, DI, N, 0, 0};
  const ScanReduceArgs r{pb, pb + (size_t)blocks * nbc, pa, pd, pbias,
                         static_cast<const float*>(a_log), dbm, dcm,
                         static_cast<float*>(da_log), static_cast<float*>(dd), dbias,
                         blocks, B, S, DI, N};
  using bf16 = __nv_bfloat16;
  if (z != nullptr)
    return x_bf16 ? launch_bwd<bf16, bf16, true>(p, r, s)
                  : launch_bwd<float, float, true>(p, r, s);
  if (x_bf16 && bc_bf16) return launch_bwd<bf16, bf16, false>(p, r, s);
  if (x_bf16) return launch_bwd<bf16, float, false>(p, r, s);
  if (bc_bf16) return launch_bwd<float, bf16, false>(p, r, s);
  return launch_bwd<float, float, false>(p, r, s);
}

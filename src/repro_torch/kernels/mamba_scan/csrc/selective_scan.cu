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

// rows [0, len) of a (len, kC) tile of channels d0.. from src (row i at
// src + i * stride), by a block of kNT threads; columns past nch are not
// copied
template <typename T, int kC = kCh, int kNT = kThreads>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long stride, int len,
                                           int nch, bool vec) {
  if (vec) {
    constexpr int V = model::Vec16<T>::N, PER_ROW = kC / V;
    for (int e = threadIdx.x; e < len * PER_ROW; e += kNT) {
      const int i = e / PER_ROW, c = (e % PER_ROW) * V;
      if (c < nch) model::cp_async16(dst + i * kC + c, src + i * stride + c, 16);
    }
  } else {
    for (int e = threadIdx.x; e < len * kC; e += kNT) {
      const int i = e / kC, c = e % kC;
      if (c < nch) dst[i * kC + c] = src[i * stride + c];
    }
  }
}

// count contiguous elements from src, by a block of kNT threads
template <typename T, int kNT = kThreads>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int count, bool vec) {
  constexpr int V = model::Vec16<T>::N;
  const int nv = vec ? count / V : 0;
  for (int e = threadIdx.x; e < nv; e += kNT)
    model::cp_async16(dst + e * V, src + e * V, 16);
  for (int e = nv * V + threadIdx.x; e < count; e += kNT) dst[e] = src[e];
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
// The port's own: the reference differentiates its jnp scan.  From the
// forward's saved state entering each chunk, the block recomputes the
// states of the chunk (never by inverting the recurrence: h_{t-1} = (h_t -
// bx_t) / abar_t blows up where abar is small) and sweeps back over them
// with the carried G = dL/dh:
//   G_t = abar_{t+1} G_{t+1} + dy_t C_t,  dC_t = sum_d dy_t h_t,
//   dB_t = sum_d G_t dt_t x_t,  q_t = G_t abar_t h_{t-1},
//   d dt_t = x_t sum_n G_t B_t + sum_n a q_t,  dx_t = dt_t sum_n G_t B_t + D dy_t,
//   d a += dt_t q_t,  dD += dy_t x_t,
// the fused mode's dy_t being dout_t silu(z_t), with dz_t = dout_t y_t silu'(z_t)
// (y recomputed as sum_n h C + D x) and d dt_pre = d dt e/(e + 1), e = exp(u),
// u = T(dt_pre + dt_bias) (softplus's threshold of 20), rounded to T where
// the plain version rounds.
//
// What bounds it: at the training shape (B 8, S 2048, DI 8192, N 16, bf16,
// fused) the bytes (dt_pre, x, z, dout, the chunk states read; d dt_pre, dx,
// dz written: about 2.15 GB, 0.64 ms at 3.35 TB/s) and the exps (one abar a
// state and step, 2.15 G, 0.51 ms on the SFUs).  The kernel is bound by
// neither but by instruction issue and latency: the FMAs, folds and
// elementwise gradients of every step at two warps a scheduler, which leave
// both the bytes and the SFUs idle most of the time.
//
// Design.  A block is 128 channels of one batch row, 4 warps; a thread holds
// a register tile of 4 channels x 4 states (lane l: channels 4 (l >> 2) ..
// of its warp's 32, states 4 (l & 3) ..), so most of each sum is FMAs in
// registers: over channels (dB, dC) 4 of 128, over states (sum G B, sum a q,
// sum h C) 4 of 16.  What crosses lanes goes by transposing shuffle trees
// that leave each lane one result: dC and dB over the lane bits 4 and 3 (3
// shuffles each; lane bit 2's two halves go to shared memory), sum h C and
// the pair (sum G B, sum a q) over lane bits 1 and 0 (3 and 6), which
// leaves lane l holding its warp's channel l.  So every lane computes the
// elementwise gradients of one channel at every step, with no barrier for
// them.  Time: chunks last to first, their dt, x, B and C staged by
// cp.async into two buffers (the next chunk loads while this one is
// worked), each warp's dy (and z) a sub-chunk ahead into two buffers of
// its own; sub-chunks of kSub = 4 steps, last to first.  A first pass over
// the chunk keeps the state entering every sub-chunk in shared memory
// ([slot][channel][thread] float4s: no bank conflicts), the last one in
// registers; then each sub-chunk is recomputed forward from its start
// keeping its 4 steps' abar, its start and the state after its second
// step in registers (the two other states before a step are stepped again
// from those with the kept abar: an FMA, no exp; dC and, fused, y and dz on
// the way), and swept back, so the sweep calls no exp.  Steps past S and
// channels past DI read zeros (the staging buffers start zeroed), and only
// the ragged last sub-chunk and a block reaching past DI take branches.  Every
// sum runs in a fixed order, so two launches give the same bits: dB and dC
// over a warp by the trees, over the block's warps and halves in order
// after one barrier a sub-chunk, written per block to f32 partials; d a, dD
// and d dt_bias over time in registers, written per batch row;
// scan_bwd_reduce_kernel then sums the partials in block and row order and
// rounds each gradient to its dtype.  No atomics.  The sum over states of
// a q is taken as ln 2 sum a log2(e) q, from the forward's exponent a2 = a
// log2(e), whose ex2 the recompute repeats bit for bit (so the recomputed
// states are the forward's).
//
// Counts a state and step (bf16, S a multiple of 32): exps 1 + 28/32 =
// 1.875 (f32: 1 + 12/16); shuffles 15/16 fused, 12/16 base; the elementwise
// gradients on every thread; dB / dC partials 64 rows at the training
// shape (2 x 134 MB written and read: 0.27 GB).  Warps: 8 an SM (two blocks
// of 4): the tile and the sub-chunk's states take the 255 registers a
// thread (a 2 x 4 tile at 16 warps an SM spilled and ran slower), and the
// shared memory (two staging buffers, the sub-chunk starts) 111 KB a block.
// Measured (chip_smoke.py phase 16 (d), NVIDIA H100 80GB HBM3 at a 700 W
// power limit): 4.70 ms of device a call at the training shape, 7.3x its
// 0.64 ms bound by bytes.
constexpr int kBwdThreads = 128;           // 4 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdCh = 128;                // channels of a block: 32 a warp
constexpr int kTileC = 4;                  // a thread's channels ...
constexpr int kTileN = 4;                  // ... and states
constexpr int kSub = 4;                    // steps of a sub-chunk, kept in registers
constexpr float kLn2 = 0.6931471805599453f;

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

// Shared memory of one backward block: two buffers of a chunk's staged
// inputs (the (kT, kBwdCh) tiles dt and x in T, the (kT, N) rows of B and C
// in TB; the next chunk loads into one while the block works on the other);
// two buffers of each warp's dy (, z) of a sub-chunk [buf][warp][tensor]
// [step][32] in T, likewise; dt as the scan sees it in T; then in f32: B
// and C (kT, 16) zero past N, the sub-chunk starts [slot][channel][thread]
// (float4s), each warp's dy as the scan sees it of a sub-chunk
// [warp][step][lane], the dB / dC sums of a sub-chunk's steps by sub-chunk
// parity [2][warp][step][kind][lane], D and dt_bias.
template <typename T, typename TB, bool kFused> struct BwdSmem {
  static constexpr int kT = Smem<T, TB, kFused>::kT;  // the forward's chunk
  static constexpr int kSubs = kT / kSub;
  static constexpr int kStarts = kSubs - 2;  // kept: sub-chunks 1 .. kSubs - 2
  static constexpr int kTile = kT * kBwdCh;
  static constexpr int kRows = kT * kMaxN;
  static constexpr size_t kBufBytes = 2 * kTile * sizeof(T) + 2 * kRows * sizeof(TB);
  static constexpr int kGzTensors = kFused ? 2 : 1;  // dy, and z
  static constexpr int kGz = kBwdWarps * kGzTensors * kSub * 32;  // elements of one buffer
  static constexpr size_t kGzOff = 2 * kBufBytes;
  static constexpr size_t kDtsOff = kGzOff + 2 * kGz * sizeof(T);
  static constexpr size_t kF32 = kDtsOff + kTile * sizeof(T);  // a multiple of 16
  static constexpr int kStartFloats = kStarts * kTileC * kTileN * kBwdThreads;
  static constexpr int kDyFloats = kBwdWarps * kSub * 32;
  static constexpr int kRedFloats = 2 * kBwdWarps * kSub * 2 * 32;
  static constexpr size_t kFloats =
      2 * kRows + kStartFloats + kDyFloats + kRedFloats + 2 * kBwdCh;
  static constexpr size_t kBytes = kF32 + kFloats * sizeof(float);
};

// v[0, 2W) on each lane -> v[0, W) summed with the partner lane's (lane ^ M)
// matching half: a lane whose bit M is set keeps and receives the upper W
// values, the other the lower W (W shuffles, a fixed order)
template <int W, int M> __device__ __forceinline__ void fold(float* v, int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = up ? v[j] : v[j + W];
    const float keep = up ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// 4 neighbouring elements of T (8 or 16 bytes, aligned) as f32
template <typename T> __device__ __forceinline__ void load4(const T* p, float (&f)[4]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = lo.x, f[1] = lo.y, f[2] = hi.x, f[3] = hi.y;
  }
}

__device__ __forceinline__ void load4f(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}

template <typename T, typename TB, bool kFused>
__global__ void __launch_bounds__(kBwdThreads, 2) scan_bwd_kernel(const ScanBwdArgs p) {
  using L = BwdSmem<T, TB, kFused>;
  constexpr int kT = L::kT, V = model::Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  auto raw = [&](int buf, int tile) {  // tile 0 dt, 1 x of buffer buf
    return reinterpret_cast<T*>(smem + buf * L::kBufBytes) + tile * L::kTile;
  };
  auto rows = [&](int buf, int which) {  // 0 B, 1 C of buffer buf
    return reinterpret_cast<TB*>(smem + buf * L::kBufBytes + 2 * L::kTile * sizeof(T)) +
           which * L::kRows;
  };
  T* Gz = reinterpret_cast<T*>(smem + L::kGzOff);
  T* Dts = reinterpret_cast<T*>(smem + L::kDtsOff);
  float* Bf = reinterpret_cast<float*>(smem + L::kF32);
  float* Cf = Bf + L::kRows;
  float4* Starts = reinterpret_cast<float4*>(Cf + L::kRows);
  float* Dyw = reinterpret_cast<float*>(Starts) + L::kStartFloats;
  float* Red = Dyw + L::kDyFloats;
  float* Ds = Red + L::kRedFloats;
  float* Bias = Ds + kBwdCh;

  const int S = p.S, DI = p.DI, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sg = lane & 3;                            // this thread's states 4 sg ..
  const int cl = warp * 32 + (lane >> 2) * kTileC;    // ... of channels d0 + cl ..
  const int co = tid;                                 // the lane's own channel (warp 32 + lane)
  const int b = blockIdx.y, blk = blockIdx.x, d0 = blk * kBwdCh;
  const int nch = min(kBwdCh, DI - d0);
  const bool own = co < nch;
  const T* dt = static_cast<const T*>(p.dt);
  const T* x = static_cast<const T*>(p.x);
  const T* z = static_cast<const T*>(p.z);
  const T* dy = static_cast<const T*>(p.dy);
  const TB* bm = static_cast<const TB*>(p.bm);
  const TB* cm = static_cast<const TB*>(p.cm);
  T* ddt = static_cast<T*>(p.ddt);
  T* dxo = static_cast<T*>(p.dx);
  T* dzo = static_cast<T*>(p.dz);

  // chunk k's dt, x, B and C into buffer k & 1
  auto stage = [&](int k) {
    const int t0 = k * kT, len = min(kT, S - t0), buf = k & 1;
    const size_t row0 = (size_t)b * S + t0;
    stage_tile<T, kBwdCh, kBwdThreads>(raw(buf, 0), dt + row0 * DI + d0, DI, len, nch,
                                       p.vec_act);
    stage_tile<T, kBwdCh, kBwdThreads>(raw(buf, 1), x + row0 * DI + d0, DI, len, nch,
                                       p.vec_act);
    stage_rows<TB, kBwdThreads>(rows(buf, 0), bm + row0 * N, len * N, p.vec_bc);
    stage_rows<TB, kBwdThreads>(rows(buf, 1), cm + row0 * N, len * N, p.vec_bc);
  };
  // the warp's dy (, z) at the 4 steps of sub-chunk s of chunk k into Gz
  // buffer gb: 16 bytes a copy, zero past S and the block's channels
  constexpr int kPerRow = 32 * (int)sizeof(T) / 16;  // copies of a warp's row of one step
  auto stage_gz = [&](int k, int s, int gb) {
    T* dst0 = Gz + (gb * kBwdWarps + warp) * (L::kGzTensors * kSub * 32);
    for (int e = lane; e < L::kGzTensors * kSub * kPerRow; e += 32) {
      const int row = e / kPerRow, part = (e % kPerRow) * V;
      const int tensor = row / kSub, i = row % kSub;
      const int t = k * kT + s * kSub + i, c = warp * 32 + part;
      const size_t r = (size_t)b * S + min(t, S - 1);
      const T* src = tensor ? z + (long long)r * p.z_stride + d0 + c : dy + r * DI + d0 + c;
      T* dst = dst0 + row * 32 + part;
      if (p.vec_act) {
        model::cp_async16(dst, t < S && c < nch ? src : dy, t < S && c < nch ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          dst[j] = t < S && c + j < nch ? src[j] : model::from_f<T>(0.f);
      }
    }
  };

  // the staged tiles zero where nothing is staged (past the block's channels,
  // past S), so those lanes read zeros
  for (int e = tid; e < (int)(2 * L::kBufBytes / 16); e += kBwdThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int chunks = (S + kT - 1) / kT;
  stage(chunks - 1);
  model::cp_async_commit();
  int gb = 0;  // the Gz buffer of the sub-chunk being worked
  stage_gz(chunks - 1, (S - (chunks - 1) * kT + kSub - 1) / kSub - 1, gb);
  model::cp_async_commit();
  Ds[tid] = own ? p.d_skip[d0 + co] : 0.f;
  if (kFused) Bias[tid] = own ? model::to_f(static_cast<const T*>(p.dt_bias)[d0 + co]) : 0.f;
  float a2[kTileC][kTileN], g[kTileC][kTileN], da[kTileC][kTileN];
#pragma unroll
  for (int c = 0; c < kTileC; ++c)
#pragma unroll
    for (int j = 0; j < kTileN; ++j) {
      const int n = sg * kTileN + j;
      const bool in = cl + c < nch && n < N;
      const size_t dn = (size_t)(d0 + cl + c) * N + n;
      a2[c][j] = in ? -expf(p.a_log[dn]) * kLog2e : 0.f;  // the forward's exponent, bit for bit
      g[c][j] = in && p.dh != nullptr ? p.dh[(size_t)b * DI * N + dn] : 0.f;
      da[c][j] = 0.f;
    }
  float acc_d = 0.f, acc_bias = 0.f;

  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * kT, len = min(kT, S - t0), buf = k & 1;
    model::cp_async_wait<0>();  // chunk k has landed (this thread's copies)
    __syncthreads();            // ... and every thread's; chunk k + 1 is done with
    if (k > 0) stage(k - 1);    // loads while chunk k is worked
    model::cp_async_commit();

    // B and C to f32, zero past N and len; dt as the scan sees it (fused:
    // T(softplus(T(dt_pre + dt_bias))), as the forward computes it), zero
    // past the block's channels and len, where x is zero too (never staged),
    // so those lanes carry zeros
    const TB* braw = rows(buf, 0);
    const TB* craw = rows(buf, 1);
    for (int e = tid; e < L::kRows; e += kBwdThreads) {
      const int i = e / kMaxN, n = e % kMaxN;
      const bool in = i < len && n < N;
      Bf[e] = in ? model::to_f(braw[i * N + n]) : 0.f;
      Cf[e] = in ? model::to_f(craw[i * N + n]) : 0.f;
    }
    T* xs = raw(buf, 1);
    constexpr int kPrep = L::kTile / (kBwdThreads * V);  // vectors of the tile a thread
    float v[kPrep][V];
#pragma unroll
    for (int it = 0; it < kPrep; ++it) model::load16(raw(buf, 0) + (it * kBwdThreads + tid) * V, v[it]);
    if constexpr (kFused) {  // every table lookup issued before the first is used
#pragma unroll
      for (int it = 0; it < kPrep; ++it)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float u = round_to<T>(v[it][j] + Bias[(tid * V) % kBwdCh + j]);
          if constexpr (std::is_same<T, __nv_bfloat16>::value)
            v[it][j] = __bfloat162float(__ldg(g_softplus + bf16_bits(u)));
          else
            v[it][j] = u > 20.f ? u : log1pf(expf(u));
        }
    }
#pragma unroll
    for (int it = 0; it < kPrep; ++it) {
      const int e = (it * kBwdThreads + tid) * V;
      const int i = e / kBwdCh, cc = e % kBwdCh;
#pragma unroll
      for (int j = 0; j < V; ++j) v[it][j] = i < len && cc + j < nch ? v[it][j] : 0.f;
      model::store16(Dts + e, v[it]);
    }
    __syncthreads();

    // this thread's tile of step t: the offsets of its dt and x (of its
    // channels) and of its B and C (of its states); a sub-chunk adds a
    // constant i to t, so its loads take immediate offsets
    const T* dts_c = Dts + cl;
    const T* xs_c = xs + cl;
    const float* bf_c = Bf + sg * kTileN;
    const float* cf_c = Cf + sg * kTileN;
    // dt, dt x and the B row of step t
    auto load_step = [&](int t, float (&dtv)[kTileC], float (&dxv)[kTileC],
                         float (&bv)[kTileN]) {
      float xv[kTileC];
      load4<T>(dts_c + t * kBwdCh, dtv);
      load4<T>(xs_c + t * kBwdCh, xv);
      load4f(bf_c + t * kMaxN, bv);
#pragma unroll
      for (int c = 0; c < kTileC; ++c) dxv[c] = dtv[c] * xv[c];
    };
    // the recurrence's step i, as the forward takes it: h updated, abar in ab
    auto step = [&](int i, float (&h)[kTileC][kTileN], float (&ab)[kTileC][kTileN]) {
      float dtv[kTileC], dxv[kTileC], bv[kTileN];
      load_step(i, dtv, dxv, bv);
#pragma unroll
      for (int c = 0; c < kTileC; ++c)
#pragma unroll
        for (int j = 0; j < kTileN; ++j) {
          ab[c][j] = ex2(dtv[c] * a2[c][j]);
          h[c][j] = fmaf(ab[c][j], h[c][j], dxv[c] * bv[j]);
        }
    };
    // step i again from its abar: no exp, the same bits
    auto restep = [&](int i, float (&h)[kTileC][kTileN], const float (&ab)[kTileC][kTileN]) {
      float dtv[kTileC], dxv[kTileC], bv[kTileN];
      load_step(i, dtv, dxv, bv);
#pragma unroll
      for (int c = 0; c < kTileC; ++c)
#pragma unroll
        for (int j = 0; j < kTileN; ++j) h[c][j] = fmaf(ab[c][j], h[c][j], dxv[c] * bv[j]);
    };
    auto load_hs = [&](float (&h)[kTileC][kTileN]) {  // the state the forward saved
#pragma unroll
      for (int c = 0; c < kTileC; ++c)
#pragma unroll
        for (int j = 0; j < kTileN; ++j) {
          const int n = sg * kTileN + j;
          h[c][j] = cl + c < nch && n < N
                        ? p.hs[(((size_t)b * chunks + k) * DI + d0 + cl + c) * N + n]
                        : 0.f;
        }
    };

    // the sub-chunks' starts: 1 .. nsub - 2 into shared memory, the last
    // one left in h
    const int nsub = (len + kSub - 1) / kSub;
    float h[kTileC][kTileN];
    load_hs(h);
    for (int s = 0; s + 1 < nsub; ++s) {
      float ab[kTileC][kTileN];
#pragma unroll
      for (int i = 0; i < kSub; ++i) step(s * kSub + i, h, ab);
      if (s + 2 < nsub) {
#pragma unroll
        for (int c = 0; c < kTileC; ++c)
          Starts[(s * kTileC + c) * kBwdThreads + tid] =
              make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
      }
    }

    // sub-chunk s from its start in h: forward over it keeping its steps'
    // abar, its start and the state after its second step (the other two
    // states before a step are stepped again from those, without an exp),
    // with dC and, fused, y and dz of the lane's own channel on the way;
    // then back over it.  Branch-free where every channel of the block is
    // live (kFull) but for the block's ragged last sub-chunk (kRagged), whose
    // steps past len are skipped.
    auto sub_chunk = [&](auto ragged, auto full, int s) {
      constexpr bool kRagged = decltype(ragged)::value, kFull = decltype(full)::value;
      const bool live = kFull || own;  // the lane's own channel: its gradients are stored
      const int i0 = s * kSub;
      // the lane's elements at the sub-chunk's first step in (B, S, DI)
      const size_t o0 = ((size_t)b * S + t0 + i0) * DI + d0 + co;
      float* red = Red + (s & 1) * (kBwdWarps * kSub * 64) + warp * (kSub * 64);
      // the next sub-chunk's dy (, z) load while this one is worked; this
      // one's have landed
      if (s > 0)
        stage_gz(k, s - 1, gb ^ 1);
      else if (k > 0)
        stage_gz(k - 1, (kT + kSub - 1) / kSub - 1, gb ^ 1);
      model::cp_async_commit();
      model::cp_async_wait<1>();
      __syncwarp();
      const T* gz = Gz + (gb * kBwdWarps + warp) * (L::kGzTensors * kSub * 32) + lane;
      // dy as the scan sees it (fused: dout silu(z)) of the lane's own
      // channel, for the warp; dD on the way
      float kz[kSub];  // fused: silu'(z), for dz
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = i0 + i, at = t * kBwdCh + co;
        float dyv = model::to_f(gz[i * 32]);
        if (kFused) {
          const float zv = model::to_f(gz[(kSub + i) * 32]);
          const float sgm = __fdividef(1.f, 1.f + __expf(-zv));
          dyv = dyv * (zv * sgm);
          kz[i] = sgm * (1.f + zv * (1.f - sgm));
        }
        dyv = live && (!kRagged || t < len) ? dyv : 0.f;
        acc_d = fmaf(dyv, model::to_f(xs[at]), acc_d);
        Dyw[(warp * kSub + i) * 32 + lane] = dyv;
      }
      __syncwarp();

      float h0[kTileC][kTileN], h1[kTileC][kTileN], ab[kSub][kTileC][kTileN];
#pragma unroll
      for (int c = 0; c < kTileC; ++c)
#pragma unroll
        for (int j = 0; j < kTileN; ++j) h0[c][j] = h[c][j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = i0 + i;
        if (kRagged && t >= len) continue;
        step(t, h, ab[i]);
        if (i == 1) {
#pragma unroll
          for (int c = 0; c < kTileC; ++c)
#pragma unroll
            for (int j = 0; j < kTileN; ++j) h1[c][j] = h[c][j];
        }
        float dyv[kTileC], cv[kTileN], dcp[kTileN];
        load4f(Dyw + (warp * kSub + i) * 32 + (lane >> 2) * kTileC, dyv);
        load4f(Cf + t * kMaxN + sg * kTileN, cv);
#pragma unroll
        for (int j = 0; j < kTileN; ++j) {
          dcp[j] = dyv[0] * h[0][j];
#pragma unroll
          for (int c = 1; c < kTileC; ++c) dcp[j] = fmaf(dyv[c], h[c][j], dcp[j]);
        }
        fold<2, 16>(dcp, lane);
        fold<1, 8>(dcp, lane);
        red[(i * 2 + 1) * 32 + lane] = dcp[0];
        if constexpr (kFused) {
          float yp[kTileC];
#pragma unroll
          for (int c = 0; c < kTileC; ++c) {
            yp[c] = h[c][0] * cv[0];
#pragma unroll
            for (int j = 1; j < kTileN; ++j) yp[c] = fmaf(h[c][j], cv[j], yp[c]);
          }
          fold<2, 2>(yp, lane);
          fold<1, 1>(yp, lane);  // sum_n h C of channel co
          const int at = t * kBwdCh + co;
          const float yv = yp[0] + Ds[co] * model::to_f(xs[at]);
          const T dz = model::from_f<T>(model::to_f(gz[i * 32]) * yv * kz[i]);
          if (live) dzo[o0 + (size_t)i * DI] = dz;
        }
      }

#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int t = i0 + i;
        if (kRagged && t >= len) continue;
        float hp[kTileC][kTileN];  // the state before step t
#pragma unroll
        for (int c = 0; c < kTileC; ++c)
#pragma unroll
          for (int j = 0; j < kTileN; ++j) hp[c][j] = i < 2 ? h0[c][j] : h1[c][j];
        if (i == 1 || i == 3) restep(t - 1, hp, ab[i - 1]);
        float dtv[kTileC], xv[kTileC], dyv[kTileC], bv[kTileN], cv[kTileN];
        load4<T>(Dts + t * kBwdCh + cl, dtv);
        load4<T>(xs + t * kBwdCh + cl, xv);
        load4f(Dyw + (warp * kSub + i) * 32 + (lane >> 2) * kTileC, dyv);
        load4f(Bf + t * kMaxN + sg * kTileN, bv);
        load4f(Cf + t * kMaxN + sg * kTileN, cv);
        float dbp[kTileN] = {0.f, 0.f, 0.f, 0.f};
        float sums[2 * kTileC];  // (sum_n G B, sum_n a2 q) of each channel
#pragma unroll
        for (int c = 0; c < kTileC; ++c) {
          const float dtx = dtv[c] * xv[c];
          float sb = 0.f, sa = 0.f;
#pragma unroll
          for (int j = 0; j < kTileN; ++j) {
            g[c][j] = fmaf(dyv[c], cv[j], g[c][j]);
            dbp[j] = fmaf(g[c][j], dtx, dbp[j]);
            sb = fmaf(g[c][j], bv[j], sb);
            const float gab = g[c][j] * ab[i][c][j];
            const float q = gab * hp[c][j];
            da[c][j] = fmaf(dtv[c], q, da[c][j]);
            sa = fmaf(a2[c][j], q, sa);
            g[c][j] = gab;
          }
          sums[2 * c] = sb;
          sums[2 * c + 1] = sa;
        }
        fold<2, 16>(dbp, lane);
        fold<1, 8>(dbp, lane);
        red[(i * 2) * 32 + lane] = dbp[0];
        fold<4, 2>(sums, lane);
        fold<2, 1>(sums, lane);  // (sum G B, sum a2 q) of channel co
        // the elementwise gradients of channel co (stored where it is live)
        const int at = t * kBwdCh + co;
        const size_t o = o0 + (size_t)i * DI;
        const float s_b = sums[0];
        const float gdt = model::to_f(xs[at]) * s_b + sums[1] * kLn2;
        T du;
        if constexpr (kFused) {
          const float gr = round_to<T>(gdt);
          const float u = round_to<T>(model::to_f(raw(buf, 0)[at]) + Bias[co]);
          const float e = __expf(u);
          du = model::from_f<T>(u > 20.f ? gr : __fdividef(gr * e, e + 1.f));
          acc_bias += model::to_f(du);
        } else {
          du = model::from_f<T>(gdt);
        }
        const T dxv = model::from_f<T>(model::to_f(Dts[at]) * s_b +
                                       Ds[co] * Dyw[(warp * kSub + i) * 32 + lane]);
        if (live) {
          ddt[o] = du;
          dxo[o] = dxv;
        }
      }
    };

    for (int s = nsub - 1; s >= 0; --s) {
      const int i0 = s * kSub;
      if (s + 1 < nsub) {
        if (s == 0) {
          load_hs(h);
        } else {
#pragma unroll
          for (int c = 0; c < kTileC; ++c) {
            const float4 v = Starts[((s - 1) * kTileC + c) * kBwdThreads + tid];
            h[c][0] = v.x, h[c][1] = v.y, h[c][2] = v.z, h[c][3] = v.w;
          }
        }
      }
      if (i0 + kSub > len)
        sub_chunk(std::true_type{}, std::false_type{}, s);
      else if (nch == kBwdCh)
        sub_chunk(std::false_type{}, std::true_type{}, s);
      else
        sub_chunk(std::false_type{}, std::false_type{}, s);
      __syncthreads();  // the sub-chunk's dB / dC sums are in
      gb ^= 1;
      {  // dB, dC of the sub-chunk's steps: the warps and halves in order
        const int i = tid >> 5, kind = (tid >> 4) & 1, n = tid & 15;
        const int t = i0 + i;
        if (t < len && n < N) {
          const float* src = Red + (s & 1) * (kBwdWarps * kSub * 64) + (i * 2 + kind) * 32 +
                             ((n >> 2) | ((n & 3) << 3));
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kBwdWarps; ++w) sum += src[w * kSub * 64] + src[w * kSub * 64 + 4];
          float* dst = kind ? p.part_c : p.part_b;
          dst[(((size_t)blk * p.B + b) * S + t0 + t) * N + n] = sum;
        }
      }
    }
  }
  if (own) {
    p.part_d[(size_t)b * DI + d0 + co] = acc_d;
    if (kFused) p.part_bias[(size_t)b * DI + d0 + co] = acc_bias;
  }
#pragma unroll
  for (int c = 0; c < kTileC; ++c)
#pragma unroll
    for (int j = 0; j < kTileN; ++j) {
      const int n = sg * kTileN + j;
      if (cl + c < nch && n < N) p.part_a[((size_t)b * DI + d0 + cl + c) * N + n] = da[c][j];
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
  scan_bwd_kernel<T, TB, kFused><<<grid, kBwdThreads, L::kBytes, stream>>>(p);
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
// B x S x N floats, part_row B x DI x N + 2 x B x DI (blocks = ceil(DI/128)).
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
  const int blocks = (DI + kBwdCh - 1) / kBwdCh;
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

// Hand-written Hopper (sm_90a) kernel for GQA flash attention (forward).
//
// Replaces (JAX package) kernels/flash_attention/kernel.py::flash_attention
// (:77, pallas_call :95).  Computes softmax(q k^T / sqrt(hd)) v per query
// head, query head h reading kv head h / (Hq / Hkv), with f32 scores,
// running max, denominator and accumulator, the output stored in q's dtype
// (f32 or bf16).  With `causal`, key t is visible to query s iff t <= s, both
// counted from position 0.  Plain C interface (extern "C", raw pointers, the
// stream as void*), built by nvcc at first use and bound with ctypes by
// ../kernel.py; the entry point returns cudaGetLastError() of its launch.
//
// What bounds it on this card.  At the serving path's prefill (B 8, S = T
// 512, Hq 9, Hkv 3, hd 64, causal, bf16) the work is 2.4 GFLOP per layer
// against 12.6 MB of q, k, v and out: 3.8 us for the bytes at 3.35 TB/s,
// 2.4 us for the operations on the bf16 tensor cores -- so the card's bound
// is bytes.  This kernel does its products as scalar f32 FMAs, whose peak
// (67 TFLOP/s) puts its own floor at 36 us: operations bound it.
//
// Design.  One block per (query tile of 64 rows, query head, batch row);
// one thread per query row, holding its q row and its f32 accumulator in
// registers.  The block walks the key tiles (64 keys; 32 for hd 128, to stay
// under 48 KB of static shared memory) up to the diagonal -- tiles wholly
// above it are never loaded -- staging each K and V tile in shared memory as
// f32, read by all threads as broadcasts.  Keys are taken 16 at a time: 16
// scores, one rescale of the accumulator by exp(m_old - m_new), then the 16
// weighted V rows.  The last query tile may be ragged (S % 64 != 0): its
// missing rows take part in the tile loads and store nothing.  (The TPU
// kernel drops those rows instead: n_q = S // blk_q.)  The final divide is
// by max(l, 1e-30).  The products are scalar f32 FMAs; wgmma/mma.sync tiles,
// TMA loads and pipelining are later work.

#include <math.h>

#include "../../model_common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block = threads per block
constexpr int kChunk = 16;  // keys per online-softmax rescale

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk, int Hq,
                 int Hkv, int causal, float scale) {
  constexpr int BK = HD >= 128 ? 32 : 64;  // keys per shared-memory tile
  constexpr int H4 = HD / 4;
  __shared__ float4 Ks[BK * H4];
  __shared__ float4 Vs[BK * H4];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int qpos = q0 + threadIdx.x;
  const bool live = qpos < S;

  float qr[HD], acc[HD];
  if (live) {
    const T* qp = q + (((size_t)b * S + qpos) * Hq + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = model::to_f(qp[d]);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int q_end = min(S, q0 + kBQ);  // one past the tile's last query
  const int kv_end = causal ? min(Tk, q_end) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < BK * HD; e += kBQ) {
      const int row = e / HD, col = e % HD;
      const int kp = k0 + row;
      float kk = 0.f, vv = 0.f;
      if (kp < Tk) {
        const size_t off = (((size_t)b * Tk + kp) * Hkv + kvh) * HD + col;
        kk = model::to_f(k[off]);
        vv = model::to_f(v[off]);
      }
      reinterpret_cast<float*>(Ks)[e] = kk;
      reinterpret_cast<float*>(Vs)[e] = vv;
    }
    __syncthreads();

    // keys of this tile visible to this row: t < Tk, and t <= qpos if causal
    int n_keys = min(BK, Tk - k0);
    if (causal) n_keys = min(n_keys, qpos - k0 + 1);
    for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
      float s[kChunk];
      float mc = -INFINITY;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        s[i] = -INFINITY;
        if (c0 + i < n_keys) {
          const float4* kr = Ks + (c0 + i) * H4;
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
          for (int j = 0; j < H4; ++j) {
            const float4 kv4 = kr[j];
            d0 = fmaf(qr[4 * j], kv4.x, d0);
            d1 = fmaf(qr[4 * j + 1], kv4.y, d1);
            d2 = fmaf(qr[4 * j + 2], kv4.z, d2);
            d3 = fmaf(qr[4 * j + 3], kv4.w, d3);
          }
          s[i] = ((d0 + d1) + (d2 + d3)) * scale;
        }
        mc = fmaxf(mc, s[i]);
      }
      const float m_new = fmaxf(m, mc);  // finite: key c0 is visible
      const float alpha = expf(m - m_new);  // 0 on the first chunk (m = -inf)
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (c0 + i < n_keys) {
          const float p = expf(s[i] - m_new);
          l += p;
          const float4* vr = Vs + (c0 + i) * H4;
#pragma unroll
          for (int j = 0; j < H4; ++j) {
            const float4 vv4 = vr[j];
            acc[4 * j] = fmaf(p, vv4.x, acc[4 * j]);
            acc[4 * j + 1] = fmaf(p, vv4.y, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(p, vv4.z, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(p, vv4.w, acc[4 * j + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = out + (((size_t)b * S + qpos) * Hq + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) op[d] = model::from_f<T>(acc[d] * inv);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
           int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tk, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
             int Hq, int Hkv, int HD, int causal, float scale, cudaStream_t stream) {
  switch (HD) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, Hq, Hkv, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, Hq, Hkv, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, Hq, Hkv, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, Hq, Hkv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,Hq,HD), k/v (B,Tk,Hkv,HD), out (B,S,Hq,HD); one dtype for all four
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int Tk, int Hq, int Hkv, int HD,
                                   int causal, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, Tk, Hq, Hkv, HD, causal, scale, s);
  return dispatch<float>(q, k, v, out, B, S, Tk, Hq, Hkv, HD, causal, scale, s);
}

// Hand-written Hopper (sm_90a) kernels for GQA flash attention (forward).
//
// Replaces (JAX package) kernels/flash_attention/kernel.py::flash_attention
// (:77, pallas_call :95).  Computes softmax(q k^T / sqrt(hd)) v per query
// head, query head h reading kv head h / (Hq / Hkv), with f32 scores,
// running max, denominator and accumulator, the output stored in q's dtype
// (f32 or bf16).  With `causal`, key t is visible to query s iff t <= s, both
// counted from position 0.  The last query tile may be ragged (S % 64 != 0):
// its missing rows load zeros, take part in the tiles and store nothing.
// (The TPU kernel drops those rows instead: n_q = S // blk_q.)  The final
// divide is by max(l, 1e-30).  Plain C interface (extern "C", raw pointers,
// the stream as void*), built by nvcc at first use and bound with ctypes by
// ../kernel.py; the entry point returns the CUDA error of its launch.
//
// bf16: flash_mma_kernel, on the tensor cores.
//
// What bounds it on this card.  At the serving path's prefill (B 8, S = T
// 512, Hq 9, Hkv 3, hd 64, causal) the work is 2.4 GFLOP per layer against
// 12.6 MB of q, k, v and out: 3.8 us for the bytes at 3.35 TB/s, 2.4 us for
// the products at the bf16 tensor cores' 989 TFLOP/s, so the card's bound is
// bytes.  Both are small next to the kernel's own latency (a block walks up
// to 8 key tiles one after another), so the design aims at keeping the
// tensor cores fed and every SM busy rather than at the last byte.  Measured
// (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3 at a 700 W power limit):
// 0.0199-0.0202 ms of device time per launch, 5.3x the byte bound and 1.3x
// scaled_dot_product_attention's 0.0152-0.0153 ms on the same inputs; the
// scalar kernel it replaces took 0.3698-0.3875 ms in the same run.
//
// Design.  One block per (64 query positions, query head, batch row): 8
// tiles x 9 heads x 8 batch rows = 576 blocks at the serving shape, the
// heaviest (last, most key tiles) query tiles handed out first.  The block's
// 4 warps own 16 positions each, so a warp's f32 accumulator (hd / 2 floats
// a lane) stays in registers.  The query heads of a GQA group load their kv
// head's K/V tiles in blocks of their own: the repeated reads come from the
// 50 MB L2 (all of K and V is 3.1 MB at the serving shape), and blocks that
// served the whole group (3 heads, 192 blocks) measured no faster on the
// card (PERF.md).  Shared memory holds the block's Q rows and two K/V tiles
// of 64 keys, filled by cp.async (16 bytes a thread, zero-filled past S and
// T) and double-buffered: tile i+1 loads while tile i is used.  Rows are
// padded by 16 bytes (hd + 8 bf16), so the 8 row addresses of every ldmatrix
// fall in 8 different 16-byte bank groups: no bank conflicts at any hd of
// 16..128 (at hd 112 a row is 240 bytes, 60 words: 8 rows start at words
// 0, 28, 24, ..., 4 mod 32).  Per tile a warp computes S = Q K^T (16 x
// 64) with mma.sync.m16n8k16 (bf16 in, f32 accumulate; Q and K fragments by
// ldmatrix), scales it into the exp2 domain (scale * log2 e), masks keys
// t >= T and, on tiles that reach past the warp's first row, keys t > s to
// -inf before the row max, reduces the max over the 4 lanes of a quad with
// __shfl_xor_sync, rescales its accumulator by exp2(m_old - m_new) (0 on the
// first tile, where m_old = -inf; a row with no visible key yet uses 0 as
// its base, so -inf - -inf never occurs), and multiplies P, rounded to bf16
// in the registers that held S, by V (fragments by ldmatrix.trans) into the
// f32 accumulator.  Tiles wholly above the diagonal are never loaded.  The
// output is staged through the warp's own Q rows and stored as 16-byte rows.
// At hd 64: 128 threads of 121 registers (no spills; 168 at hd 128) and 45
// KB of dynamic shared memory (85 KB at hd 128; cudaFuncSetAttribute before
// the first launch), so 4 blocks are resident per SM, by registers and
// shared memory alike, and the 576 blocks run as 528 and then the 48
// lightest; at hd 128, 2 blocks per SM, by shared memory.  Head dim 112
// (zamba2's 32 heads in d 3584): 7 k-steps of Q K^T, 14 accumulator column
// blocks (7 ldmatrix.x4.trans a key step, two products each), 14 16-byte
// chunks a row, 128 registers (no spills) and 75 KB of shared memory, so 2
// blocks per SM, by shared memory.  Measured (chip_smoke.py phase 14, H100
// 80GB HBM3 at 700 W): 0.1022 ms of device time at zamba2's prefill (8, 512,
// 32, 32, 112), 2.9x its byte bound and 1.84x scaled_dot_product_attention's.
//
// Numerics.  Q K^T multiplies bf16 by bf16 exactly into f32 (8-bit
// significands, 16-bit products), as the reference's f32 dot of bf16-valued
// inputs does, and sums in another order.  P is rounded to bf16 for the PV
// product, at most 2^-8 relative error per weight (bf16 keeps 8 significant
// bits), while the denominator l sums the unrounded f32 weights; the output
// then rounds to bf16.  Held to atol = rtol = 1e-2 against the plain version
// (chip_smoke.py).
//
// f32: flash_scalar_kernel, exact to 1e-5 and on no serving path.  One
// thread per query row holding its q row and f32 accumulator in registers,
// K and V tiles in shared memory as f32, keys 16 at a time per rescale; its
// products are scalar f32 FMAs, whose peak (67 TFLOP/s) bounds it.  At hd
// 112 and 128 its per-thread q row and accumulator fill the 255 registers
// and spill a little (84 and 844 bytes of stores, `-Xptxas -v`).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <math.h>

#include "../../model_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ f32, scalar
constexpr int kBQ = 64;  // query rows per block = threads per block
constexpr int kChunk = 16;  // keys per online-softmax rescale

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ)
flash_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                    int S, int Tk, int Hq, int Hkv, int causal, float scale) {
  // keys per shared-memory tile: K and V tiles of f32 within the 48 KB of
  // static shared memory (hd 112 at 64 keys would need 56 KB)
  constexpr int BK = HD > 64 ? 32 : 64;
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
  if (lse != nullptr) lse[((size_t)b * Hq + h) * S + qpos] = m + logf(l);
  T* op = out + (((size_t)b * S + qpos) * Hq + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) op[d] = model::from_f<T>(acc[d] * inv);
}

template <int HD>
int launch_scalar(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                  int S, int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_scalar_kernel<float, HD><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Tk, Hq, Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16, tensor cores
constexpr int kPosWarps = 4;         // warps along the query positions of one head
constexpr int kRows = 16 * kPosWarps;  // query positions per block
constexpr int kKeys = 64;            // keys per K/V tile

template <int HD> constexpr int smem_bytes() {
  return (kRows + 4 * kKeys) * (HD + 8) * (int)sizeof(bf16);
}

using model::cp_async16;
using model::cp_async_commit;
using model::cp_async_wait;
using model::smem_addr;

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + c): the accumulator's
// [0], [1] are row g, columns 2c, 2c+1 and [2], [3] row g + 8, the same
// columns.  S's accumulators of key blocks 2j and 2j+1 are, packed to bf16,
// the A operand of key step j of P V.  Warp w serves positions q0 + 16 w ..
// + 15 of the block's query head.
template <int HD>
__global__ void __launch_bounds__(32 * kPosWarps)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int B, int S, int Tk, int Hq, int Hkv, int causal, float scale_log2) {
  constexpr int NT = 32 * kPosWarps;  // threads
  constexpr int LD = HD + 8;   // bf16 per shared row: 16 bytes of padding
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int DB = HD / 8;   // 8-wide column blocks of the accumulator
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kRows][LD]
  bf16* Ks = Qs + kRows * LD;                // [2][kKeys][LD]
  bf16* Vs = Ks + 2 * kKeys * LD;            // [2][kKeys][LD]

  const int n_qt = (S + kRows - 1) / kRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (Hq * B));  // heaviest first
  const int b = blockIdx.x % (Hq * B) / Hq;
  const int h = blockIdx.x % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x, lane = tid % 32;
  const int p0 = 16 * (tid / 32);  // the warp's first position in the tile

  // the block's Q rows (zeros past S), then K/V tile 0
  for (int c = tid; c < kRows * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const int s = q0 + r;
    const bf16* src = q + (((size_t)b * S + min(s, S - 1)) * Hq + h) * HD + ch * 8;
    cp_async16(Qs + r * LD + ch * 8, src, s < S ? 16 : 0);
  }
  auto load_kv = [&](int tile, int buf) {
    for (int c = tid; c < kKeys * CH; c += NT) {
      const int r = c / CH, ch = c % CH;
      const int t = tile * kKeys + r;
      const size_t off = (((size_t)b * Tk + min(t, Tk - 1)) * Hkv + kvh) * HD + ch * 8;
      const int n = t < Tk ? 16 : 0;
      cp_async16(Ks + (buf * kKeys + r) * LD + ch * 8, k + off, n);
      cp_async16(Vs + (buf * kKeys + r) * LD + ch * 8, v + off, n);
    }
  };
  const int q_end = min(S, q0 + kRows);  // one past the block's last query
  const int kv_end = causal ? min(Tk, q_end) : Tk;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  load_kv(0, 0);
  cp_async_commit();

  const bf16* Qw = Qs + p0 * LD;  // the warp's 16 Q rows
  float o[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_lo = q0 + p0 + lane / 4;  // this lane's rows: row_lo, row_lo + 8

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and Q) have landed
    __syncthreads();
    const bf16* Kt = Ks + (it & 1) * kKeys * LD;
    const bf16* Vt = Vs + (it & 1) * kKeys * LD;
    const int k0 = it * kKeys;
    const bool masked = k0 + kKeys > Tk || (causal && k0 + kKeys - 1 > q0 + p0);

    float sc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Qw + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], a, kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], a, kb[2], kb[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nb][e] * scale_log2;
        if (masked) {
          const int t = k0 + nb * 8 + (lane & 3) * 2 + (e & 1);
          const int s = row_lo + (e >> 1) * 8;
          if (t >= Tk || (causal && t > s)) x = -INFINITY;
        }
        sc[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }
    uint32_t pa[4][4];  // P as the A operand of key steps 0..3
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float e0 = exp2f(sc[nb][0] - base[0]), e1 = exp2f(sc[nb][1] - base[0]);
      const float e2 = exp2f(sc[nb][2] - base[1]), e3 = exp2f(sc[nb][3] - base[1]);
      l[0] += e0 + e1;
      l[1] += e2 + e3;
      pa[nb / 2][(nb & 1) * 2] = pack_bf16(e0, e1);
      pa[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(e2, e3);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa[ks], vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa[ks], vb[2], vb[3]);
      }
    }
    __syncthreads();  // buffer it & 1 is refilled at the top of iteration it + 1
  }
  cp_async_wait<0>();

  // O / l, staged through the warp's own Q rows, stored as 16-byte rows
  __syncwarp();
  bf16* st = Qs + p0 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tot = quad_sum(l[r]);
    const float inv = 1.f / fmaxf(tot, 1e-30f);
    // the row's log-sum-exp of the unscaled-domain scores: m is in the exp2
    // domain (scores * scale * log2 e), so lse = (m + log2 l) * ln 2
    const int s_row = row_lo + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && s_row < S)
      lse[((size_t)b * Hq + h) * S + s_row] = (m[r] + log2f(tot)) * 0.6931471805599453f;
    bf16* row = st + (lane / 4 + 8 * r) * LD + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DB; ++d)
      *reinterpret_cast<uint32_t*>(row + d * 8) =
          pack_bf16(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH;
    const int s = q0 + p0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(out + (((size_t)b * S + s) * Hq + h) * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(st + r * LD + ch * 8);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
               int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  // the kernel copies 16-byte rows
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  constexpr int smem = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((S + kRows - 1) / kRows) * Hq * B;
  flash_mma_kernel<HD><<<(unsigned)blocks, 32 * kPosWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, B, S, Tk, Hq, Hkv, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
// The port's own kernels (the reference differentiates its jnp attention and
// has no backward Pallas kernel): f32 on the scalar kernels below, bf16 on
// the tensor-core kernels after them.  Given the forward's output o and row
// log-sum-exp lse (natural log of the scaled scores' exp-sum, (B, Hq, S)
// f32), and the output's gradient dO:
//   P[s,t]  = exp(scale q_s.k_t - lse_s)   (0 where masked: t >= T, or t > s)
//   D_s     = dO_s . o_s
//   dS[s,t] = P[s,t] (dO_s . v_t - D_s)
//   dq_s = scale sum_t dS[s,t] k_t,  dk_t = scale sum_{s,h in group} dS q_s,
//   dv_t = sum_{s,h in group} P[s,t] dO_s.
// flash_bwd_dq_kernel runs first: one block per (query tile, query head,
// batch row); it writes dq and D (B, Hq, S) f32 into a scratch buffer.
// flash_bwd_dkdv_kernel then runs one block per (key tile, kv head, batch
// row), looping over the group's query heads and the query tiles that can
// see its keys, and writes dk and dv.  Neither uses atomics: every output
// element is summed by one thread in a fixed order, so two runs give the
// same bits.  Both read, compute in and store f32.
//
// Layout: a row (query or key) is owned by TPR consecutive lanes, lane j of
// the group holding dims j, j + TPR, ... (EPT of them): its rows of q / dO /
// dq (dq kernel) or k / v / dk / dv (dk/dv kernel) stay in registers.  The
// other side's tile of 32 rows sits in shared memory as f32; all the row
// groups of a warp read the same shared row at once (a broadcast), the TPR
// lanes of a group consecutive words (no bank conflict).  Each (row, tile
// row) pair takes two partial dots over the thread's dims, a butterfly sum
// over the group's lanes (__shfl_xor_sync), one exp and two axpys.
//
// What bounds the scalar kernels: the products, 8 hd flops a visible
// (query, key) pair in the dk/dv kernel and 6 in the dq kernel, on scalar
// f32 FMAs (67 TFLOP/s); the shared-memory reads (one word a lane per FMA
// pair) hold them at about half the FMA rate.  Measured (chip_smoke.py phase
// 15, H100 80GB HBM3 at 700 W) when they also ran bf16: 9.30 ms of device at
// smollm's training shape (8, 2048, 9, 3, 64), 27x SDPA's backward.
constexpr int kBwdThreads = 128;
constexpr int kBwdTile = 32;  // rows of the shared-memory tile

template <int HD> struct BwdLayout {
  static constexpr int TPR = HD >= 112 ? 8 : HD / 16;  // lanes per row
  static constexpr int EPT = HD / TPR;                  // dims a lane holds
  static constexpr int RPB = kBwdThreads / TPR;         // rows per block
};

template <int TPR> __device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse, const float* __restrict__ dout,
                    float* __restrict__ dq, float* __restrict__ dsum, int S, int Tk, int Hq,
                    int Hkv, int causal, float scale) {
  using L = BwdLayout<HD>;
  __shared__ float Ks[kBwdTile][HD];
  __shared__ float Vs[kBwdTile][HD];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int s0 = blockIdx.x * L::RPB;
  const int sub = threadIdx.x % L::TPR;
  const int s = s0 + threadIdx.x / L::TPR;
  const bool live = s < S;

  float qr[L::EPT], dor[L::EPT], acc[L::EPT];
  float dd = 0.f;
  const size_t row = (((size_t)b * S + (live ? s : 0)) * Hq + h) * HD;
#pragma unroll
  for (int e = 0; e < L::EPT; ++e) {
    const int d = sub + L::TPR * e;
    qr[e] = live ? q[row + d] : 0.f;
    dor[e] = live ? dout[row + d] : 0.f;
    dd = fmaf(dor[e], live ? o[row + d] : 0.f, dd);
    acc[e] = 0.f;
  }
  dd = group_sum<L::TPR>(dd);
  const size_t srow = ((size_t)b * Hq + h) * S + (live ? s : 0);
  const float ls = live ? lse[srow] : 0.f;
  if (live && sub == 0) dsum[srow] = dd;

  const int s_end = min(S, s0 + L::RPB);  // one past the block's last query
  const int kv_end = causal ? min(Tk, s_end) : Tk;
  for (int t0 = 0; t0 < kv_end; t0 += kBwdTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBwdTile * HD; i += kBwdThreads) {
      const int r = i / HD, c = i % HD, t = t0 + r;
      float kk = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * Hkv + kvh) * HD + c;
        kk = k[off];
        vv = v[off];
      }
      Ks[r][c] = kk;
      Vs[r][c] = vv;
    }
    __syncthreads();
    const int n = min(kBwdTile, kv_end - t0);
    for (int r = 0; r < n; ++r) {
      const int t = t0 + r;
      float qk = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < L::EPT; ++e) {
        const int d = sub + L::TPR * e;
        qk = fmaf(qr[e], Ks[r][d], qk);
        dp = fmaf(dor[e], Vs[r][d], dp);
      }
      qk = group_sum<L::TPR>(qk);
      dp = group_sum<L::TPR>(dp);
      const bool vis = live && (!causal || t <= s);
      const float p = vis ? expf(qk * scale - ls) : 0.f;
      const float ds = p * (dp - dd);
#pragma unroll
      for (int e = 0; e < L::EPT; ++e) acc[e] = fmaf(ds, Ks[r][sub + L::TPR * e], acc[e]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < L::EPT; ++e) dq[row + sub + L::TPR * e] = acc[e] * scale;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ lse,
                      const float* __restrict__ dout, const float* __restrict__ dsum,
                      float* __restrict__ dk, float* __restrict__ dv, int S, int Tk, int Hq,
                      int Hkv, int causal, float scale) {
  using L = BwdLayout<HD>;
  __shared__ float Qs[kBwdTile][HD];
  __shared__ float Ds[kBwdTile][HD];  // dO rows
  __shared__ float Ls[kBwdTile], Dd[kBwdTile];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int t0 = blockIdx.x * L::RPB;
  const int sub = threadIdx.x % L::TPR;
  const int t = t0 + threadIdx.x / L::TPR;
  const bool live = t < Tk;

  float kr[L::EPT], vr[L::EPT], dka[L::EPT], dva[L::EPT];
  const size_t row = (((size_t)b * Tk + (live ? t : 0)) * Hkv + kvh) * HD;
#pragma unroll
  for (int e = 0; e < L::EPT; ++e) {
    const int d = sub + L::TPR * e;
    kr[e] = live ? k[row + d] : 0.f;
    vr[e] = live ? v[row + d] : 0.f;
    dka[e] = dva[e] = 0.f;
  }
  // queries before the block's first key see none of its keys
  const int q_begin = causal ? t0 / kBwdTile * kBwdTile : 0;
  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    for (int s0 = q_begin; s0 < S; s0 += kBwdTile) {
      __syncthreads();  // the previous tile's readers are done
      for (int i = threadIdx.x; i < kBwdTile * HD; i += kBwdThreads) {
        const int r = i / HD, c = i % HD, s = s0 + r;
        float qq = 0.f, gg = 0.f;
        if (s < S) {
          const size_t off = (((size_t)b * S + s) * Hq + h) * HD + c;
          qq = q[off];
          gg = dout[off];
        }
        Qs[r][c] = qq;
        Ds[r][c] = gg;
      }
      if (threadIdx.x < kBwdTile) {
        const int s = s0 + threadIdx.x;
        const size_t srow = ((size_t)b * Hq + h) * S + s;
        Ls[threadIdx.x] = s < S ? lse[srow] : 0.f;
        Dd[threadIdx.x] = s < S ? dsum[srow] : 0.f;
      }
      __syncthreads();
      const int n = min(kBwdTile, S - s0);
      for (int r = 0; r < n; ++r) {
        const int s = s0 + r;
        float qk = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < L::EPT; ++e) {
          const int d = sub + L::TPR * e;
          qk = fmaf(kr[e], Qs[r][d], qk);
          dp = fmaf(vr[e], Ds[r][d], dp);
        }
        qk = group_sum<L::TPR>(qk);
        dp = group_sum<L::TPR>(dp);
        const bool vis = live && (!causal || t <= s);
        const float p = vis ? expf(qk * scale - Ls[r]) : 0.f;
        const float ds = p * (dp - Dd[r]);
#pragma unroll
        for (int e = 0; e < L::EPT; ++e) {
          const int d = sub + L::TPR * e;
          dva[e] = fmaf(p, Ds[r][d], dva[e]);
          dka[e] = fmaf(ds, Qs[r][d], dka[e]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < L::EPT; ++e) {
    const int d = sub + L::TPR * e;
    dk[row + d] = dka[e] * scale;
    dv[row + d] = dva[e];
  }
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, void* dq, void* dk, void* dv, float* dsum, int B, int S,
               int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  using L = BwdLayout<HD>;
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *gp = static_cast<const float*>(dout);
  const dim3 gq((S + L::RPB - 1) / L::RPB, Hq, B);
  flash_bwd_dq_kernel<HD><<<gq, kBwdThreads, 0, stream>>>(
      qp, kp, vp, static_cast<const float*>(o), lse, gp, static_cast<float*>(dq), dsum, S, Tk,
      Hq, Hkv, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gk((Tk + L::RPB - 1) / L::RPB, Hkv, B);
  flash_bwd_dkdv_kernel<HD><<<gk, kBwdThreads, 0, stream>>>(
      qp, kp, vp, lse, gp, dsum, static_cast<float*>(dk), static_cast<float*>(dv), S, Tk, Hq,
      Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------- backward, bf16, Hopper: wgmma and TMA
// The bf16 backward (the training path), at every head dim: a preprocess
// kernel and two kernels of two warpgroups each, in the scalar pair's roles.
//   flash_bwd_prep_kernel: D = rowsum(dO o) by 16-byte loads (8 or 16 lanes
//     a row, a shuffle tree) and the row LSE times log2 e, into the scratch
//     (B, Hq, 2, S_pad) f32, S_pad = S rounded up to 128 (zeros past S), so
//     that each 64-row slice is one aligned 256-byte bulk copy.
//   flash_bwd_dq_wgmma_kernel: one block per 128 queries of one query head,
//     the last query tiles first (under causality they see the most keys).
//   flash_bwd_dkdv_wgmma_kernel: one block per 128 keys of one kv head,
//     walking the group's query heads and the query tiles that see its keys;
//     key blocks are handed out in the order 0, 1, ... (block index / (Hkv B)),
//     so under causality the heaviest blocks (the first keys, which every
//     later query sees) start first and the grid's tail holds the lightest.
// Each block is two warpgroups, each owning 64 rows: queries in dq, keys in
// dk/dv.  The block's other operand streams through a ring of 3 stages in
// shared memory, loaded by TMA (4-d tensor maps over (hd, heads, rows,
// batch), 64 x 64 boxes, 128-byte swizzle, zeros past S, Tk and hd) and, in
// dk/dv, cp.async.bulk (the 64 L and D values of a query tile), each stage
// with an mbarrier that the bytes complete.  Thread 0 issues the fixed
// operands and the first 3 tiles; after that the last of the 8 warps to leave
// a stage refills it (last_out below), so the next tiles land while this one
// is multiplied and no warp waits for a stage it does not read.  There is no
// producer warp: a block of 8 warps keeps 2 a scheduler, so ptxas may give a
// thread up to 255 registers (a third warpgroup caps it at 168, where ptxas
// serialised dk/dv's products at hd 128 and spilled: dK and dV alone take
// 128 floats a thread there).  Per tile, a warpgroup runs on
// wgmma.mma_async.m64nNk16 (bf16 in, f32 accumulate):
//   dq:    S = Q K^T and dP = dO V^T (both operands from shared memory,
//          K-major), P = exp2(S scale log2 e - L), dS = P (dP - D) in f32,
//          then dQ += dS K with dS in registers as the A operand, split
//          into two bf16 halves (hi = bf16(dS), lo = bf16(dS - hi): dS's
//          rows sum to 0, so dQ cancels most of its terms and one rounding
//          of dS left up to 1.04e-2 of |dQ|), and K read MN-major
//          (transposed) from the same tile;
//   dk/dv: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//          dK += dS^T Q, P^T and dS^T in registers, dO and Q MN-major.
// That is 7 products a visible (query, key) pair (8 with dQ's second half),
// where the function needs
// 5: S and dP are formed in both kernels, the price of summing every output
// in one kernel with no atomic accumulation.  The accumulator fragment of an
// m64n64 product is, packed to bf16, the A fragment of the next product's
// k-steps (8 floats per 16 columns), so P and dS never touch shared memory
// (and no generic write is read by wgmma or TMA).  Operand tiles are 64-row
// slabs of 64 columns (128 bytes a row, 8 KB, 1024-byte aligned): K-major
// descriptors step 32 bytes a k-step inside a slab and a slab at a time past
// it; MN-major ones read 16 rows (2 KB) a k-step with the next 64 columns a
// slab (8 KB) away.  A head dim is padded to whole slabs in shared memory by
// the maps' zero fill (16 and 32 to 64, 112 to 128): the score products run
// hd / 16 k-steps and skip the zero ones, while dQ, dK and dV run at N = 64
// or 128 (their padded columns zero, never stored): at hd 112, 8/7 of those
// three products' work.  The score products of a tile commit as two groups,
// so P is formed while dP is still in flight.  Rows past S or Tk load zeros
// and are masked to P = 0 and never stored; a warpgroup skips a tile that
// causality hides from all its rows, but waits for it and counts itself out
// of its stage.  Every output element is summed by one thread in a fixed
// order: two launches give the same bits.  Rounding P and dS to bf16 costs
// accuracy, held to 1e-2 relative max-abs of the f32 plain backward, as the
// forward is (0.0043-0.0073 with the mma.sync kernels this design replaced;
// the scalar kernels on the same inputs: 0.0009-0.0027).
//
// Measured (chip_smoke.py phases 15 (d) and 17 (d), H100 80GB HBM3 at 700 W,
// device ms a call, in turns with the mma.sync.m16n8k16 pair it replaced):
//   (8, 2048, 9, 3, 64), smollm-135m: 0.3986 (the mma.sync pair 0.7700;
//     SDPA's backward 0.3390), dk/dv 7.090 ms of a 137.6 ms training step;
//   (8, 2048, 32, 32, 112), zamba2-7b: 2.2796 (3.7703; SDPA 1.6339);
//   (8, 2048, 48, 8, 128), dbrx-132b: 3.2627 (5.9022; SDPA 2.5203);
// 1.65-1.93x faster, still 1.18-1.40x SDPA's.  The function's seven
// products a pair at 989 TFLOP/s take 0.137 / 0.852 / 1.460 ms, so the
// kernels run at 34-45% of the tensor cores' peak.  The likely limits, by
// arithmetic and not yet measured apart: the score products read both
// operands from shared memory (an m64n64k16 reads 4 KB in the 32 cycles it
// takes at peak, all of an SM's 128 bytes a cycle), and a warpgroup's exps,
// masks and packing between its products are covered only by the other
// warpgroup's products.  ptxas (phase 2): dq 122 / 124 / 124 / 155 / 155
// registers at hd 16 / 32 / 64 / 112 / 128, dk/dv 183 / 183 / 183 / 234 /
// 234, the preprocess 32, no spills.
constexpr int kWgThreads = 128;           // one warpgroup
constexpr int kWgBlock = 2 * kWgThreads;  // two warpgroups: 2 warps a scheduler
constexpr int kSlabBytes = 64 * 128;      // 64 rows of one 128-byte swizzled slab
constexpr int kStages = 3;                // the ring of streamed tiles

template <int HD> struct WgBwd {
  static constexpr int SLABS = (HD + 63) / 64;     // slabs of 64 columns
  static constexpr int HDP = 64 * SLABS;           // the head dim padded to them
  static constexpr int KSTEPS = HD / 16;           // k-steps of the score products
  static constexpr int TILE = SLABS * kSlabBytes;  // bytes of one 64-row tile
  static constexpr int BARS = 64;                  // bytes of mbarriers and counters
  // dk/dv: K and V of the block's 128 keys; a stage: a Q and a dO tile, 64 L and 64 D
  static constexpr int DKDV_SMEM = 4 * TILE + kStages * (2 * TILE + 512) + BARS + 1024;
  // dq: Q and dO of the block's 128 queries; a stage: a K and a V tile
  static constexpr int DQ_SMEM = 4 * TILE + kStages * 2 * TILE + BARS + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// A stage is refilled by the last of the 8 warps to leave it.  Once all its
// lanes are done with the stage (__syncwarp at the call), a warp's lane 0
// counts it out on the stage's counter (8 a round, never reset) by an
// acquire-release add, so the lane that completes the round has acquired
// every warp's reads of the stage; it then orders them before its TMA writes
// (fence.proxy.async) and issues the tile kStages further on.  The counter
// only elects the refilling warp: no result is summed by an atomic.  Nothing
// waits for a later tile's stage, and a stage's loads start the moment its
// last reader is done.
__device__ __forceinline__ bool last_out(unsigned* count) {
  unsigned before;
  asm volatile("atom.acq_rel.cta.shared.add.u32 %0, [%1], 1;\n"
               : "=r"(before)
               : "r"(smem_addr(count))
               : "memory");
  if (before % 8 != 7) return false;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  return true;
}

// a 64 x 64 box of a 4-d map at (column, head, row, batch), onto bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) onto bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory
// (offsets in bytes): K-major lbo 16, sbo 1024 (8 rows of 128 bytes);
// MN-major lbo 8192 (the next 64 columns), sbo 1024
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// descriptor units (16 bytes) from a K-major tile's start to k-step kk
__device__ __forceinline__ uint64_t kmajor_step(int kk) {
  return (uint64_t)((kk / 4) * (kSlabBytes >> 4) + (kk % 4) * 2);
}
constexpr uint64_t kMnStep = 16 * 128 >> 4;  // MN-major: 16 rows a k-step
// d, opaque to the optimiser: a value laundered at its use is not hoisted
// out of the tile loop or into a product's window, where it would hold
// registers through the softmax (without it ptxas gives dq more registers
// a thread, and at hd 64, where two blocks share an SM at 128, it ran
// markedly slower)
__device__ __forceinline__ uint64_t fresh(uint64_t d) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(d));
  return d;
}
__device__ __forceinline__ int fresh(int x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers an async
// product owns across this point
template <int R> __device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_ACC8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_REGS32                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64                                                                     \
  WG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
            "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
            "%61, %62, %63"

// d (64 x 64 f32) = [d +] a b: a 64 x 16 and b 16 x 64, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x N f32) += a b: a 64 x 16 bf16 in registers, b 16 x N MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32), WG_ACC8(40),
        WG_ACC8(48), WG_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef WG_ACC8
#undef WG_REGS32
#undef WG_REGS64

// 2^x by the SFU (ex2.approx.ftz: 2 ulp, subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// an m64n64 accumulator (f32) as the A fragments of 4 k-steps (bf16): k-step
// kk holds columns 16 kk .. 16 kk + 15, which are accumulator floats 8 kk ..
// 8 kk + 7 in the order the A fragment takes them
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// the same as two bf16 operands that sum to the f32 value to 16 bits of
// mantissa: hi = bf16(d), lo = bf16(d - hi)
__device__ __forceinline__ void to_a_frags_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                                 const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = d[8 * kk + 2 * i], y = d[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      hi[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][i] = pack_bf16(x - __low2float(h), y - __high2float(h));
    }
}

template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ ld, int B, int S,
                      int S_pad, int Hq) {
  constexpr int CH = HD / 8;              // 16-byte chunks of a row
  constexpr int LPR = CH <= 8 ? 8 : 16;   // lanes a row
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = gid / LPR;        // over (b, s < S_pad, h)
  const int sub = (int)(gid % LPR);
  const bool live = row < (long long)B * S_pad * Hq;
  const int h = (int)(row % Hq), s = (int)(row / Hq % S_pad), b = (int)(row / Hq / S_pad);
  float dd = 0.f;
  if (live && s < S && sub < CH) {
    const size_t off = (((size_t)b * S + s) * Hq + h) * HD + sub * 8;
    float x[8], y[8];
    model::load16(dout + off, x);
    model::load16(o + off, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) dd = fmaf(x[i], y[i], dd);
  }
#pragma unroll
  for (int m = 1; m < LPR; m <<= 1) dd += __shfl_xor_sync(0xffffffffu, dd, m);
  if (live && sub == 0) {
    float* base = ld + ((size_t)b * Hq + h) * 2 * S_pad;
    base[s] = s < S ? lse[((size_t)b * Hq + h) * S + s] * 1.4426950408889634f : 0.f;
    base[S_pad + s] = s < S ? dd : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgBlock, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg, const float* __restrict__ ld,
                          bf16* __restrict__ dq, int B, int S, int S_pad, int Tk, int Hq, int Hkv,
                          int causal, float scale_log2, float scale) {
  using W = WgBwd<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);   // 2 tiles: the block's 128 queries
  unsigned char* Gs = Qs + 2 * W::TILE;      // 2 tiles: their dO rows
  unsigned char* Ks = Gs + 2 * W::TILE;      // a key tile a stage
  unsigned char* Vs = Ks + kStages * W::TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * W::TILE);
  uint64_t* full = q_full + 1;
  unsigned* out = reinterpret_cast<unsigned*>(full + kStages);  // warps out of each stage

  const int n_qb = (S + 127) / 128;
  const int qb = n_qb - 1 - (int)(blockIdx.x / (Hq * B));  // heaviest first
  const int b = blockIdx.x % (Hq * B) / Hq, h = blockIdx.x % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qb * 128;
  const int kv_end = causal ? min(Tk, min(S, q0 + 128)) : Tk;
  const int n_kt = (kv_end + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      out[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::
                     : "memory");
  }
  __syncthreads();

  // key tile it into its free stage
  auto load = [&](int it) {
    const int st = it % kStages;
    mbar_expect_tx(full + st, 2 * W::TILE);
    for (int sl = 0; sl < W::SLABS; ++sl) {
      tma_load(Ks + st * W::TILE + sl * kSlabBytes, &tk, full + st, 64 * sl, kvh, 64 * it, b);
      tma_load(Vs + st * W::TILE + sl * kSlabBytes, &tv, full + st, 64 * sl, kvh, 64 * it, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 4 * W::TILE);
    for (int g = 0; g < 2; ++g)
      for (int sl = 0; sl < W::SLABS; ++sl) {
        tma_load(Qs + g * W::TILE + sl * kSlabBytes, &tq, q_full, 64 * sl, h, q0 + 64 * g, b);
        tma_load(Gs + g * W::TILE + sl * kSlabBytes, &tg, q_full, 64 * sl, h, q0 + 64 * g, b);
      }
    for (int it = 0; it < min(kStages, n_kt); ++it) load(it);
  }

  const int c = threadIdx.x / kWgThreads;  // the consumer: rows q0 + 64 c ..
  const int tid = threadIdx.x % kWgThreads, lane = tid % 32;
  const int wq0 = q0 + 64 * c;
  const int r_lo = wq0 + 16 * (tid / 32) + lane / 4;  // this thread's rows: r_lo, r_lo + 8
  const float* lrow = ld + ((size_t)b * Hq + h) * 2 * S_pad;  // rows < S_pad (a multiple of 128)
  const float lr[2] = {lrow[r_lo], lrow[r_lo + 8]};
  const float dr[2] = {lrow[S_pad + r_lo], lrow[S_pad + r_lo + 8]};
  const uint64_t qd = sw128_desc(Qs + c * W::TILE, 16, 1024);
  const uint64_t gd = sw128_desc(Gs + c * W::TILE, 16, 1024);

  float acc[W::HDP / 2];
#pragma unroll
  for (int i = 0; i < W::HDP / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages, k0 = 64 * it;
    mbar_wait(full + st, (it / kStages) & 1);
    if (!(wq0 >= S || (causal && k0 > wq0 + 63))) {
      const uint64_t kd = fresh(sw128_desc(Ks + st * W::TILE, 16, 1024));
      const uint64_t vd = fresh(sw128_desc(Vs + st * W::TILE, 16, 1024));
      const uint64_t q_d = fresh(qd), g_d = fresh(gd);
      // S and dP: a tile's first k-step overwrites them, so they carry
      // nothing from the last tile and hold no registers through dQ's product
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < W::KSTEPS; ++kk)
        wgmma_ss(sc, q_d + kmajor_step(kk), kd + kmajor_step(kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < W::KSTEPS; ++kk)
        wgmma_ss(dp, g_d + kmajor_step(kk), vd + kmajor_step(kk), kk > 0);
      wg_commit();
      wg_wait<1>();
      pin(sc);
      const bool masked = k0 + 64 > Tk || (causal && k0 + 63 > wq0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float p = ex2(fmaf(sc[i], scale_log2, -lr[(i >> 1) & 1]));
        if (masked) {
          const int t = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
          if (t >= Tk || (causal && t > r_lo + 8 * ((i >> 1) & 1))) p = 0.f;
        }
        sc[i] = p;
      }
      wg_wait<0>();
      pin(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dr[(i >> 1) & 1]);
      // dS as hi + lo: each row of dS sums to 0, so dQ = dS K cancels most
      // of its terms, and dS rounded once to bf16 left up to 1.04e-2 of
      // |dQ| (qwen2-1.5b's training step); the second product takes it to
      // the output's own rounding
      uint32_t da[4][4], dl[4][4];
      to_a_frags_split(da, dl, dp);
      pin(acc);
      wg_fence();
      const uint64_t kt = fresh(sw128_desc(Ks + st * W::TILE, kSlabBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, da[kk], kt + kk * kMnStep);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, dl[kk], kt + kk * kMnStep);
      wg_commit();
      wg_wait<0>();
      pin(acc);
      pin(da);
      pin(dl);
    }
    __syncwarp();
    if (lane == 0 && last_out(out + st) && it + kStages < n_kt) load(it + kStages);
  }

  // dq = scale * acc, each thread's two rows straight from its registers
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = r_lo + 8 * r;
    if (s >= S) continue;
    bf16* row = dq + (((size_t)b * S + s) * Hq + h) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgBlock, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tg, const float* __restrict__ ld,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S, int S_pad,
                            int Tk, int Hq, int Hkv, int causal, float scale_log2, float scale) {
  using W = WgBwd<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);  // 2 tiles: the block's 128 keys
  unsigned char* Vs = Ks + 2 * W::TILE;     // 2 tiles: their values
  unsigned char* Qs = Vs + 2 * W::TILE;     // a query tile a stage
  unsigned char* Gs = Qs + kStages * W::TILE;  // its dO rows
  float* Ls = reinterpret_cast<float*>(Gs + kStages * W::TILE);  // 64 lse * log2 e a stage
  float* Ds = Ls + 64 * kStages;                                 // 64 rowsum(dO o) a stage
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + 64 * kStages);
  uint64_t* full = kv_full + 1;
  unsigned* out = reinterpret_cast<unsigned*>(full + kStages);  // warps out of each stage

  const int kb = blockIdx.x / (Hkv * B);  // the first key blocks first: the heaviest
  const int b = blockIdx.x % (Hkv * B) / Hkv, kvh = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int t0 = kb * 128;
  const int q_begin = causal ? t0 : 0;  // earlier queries see none of the block's keys
  const int n_qt = q_begin < S ? (S - q_begin + 63) / 64 : 0;
  const int n_it = group * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      out[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::
                     : "memory");
  }
  __syncthreads();

  // query tile it into its free stage
  auto load = [&](int it) {
    const int st = it % kStages, i = it % n_it;
    const int h = kvh * group + i / n_qt, s0 = q_begin + i % n_qt * 64;
    mbar_expect_tx(full + st, 2 * W::TILE + 512);
    for (int sl = 0; sl < W::SLABS; ++sl) {
      tma_load(Qs + st * W::TILE + sl * kSlabBytes, &tq, full + st, 64 * sl, h, s0, b);
      tma_load(Gs + st * W::TILE + sl * kSlabBytes, &tg, full + st, 64 * sl, h, s0, b);
    }
    const float* src = ld + ((size_t)b * Hq + h) * 2 * S_pad + s0;
    bulk_load(Ls + 64 * st, src, 256, full + st);
    bulk_load(Ds + 64 * st, src + S_pad, 256, full + st);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 4 * W::TILE);
    for (int g = 0; g < 2; ++g)
      for (int sl = 0; sl < W::SLABS; ++sl) {
        tma_load(Ks + g * W::TILE + sl * kSlabBytes, &tk, kv_full, 64 * sl, kvh, t0 + 64 * g, b);
        tma_load(Vs + g * W::TILE + sl * kSlabBytes, &tv, kv_full, 64 * sl, kvh, t0 + 64 * g, b);
      }
    for (int it = 0; it < min(kStages, n_it); ++it) load(it);
  }

  const int c = threadIdx.x / kWgThreads;  // the consumer: keys t0 + 64 c ..
  const int tid = threadIdx.x % kWgThreads, lane = tid % 32;
  const int wt0 = t0 + 64 * c;
  const int t_lo = wt0 + 16 * (tid / 32) + lane / 4;  // this thread's keys: t_lo, t_lo + 8
  const uint64_t kd = sw128_desc(Ks + c * W::TILE, 16, 1024);
  const uint64_t vd = sw128_desc(Vs + c * W::TILE, 16, 1024);

  float dka[W::HDP / 2], dva[W::HDP / 2];
#pragma unroll
  for (int i = 0; i < W::HDP / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, s0 = q_begin + it % n_qt * 64;
    mbar_wait(full + st, (it / kStages) & 1);
    if (!(wt0 >= Tk || (causal && s0 + 63 < wt0))) {
      unsigned char* Qt = Qs + st * W::TILE;
      unsigned char* Gt = Gs + st * W::TILE;
      const uint64_t qd = fresh(sw128_desc(Qt, 16, 1024)), gd = fresh(sw128_desc(Gt, 16, 1024));
      const uint64_t k_d = fresh(kd), v_d = fresh(vd);
      float sc[32], dp[32];  // S^T and dP^T: written by the first k-step, as in dq
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < W::KSTEPS; ++kk)
        wgmma_ss(sc, k_d + kmajor_step(kk), qd + kmajor_step(kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < W::KSTEPS; ++kk)
        wgmma_ss(dp, v_d + kmajor_step(kk), gd + kmajor_step(kk), kk > 0);
      wg_commit();
      wg_wait<1>();
      pin(sc);
      // P^T: rows are keys (t_lo, t_lo + 8), columns queries s0 + col + 8 j
      // + e.  The column is laundered here, so that neither the L and D
      // loads nor the masks are hoisted into the products' window
      const int col = fresh(2 * (lane & 3));
      const float* L = Ls + 64 * st + col;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
      }
      if (s0 + 64 > S || wt0 + 64 > Tk || (causal && s0 < wt0 + 63)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int s = s0 + col + 8 * (e / 4) + (e & 1), t = t_lo + 8 * ((e >> 1) & 1);
          if (s >= S || t >= Tk || (causal && t > s)) sc[e] = 0.f;
        }
      }
      wg_wait<0>();
      pin(dp);
      const float* D = Ds + 64 * st + fresh(col);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(D + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t pa[4][4], da[4][4];
      to_a_frags(pa, sc);
      to_a_frags(da, dp);
      pin(dva);
      pin(dka);
      wg_fence();
      const uint64_t gt = fresh(sw128_desc(Gt, kSlabBytes, 1024));
      const uint64_t qt = fresh(sw128_desc(Qt, kSlabBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dva, pa[kk], gt + kk * kMnStep);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dka, da[kk], qt + kk * kMnStep);
      wg_commit();
      wg_wait<0>();
      pin(dva);
      pin(dka);
      pin(pa);
      pin(da);
    }
    __syncwarp();
    if (lane == 0 && last_out(out + st) && it + kStages < n_it) load(it + kStages);
  }

  // dk = scale * dka and dv, each thread's two keys straight from its registers
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t_lo + 8 * r;
    if (t >= Tk) continue;
    const size_t off = (((size_t)b * Tk + t) * Hkv + kvh) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// cuTensorMapEncodeTiled, resolved through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// the 4-d map of a (B, rows, H, HD) bf16 tensor: 64 x 64 boxes of one head,
// 128-byte swizzle, zeros out of bounds
bool bwd_map(CUtensorMap* map, const void* base, int B, int rows, int H, int HD) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)H * HD * 2,
                                 (cuuint64_t)rows * H * HD * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o, const float* lse,
                     const void* dout, void* dq, void* dk, void* dv, float* ld, int B, int S,
                     int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  using W = WgBwd<HD>;
  // TMA takes 16-byte aligned bases; the other kernels store 4-byte pairs
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)ld) % 16)
    return (int)cudaErrorMisalignedAddress;
  static const cudaError_t ready_dq = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::DQ_SMEM);
  static const cudaError_t ready_dkdv = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::DKDV_SMEM);
  if (ready_dq != cudaSuccess) return (int)ready_dq;
  if (ready_dkdv != cudaSuccess) return (int)ready_dkdv;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, tg;
  if (!bwd_map(&tq, q, B, S, Hq, HD) || !bwd_map(&tk, k, B, Tk, Hkv, HD) ||
      !bwd_map(&tv, v, B, Tk, Hkv, HD) || !bwd_map(&tg, dout, B, S, Hq, HD))
    return (int)cudaErrorInvalidValue;
  const int S_pad = (S + 127) / 128 * 128;
  const float scale_log2 = scale * 1.4426950408889634f;
  constexpr int LPR = HD / 8 <= 8 ? 8 : 16;
  const long long threads = (long long)B * S_pad * Hq * LPR;
  flash_bwd_prep_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, ld, B, S, S_pad, Hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_wgmma_kernel<HD><<<(unsigned)(S_pad / 128 * Hq * B), kWgBlock, W::DQ_SMEM,
                                  stream>>>(tq, tk, tv, tg, ld, static_cast<bf16*>(dq), B, S,
                                            S_pad, Tk, Hq, Hkv, causal, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_wgmma_kernel<HD><<<(unsigned)((Tk + 127) / 128 * Hkv * B), kWgBlock,
                                    W::DKDV_SMEM, stream>>>(
      tq, tk, tv, tg, ld, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, S_pad, Tk, Hq,
      Hkv, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,Hq,HD), k/v (B,Tk,Hkv,HD), out (B,S,Hq,HD); one dtype for all four;
// bf16 pointers 16-byte aligned; lse (B,Hq,S) f32, or null to write none
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int B, int S, int Tk, int Hq, int Hkv, int HD,
                                   int causal, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, out, lse, B, S, Tk, Hq, Hkv, causal, scale, s
  switch (HD) {
    case 16: return is_bf16 ? launch_mma<16>(FLASH_ARGS) : launch_scalar<16>(FLASH_ARGS);
    case 32: return is_bf16 ? launch_mma<32>(FLASH_ARGS) : launch_scalar<32>(FLASH_ARGS);
    case 64: return is_bf16 ? launch_mma<64>(FLASH_ARGS) : launch_scalar<64>(FLASH_ARGS);
    case 112: return is_bf16 ? launch_mma<112>(FLASH_ARGS) : launch_scalar<112>(FLASH_ARGS);
    case 128: return is_bf16 ? launch_mma<128>(FLASH_ARGS) : launch_scalar<128>(FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

// The backward: q, o, dout, dq (B,S,Hq,HD), k, v, dk, dv (B,Tk,Hkv,HD) in one
// dtype; lse (B,Hq,S) f32; dsum the f32 scratch: for bf16 (B,Hq,2,S_pad),
// S_pad = S rounded up to 128 (three launches: the preprocess, dq, dk/dv),
// for f32 (B,Hq,S) (two launches: dq, which writes it, then dk/dv).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const float* lse, const void* dout, void* dq, void* dk,
                                   void* dv, float* dsum, int B, int S, int Tk, int Hq,
                                   int Hkv, int HD, int causal, float scale, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, o, lse, dout, dq, dk, dv, dsum, B, S, Tk, Hq, Hkv, causal, scale, st
  switch (HD) {
    case 16: return is_bf16 ? launch_bwd_wgmma<16>(BWD_ARGS) : launch_bwd<16>(BWD_ARGS);
    case 32: return is_bf16 ? launch_bwd_wgmma<32>(BWD_ARGS) : launch_bwd<32>(BWD_ARGS);
    case 64: return is_bf16 ? launch_bwd_wgmma<64>(BWD_ARGS) : launch_bwd<64>(BWD_ARGS);
    case 112: return is_bf16 ? launch_bwd_wgmma<112>(BWD_ARGS) : launch_bwd<112>(BWD_ARGS);
    case 128: return is_bf16 ? launch_bwd_wgmma<128>(BWD_ARGS) : launch_bwd<128>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_ARGS
}

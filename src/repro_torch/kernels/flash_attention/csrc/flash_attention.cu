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

// ------------------------------------------------ backward, bf16, tensor cores
// The bf16 backward (the training path) on mma.sync.m16n8k16 with the
// forward's fragment layouts, in the same two kernels' roles.  Tiles of 64
// rows, 4 warps of 16 rows each; every operand is staged in shared memory by
// cp.async (16-byte rows padded to HD + 8 bf16: no ldmatrix bank conflicts),
// single-buffered.  P and dS are formed in f32 from the f32 accumulators,
// then rounded to bf16 as the A operand of the next product (as the forward
// rounds P for P V), so the products stay on the tensor cores:
//   dq kernel, per warp of 16 queries and per key tile:
//     S = Q K^T, dP = dO V^T (B: K, V rows), dS = P (dP - D), dQ += dS K
//     (B: K rows by ldmatrix.trans); D = rowsum(dO o) of the block's rows
//     is written to the scratch buffer for the dk/dv kernel;
//   dk/dv kernel, per warp of 16 keys and per query tile of each head of
//     the group: S^T = K Q^T, dP^T = V dO^T (B: Q, dO rows), dV += P^T dO,
//     dK += dS^T Q (B: dO, Q rows by ldmatrix.trans).
// Sums of the products run in a fixed order (no atomics): deterministic.
// Rounding P and dS to bf16 costs accuracy: within 0.0043-0.0073 relative
// max-abs of the f32 plain backward on bf16 inputs (the scalar kernels on the
// same inputs: 0.0009-0.0027), held to 1e-2 as the forward is.
//
// What bounds it: at smollm's training shape (8, 2048, 9, 3, 64) the five
// products of the backward are 96.7 GFLOP (0.098 ms at 989 TFLOP/s) against
// 101 MB of inputs and outputs (0.030 ms), so the products.  Measured
// (chip_smoke.py phase 15, H100 80GB HBM3 at 700 W): 0.7755 ms of device
// (dk/dv 0.441, dq 0.336), 7.9x the bound and 2.3x SDPA's backward (0.3395);
// the scalar kernels took 9.30 ms.  Registers: 164-168 for the dq kernel,
// 165 for dk/dv at hd 64 and 248-254 at hd 112 and 128 (no spills): 3
// blocks an SM at hd 64, 2 at hd 112 and 128; 37 KB of shared memory at hd 64.
constexpr int kTile = 64;  // rows of every shared tile

template <int HD> constexpr int bwd_mma_smem_bytes() {
  return 4 * kTile * (HD + 8) * (int)sizeof(bf16) + 2 * kTile * (int)sizeof(float);
}

// 64 rows of a (rows, H, HD) bf16 tensor at head h, from row r0 (zeros past
// n), into a shared tile, by cp.async
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b, int r0, int n,
                                          int H, int h) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int c = threadIdx.x; c < kTile * CH; c += 32 * kPosWarps) {
    const int r = c / CH, ch = c % CH, t = r0 + r;
    const bf16* g = src + (((size_t)b * n + min(t, n - 1)) * H + h) * HD + ch * 8;
    cp_async16(dst + r * LD + ch * 8, g, t < n ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * kPosWarps)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const float* __restrict__ lse, const bf16* __restrict__ dout,
                        bf16* __restrict__ dq, float* __restrict__ dsum, int S, int Tk, int Hq,
                        int Hkv, int causal, float scale_log2, float scale) {
  constexpr int LD = HD + 8, CH = HD / 8, KS = HD / 16, DB = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [64][LD] the block's queries
  bf16* Gs = Qs + kTile * LD;                // [64][LD] their dO rows
  bf16* Ks = Gs + kTile * LD;                // [64][LD] one key tile
  bf16* Vs = Ks + kTile * LD;                // [64][LD]
  float* Ls = reinterpret_cast<float*>(Vs + kTile * LD);  // lse * log2 e
  float* Dd = Ls + kTile;                                 // rowsum(dO o)
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int lane = threadIdx.x % 32, p0 = 16 * (threadIdx.x / 32);

  load_tile<HD>(Qs, q, b, q0, S, Hq, h);
  load_tile<HD>(Gs, dout, b, q0, S, Hq, h);
  cp_async_commit();
  // D and the scaled lse of the warp's 16 rows
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + p0 + r;
    float dd = 0.f;
    if (s < S) {
      const size_t off = (((size_t)b * S + s) * Hq + h) * HD;
      for (int d = lane; d < HD; d += 32)
        dd = fmaf(__bfloat162float(dout[off + d]), __bfloat162float(o[off + d]), dd);
    }
#pragma unroll
    for (int x = 16; x; x >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, x);
    if (lane == 0) {
      const size_t srow = ((size_t)b * Hq + h) * S + s;
      Dd[p0 + r] = dd;
      Ls[p0 + r] = s < S ? lse[srow] * 1.4426950408889634f : 0.f;
      if (s < S) dsum[srow] = dd;
    }
  }
  __syncwarp();
  const int row_lo = q0 + p0 + lane / 4;  // this lane's rows: row_lo, row_lo + 8
  const float lrow[2] = {Ls[p0 + lane / 4], Ls[p0 + lane / 4 + 8]};
  const float drow[2] = {Dd[p0 + lane / 4], Dd[p0 + lane / 4 + 8]};

  float acc[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const int kv_end = causal ? min(Tk, min(S, q0 + kTile)) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(Ks, k, b, k0, Tk, Hkv, kvh);
    load_tile<HD>(Vs, v, b, k0, Tk, Hkv, kvh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], g[4];
      ldsm_x4(a, Qs + (p0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      ldsm_x4(g, Gs + (p0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Ks + off);
        ldsm_x4(vb, Vs + off);
        mma_bf16(sc[2 * np], a, kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], a, kb[2], kb[3]);
        mma_bf16(dp[2 * np], g, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], g, vb[2], vb[3]);
      }
    }
    const bool masked = k0 + kTile > Tk || (causal && k0 + kTile - 1 > q0 + p0);
    uint32_t da[4][4];  // dS as the A operand of key steps 0..3
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(sc[nb][e] * scale_log2 - lrow[r]);
        if (masked) {
          const int t = k0 + nb * 8 + (lane & 3) * 2 + (e & 1);
          if (t >= Tk || (causal && t > row_lo + 8 * r)) p = 0.f;
        }
        ds[e] = p * (dp[nb][e] - drow[r]);
      }
      da[nb / 2][(nb & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int dj = 0; dj < DB / 2; ++dj) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, Ks + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 +
                              (lane >> 4) * 8);
        mma_bf16(acc[2 * dj], da[ks], kb[0], kb[1]);
        mma_bf16(acc[2 * dj + 1], da[ks], kb[2], kb[3]);
      }
    }
  }

  // dq = scale * acc, staged through the warp's own Q rows, 16-byte stores
  __syncwarp();
  bf16* st = Qs + p0 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = st + (lane / 4 + 8 * r) * LD + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DB; ++d)
      *reinterpret_cast<uint32_t*>(row + d * 8) =
          pack_bf16(acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, s = q0 + p0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(dq + (((size_t)b * S + s) * Hq + h) * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(st + r * LD + ch * 8);
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * kPosWarps)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ lse,
                          const bf16* __restrict__ dout, const float* __restrict__ dsum,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Tk, int Hq,
                          int Hkv, int causal, float scale_log2, float scale) {
  constexpr int LD = HD + 8, CH = HD / 8, KS = HD / 16, DB = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [64][LD] the block's keys
  bf16* Vs = Ks + kTile * LD;                // [64][LD] their values
  bf16* Qs = Vs + kTile * LD;                // [64][LD] one query tile
  bf16* Gs = Qs + kTile * LD;                // [64][LD] its dO rows
  float* Ls = reinterpret_cast<float*>(Gs + kTile * LD);  // lse * log2 e
  float* Dd = Ls + kTile;                                 // rowsum(dO o)
  const int t0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int lane = threadIdx.x % 32, p0 = 16 * (threadIdx.x / 32);
  const int w0 = t0 + p0;  // the warp's first key
  const int t_lo = w0 + lane / 4;  // this lane's keys: t_lo, t_lo + 8

  load_tile<HD>(Ks, k, b, t0, Tk, Hkv, kvh);
  load_tile<HD>(Vs, v, b, t0, Tk, Hkv, kvh);
  cp_async_commit();
  float dka[DB][4], dva[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  // queries before the block's first key see none of its keys
  const int q_begin = causal ? t0 : 0;
  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    for (int s0 = q_begin; s0 < S; s0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<HD>(Qs, q, b, s0, S, Hq, h);
      load_tile<HD>(Gs, dout, b, s0, S, Hq, h);
      cp_async_commit();
      for (int i = threadIdx.x; i < kTile; i += 32 * kPosWarps) {
        const int s = s0 + i;
        const size_t srow = ((size_t)b * Hq + h) * S + s;
        Ls[i] = s < S ? lse[srow] * 1.4426950408889634f : 0.f;
        Dd[i] = s < S ? dsum[srow] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float st[8][4], dpt[8][4];  // S^T and dP^T: the warp's 16 keys x 64 queries
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4], w[4];
        ldsm_x4(a, Ks + (p0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
        ldsm_x4(w, Vs + (p0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t qb[4], gb[4];
          ldsm_x4(qb, Qs + off);
          ldsm_x4(gb, Gs + off);
          mma_bf16(st[2 * np], a, qb[0], qb[1]);
          mma_bf16(st[2 * np + 1], a, qb[2], qb[3]);
          mma_bf16(dpt[2 * np], w, gb[0], gb[1]);
          mma_bf16(dpt[2 * np + 1], w, gb[2], gb[3]);
        }
      }
      const bool masked = s0 + kTile > S || w0 + 16 > Tk || (causal && s0 < w0 + 16);
      uint32_t pa[4][4], da[4][4];  // P^T and dS^T as A operands of query steps 0..3
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + (lane & 3) * 2 + (e & 1);
          p[e] = exp2f(st[nb][e] * scale_log2 - Ls[col]);
          if (masked) {
            const int s = s0 + col, t = t_lo + (e >> 1) * 8;
            if (s >= S || t >= Tk || (causal && t > s)) p[e] = 0.f;
          }
          ds[e] = p[e] * (dpt[nb][e] - Dd[col]);
        }
        pa[nb / 2][(nb & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[nb / 2][(nb & 1) * 2] = pack_bf16(ds[0], ds[1]);
        da[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int dj = 0; dj < DB / 2; ++dj) {
          const int off = (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 +
                          (lane >> 4) * 8;
          uint32_t gb[4], qb[4];
          ldsm_x4_trans(gb, Gs + off);
          ldsm_x4_trans(qb, Qs + off);
          mma_bf16(dva[2 * dj], pa[ks], gb[0], gb[1]);
          mma_bf16(dva[2 * dj + 1], pa[ks], gb[2], gb[3]);
          mma_bf16(dka[2 * dj], da[ks], qb[0], qb[1]);
          mma_bf16(dka[2 * dj + 1], da[ks], qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the K/V copies, where no query tile ran
  __syncthreads();

  // dk = scale * dka and dv, staged through the warp's own K and V rows
  bf16* sk = Ks + p0 * LD;
  bf16* sv = Vs + p0 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ro = (lane / 4 + 8 * r) * LD + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      *reinterpret_cast<uint32_t*>(sk + ro + d * 8) =
          pack_bf16(dka[d][2 * r] * scale, dka[d][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(sv + ro + d * 8) = pack_bf16(dva[d][2 * r], dva[d][2 * r + 1]);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, t = w0 + r;
    if (t < Tk) {
      const size_t off = (((size_t)b * Tk + t) * Hkv + kvh) * HD + ch * 8;
      *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(sk + r * LD + ch * 8);
      *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(sv + r * LD + ch * 8);
    }
  }
}

template <int HD>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* dsum, int B, int S,
                   int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  // the kernels copy 16-byte rows
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16)
    return (int)cudaErrorMisalignedAddress;
  constexpr int smem = bwd_mma_smem_bytes<HD>();
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkdv != cudaSuccess) return (int)attr_dkdv;
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(dout);
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 gq((S + kTile - 1) / kTile, Hq, B);
  flash_bwd_dq_mma_kernel<HD><<<gq, 32 * kPosWarps, smem, stream>>>(
      qp, kp, vp, static_cast<const bf16*>(o), lse, gp, static_cast<bf16*>(dq), dsum, S, Tk,
      Hq, Hkv, causal, scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gk((Tk + kTile - 1) / kTile, Hkv, B);
  flash_bwd_dkdv_mma_kernel<HD><<<gk, 32 * kPosWarps, smem, stream>>>(
      qp, kp, vp, lse, gp, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Tk, Hq,
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
// dtype; lse and the scratch dsum (B,Hq,S) f32.  Two launches: dq (which
// writes dsum), then dk/dv.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const float* lse, const void* dout, void* dq, void* dk,
                                   void* dv, float* dsum, int B, int S, int Tk, int Hq,
                                   int Hkv, int HD, int causal, float scale, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, o, lse, dout, dq, dk, dv, dsum, B, S, Tk, Hq, Hkv, causal, scale, st
#define BWD_CASE(HD_)                                                            \
  case HD_:                                                                      \
    return is_bf16 ? launch_bwd_mma<HD_>(BWD_ARGS) : launch_bwd<HD_>(BWD_ARGS);
  switch (HD) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(112)
    BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
#undef BWD_ARGS
}

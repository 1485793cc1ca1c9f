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
                    const T* __restrict__ v, T* __restrict__ out, int S, int Tk, int Hq,
                    int Hkv, int causal, float scale) {
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
  T* op = out + (((size_t)b * S + qpos) * Hq + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) op[d] = model::from_f<T>(acc[d] * inv);
}

template <int HD>
int launch_scalar(const void* q, const void* k, const void* v, void* out, int B, int S,
                  int Tk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_scalar_kernel<float, HD><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Tk, Hq, Hkv, causal, scale);
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
                 const bf16* __restrict__ v, bf16* __restrict__ out, int B, int S, int Tk,
                 int Hq, int Hkv, int causal, float scale_log2) {
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
    const float inv = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
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
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
               int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
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
      static_cast<bf16*>(out), B, S, Tk, Hq, Hkv, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,Hq,HD), k/v (B,Tk,Hkv,HD), out (B,S,Hq,HD); one dtype for all four;
// bf16 pointers 16-byte aligned
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int Tk, int Hq, int Hkv, int HD,
                                   int causal, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, out, B, S, Tk, Hq, Hkv, causal, scale, s
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

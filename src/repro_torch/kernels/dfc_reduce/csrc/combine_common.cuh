// Building blocks shared by the hand-written combine kernels
// (dfc_reduce.cu: one phase per launch; phase_grid.cu: K phases per launch):
// the op codes, block-wide ranks, the broadcast copy of a state into its
// output rows, the lane tiles and phase steps that the three ring kinds
// share, and the map's cached lane walk.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_PUSH = 1, OP_POP = 2;              // stack; queue ENQ/DEQ
constexpr int OP_PUSHL = 1, OP_POPL = 2, OP_PUSHR = 3, OP_POPR = 4;
constexpr int OP_MAP_INSERT = 1, OP_MAP_LOOKUP = 2, OP_MAP_DELETE = 3, OP_MAP_CAS = 4;
constexpr int R_NONE = 0, R_ACK = 1, R_VALUE = 2, R_EMPTY = 3, R_FULL = 5, R_CAS_FAIL = 6;
constexpr float CAS_DOM = 4096.0f;
constexpr int kThreads = 1024;      // ring kinds: one block of 32 warps per shard
constexpr int kMapThreads = 1024;   // map: the whole block compacts, warp 0 walks
constexpr unsigned kFull = 0xffffffffu;

// Exclusive block-wide prefix sum of F per-thread counts, in thread order.
// ``sm`` holds F x 32 ints; every thread of the block must call it.
template <int F>
__device__ __forceinline__ void block_scan(const int (&v)[F], int (&excl)[F],
                                           int (&total)[F], int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int inc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    int x = v[f];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += t;
    }
    inc[f] = x;
  }
#pragma unroll
  for (int f = 0; f < F; ++f)
    if (lane == 31) sm[f * 32 + warp] = inc[f];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      int y = lane < nw ? sm[f * 32 + lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, y, o);
        if (lane >= o) y += t;
      }
      sm[f * 32 + lane] = y;  // inclusive prefix over the warps
    }
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < F; ++f) {
    excl[f] = inc[f] - v[f] + (warp ? sm[f * 32 + warp - 1] : 0);
    total[f] = sm[f * 32 + nw - 1];
  }
  __syncthreads();  // sm is reused by the next scan
}

__device__ __forceinline__ unsigned map_bucket(int key, unsigned n_buckets) {
  unsigned h = (unsigned)key * 2654435761u;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  return h % n_buckets;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------- broadcast copy
// Up to three leaves of 4-byte elements, ``n`` each: src[l] is read once and
// each of its 16-byte vectors is stored into the K rows dst[l] + r * n.  A
// grid over every SM (blockIdx.y picks the leaf); streaming loads and stores
// (ld/st.global.cs), since nothing reads the rows back soon.
constexpr int kCopyThreads = 512;
constexpr int kCopyUnroll = 4;  // vectors in flight per thread

struct Leaves {
  const void* src[3];
  void* dst[3];
};

__global__ void __launch_bounds__(kCopyThreads)
broadcast_kernel(Leaves lv, size_t n, int K) {
  const int l = blockIdx.y;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((n & 3) == 0 && aligned16(lv.src[l]) && aligned16(lv.dst[l])) {
    const int4* s = static_cast<const int4*>(lv.src[l]);
    int4* d = static_cast<int4*>(lv.dst[l]);
    const size_t n4 = n >> 2;
    size_t i = t0;
    for (; i + (kCopyUnroll - 1) * stride < n4; i += kCopyUnroll * stride) {
      int4 v[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) v[u] = __ldcs(s + i + u * stride);
      for (int r = 0; r < K; ++r) {
#pragma unroll
        for (int u = 0; u < kCopyUnroll; ++u) __stcs(d + r * n4 + i + u * stride, v[u]);
      }
    }
    for (; i < n4; i += stride) {
      const int4 v = __ldcs(s + i);
      for (int r = 0; r < K; ++r) __stcs(d + r * n4 + i, v);
    }
  } else {
    const int* s = static_cast<const int*>(lv.src[l]);
    int* d = static_cast<int*>(lv.dst[l]);
    for (size_t i = t0; i < n; i += stride) {
      const int v = s[i];
      for (int r = 0; r < K; ++r) d[r * n + i] = v;
    }
  }
}

// Launch the broadcast of ``n_leaves`` leaves on ``stream``: a few blocks per
// SM, no more than the vectors need.
inline int launch_broadcast(const Leaves& lv, int n_leaves, size_t n, int K,
                            cudaStream_t stream) {
  if (n == 0 || K == 0) return 0;
  int dev = 0, sms = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return err;
  const size_t per_block = (size_t)kCopyThreads * kCopyUnroll;
  const size_t want = ((n + 3) / 4 + per_block - 1) / per_block;
  const int blocks = (int)(want < (size_t)sms * 4 ? want : (size_t)sms * 4);
  broadcast_kernel<<<dim3(blocks, n_leaves), kCopyThreads, 0, stream>>>(lv, n, K);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ lane tiles
// A phase holds its lanes in registers, a tile of kTile (16,384) lanes at a
// time: thread t owns quad t of each of kQ sub-tiles of 4 x blockDim lanes,
// so every 16-byte load and store of a warp is contiguous, and one
// block-wide scan of per-thread, per-sub-tile counts ranks every lane of
// the tile in lane order.
constexpr int kQ = 4;
constexpr int kV = 4 * kQ;  // lanes per thread per tile
constexpr int kTile = kThreads * kV;

// The first lane of this thread's quad q of tile ``tile``.
__device__ __forceinline__ int quad_lo(int tile, int q) {
  return tile * kTile + (q * blockDim.x + threadIdx.x) * 4;
}

// Whether the quads q of tile ``tile`` of this thread's whole warp lie past
// the row's N lanes (the same in every thread of the warp).
__device__ __forceinline__ bool warp_past(int tile, int q, int N) {
  return tile * kTile + (q * blockDim.x + (threadIdx.x & ~31)) * 4 >= N;
}

// The ring kinds' tile: op codes as bytes (codes above 5 and negative codes
// read as 5: live, no ring op; lanes past the row's end as 0) and params.
struct LaneTile {
  unsigned op[kQ];  // quad q's four op codes, a byte each
  float par[kV];

  __device__ __forceinline__ int code(int j) const {
    return (op[j >> 2] >> (8 * (j & 3))) & 0xff;
  }

  // this thread's lanes of quad q with op code c (1-5), by one byte-wise
  // compare of the quad's four codes
  __device__ __forceinline__ int count(int q, int c) const {
    return __popc(__vcmpeq4(op[q], 0x01010101u * (unsigned)c)) >> 3;
  }

  // Load tile ``tile`` of a row of N lanes: every lane's op code, and the
  // params of the quads that hold a push (an odd code up to F: the stack's
  // and the queue's push, the deque's pushL and pushR); no other lane's
  // param is used, so the other quads' read as 0.0 and cost no bytes.
  template <int F>
  __device__ __forceinline__ void load(const int* __restrict__ ops,
                                       const float* __restrict__ params, int N, int tile) {
    int o[kQ][4];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {  // every op load in flight before any is used
      const int lo = quad_lo(tile, q);
      if (warp_past(tile, q, N)) {
        o[q][0] = o[q][1] = o[q][2] = o[q][3] = 0;
      } else if (lo + 4 <= N && aligned16(ops + lo)) {
        const int4 a = *reinterpret_cast<const int4*>(ops + lo);
        o[q][0] = a.x, o[q][1] = a.y, o[q][2] = a.z, o[q][3] = a.w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) o[q][b] = lo + b < N ? ops[lo + b] : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      unsigned w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) w |= (unsigned)min((unsigned)o[q][b], 5u) << (8 * b);
      op[q] = w;
      unsigned push = __vcmpeq4(w, 0x01010101u);
      if (F == 4) push |= __vcmpeq4(w, 0x03030303u);
      const int lo = quad_lo(tile, q);
      if (push == 0u) {
        par[4 * q] = par[4 * q + 1] = par[4 * q + 2] = par[4 * q + 3] = 0.0f;
      } else if (lo + 4 <= N && aligned16(params + lo)) {
        const float4 b = *reinterpret_cast<const float4*>(params + lo);
        par[4 * q] = b.x, par[4 * q + 1] = b.y, par[4 * q + 2] = b.z, par[4 * q + 3] = b.w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) par[4 * q + b] = lo + b < N ? params[lo + b] : 0.0f;
      }
    }
  }
};

// Store the responses and kinds of this thread's quad q of tile ``tile``.
__device__ __forceinline__ void store_quad(float* resp, int* kinds, int N, int tile, int q,
                                           const float (&v)[4], const int (&kind)[4]) {
  const int lo = quad_lo(tile, q);
  if (lo + 4 <= N && aligned16(resp + lo) && aligned16(kinds + lo)) {
    *reinterpret_cast<float4*>(resp + lo) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(kinds + lo) = make_int4(kind[0], kind[1], kind[2], kind[3]);
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (lo + b < N) resp[lo + b] = v[b], kinds[lo + b] = kind[b];
    }
  }
}

// Rank a tile's lanes under F flags block-wide (``count(i, q)``: this
// thread's lanes of quad q under flag i): ``base[i][q]`` is the number of
// flag-i lanes of the tile before this thread's quad q, ``tsum[i]`` the
// tile's count.  A sub-tile holds 4 x blockDim <= 4096 lanes, so two counts
// share a 32-bit word (16 bits each) through the scan: F x kQ / 2 words a
// thread.  ``sm`` holds kRankInts<F> ints; every thread of the block must
// call it.
template <int F>
constexpr int kRankInts = F * kQ / 2 * 32;

template <int F, typename Count>
__device__ __forceinline__ void rank_quads(Count count, int (&base)[F][kQ], int (&tsum)[F],
                                           int* sm) {
  constexpr int kW = F * kQ / 2;  // count c = i * kQ + q sits in word c / 2, half c % 2
  int w[kW] = {};
#pragma unroll
  for (int i = 0; i < F; ++i) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = i * kQ + q;
      w[c >> 1] += count(i, q) << (16 * (c & 1));
    }
  }
  int ex[kW], tot[kW];
  block_scan<kW>(w, ex, tot, sm);
#pragma unroll
  for (int i = 0; i < F; ++i) {
    int run = 0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = i * kQ + q, sh = 16 * (c & 1);
      base[i][q] = ((ex[c >> 1] >> sh) & 0xffff) + run;
      run += (tot[c >> 1] >> sh) & 0xffff;
    }
    tsum[i] = run;
  }
}

// Zero row[0, N), the whole block: 16-byte stores where the row starts on a
// 16-byte boundary.
__device__ __forceinline__ void zero_row(float* row, int N) {
  int done = 0;
  if (aligned16(row)) {
    done = N & ~3;
    float4* v = reinterpret_cast<float4*>(row);
    for (int i = threadIdx.x; i < (done >> 2); i += blockDim.x)
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int k = done + threadIdx.x; k < N; k += blockDim.x) row[k] = 0.0f;
}

// A ring push that survives elimination lands in its slot of the phase's
// row and of every later row (rows k..K-1 of the shard, ``stride`` apart):
// a later phase's push to the slot overwrites the rows from its own on.
__device__ __forceinline__ void store_forward(float* row_k, size_t stride, int n_rows,
                                              size_t slot, float v) {
  for (int r = 0; r < n_rows; ++r) row_k[r * stride + slot] = v;
}

// ------------------------------------------------------------ ring phases
// One combining phase of a stack, a queue or a deque over a row of ``n``
// lanes, one block, in the steps every ring kernel takes: count (the
// totals), the push routing, a barrier (the caller's), and the answers.  The
// stack and the queue share both (ring_pushes, ring_answers: the queue's
// enqueues route as the stack's pushes; the two differ in the order their
// pops take the committed values and this phase's pushes); the one-phase
// and K-phase kernels differ only in where a surviving push lands and where
// a pop past elimination reads, which they pass in as callables.  A row of
// one tile is loaded and ranked once; a row of more tiles is reloaded and
// re-ranked in each step.  Every thread of the block calls each step.
template <int F>
struct RingLanes {
  const int* op;
  const float* par;
  float* resp;  // this block's lanes' responses and kinds
  int* kinds;
  int n, ntiles;
  int* sm;  // kRankInts<F> ints of scan scratch
  LaneTile lt;
  int base[F][kQ], tsum[F];

  __device__ __forceinline__ RingLanes(const int* op_, const float* par_, float* resp_,
                                       int* kinds_, int n_, int* sm_)
      : op(op_), par(par_), resp(resp_), kinds(kinds_), n(n_),
        ntiles((n_ + kTile - 1) / kTile), sm(sm_) {}

  __device__ __forceinline__ void scan() {
    rank_quads<F>([&](int i, int q) { return lt.count(q, i + 1); }, base, tsum, sm);
  }
  // tile t again, for a step after the count
  __device__ __forceinline__ void again(int t) {
    if (ntiles > 1) {
      lt.load<F>(op, par, n, t);
      scan();
    }
  }
  // whether quad q holds no op of the kind (codes 1..F)
  __device__ __forceinline__ bool quiet(int q) const {
    unsigned m = 0u;
#pragma unroll
    for (int c = 1; c <= F; ++c) m |= __vcmpeq4(lt.op[q], 0x01010101u * (unsigned)c);
    return m == 0u;
  }

  // The totals of flags i (op code i + 1) over the lanes.  A quiet quad is
  // answered here, R_NONE with 0.0, as soon as it is loaded, so most of the
  // response stores overlap the scan; the answer step skips it.  Returns
  // whether this thread saw a non-zero op code.
  __device__ __forceinline__ int count(int (&total)[F]) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < F; ++i) total[i] = 0;
    for (int t = 0; t < ntiles; ++t) {
      lt.load<F>(op, par, n, t);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        any |= lt.op[q] != 0u;
        if (warp_past(t, q, n) || !quiet(q)) continue;
        const float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int kind[4] = {R_NONE, R_NONE, R_NONE, R_NONE};
        store_quad(resp, kinds, n, t, q, v, kind);
      }
      scan();
#pragma unroll
      for (int i = 0; i < F; ++i) total[i] += tsum[i];
    }
    return any;
  }
};

// Stack pushes and queue enqueues (flag 0, OP_PUSH == ENQ) by rank: rank <
// n_elim meets its pop (elim(rank, v)), the surplus goes to sink(rank -
// n_elim, v); v is the param + 0.0f, so a routed -0.0 lands as +0.0.
template <typename Elim, typename Sink>
__device__ __forceinline__ void ring_pushes(RingLanes<2>& rl, int n_elim, Elim elim,
                                            Sink sink) {
  int carry = 0;
  for (int t = 0; t < rl.ntiles; ++t) {
    rl.again(t);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (warp_past(t, q, rl.n)) continue;
      int rk = carry + rl.base[0][q];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (rl.lt.code(4 * q + b) != OP_PUSH) continue;
        const float v = rl.lt.par[4 * q + b] + 0.0f;
        if (rk < n_elim) elim(rk, v); else sink(rk - n_elim, v);
        ++rk;
      }
    }
    carry += rl.tsum[0];
  }
}

// Stack and queue answers: a push R_ACK; a pop of rank ``rk`` first(rk)
// while rk < n_first, then second(rk - n_first) while that is < n_second,
// else R_EMPTY; other codes R_NONE with 0.0 (quiet quads were answered by
// the count).  A stack's pops meet this phase's pushes first (first: the
// elimination buffer; second: the committed stack from its top), a queue's
// drain the committed window first (first: the window from the head;
// second: the elimination buffer).
template <typename N1, typename First, typename N2, typename Second>
__device__ __forceinline__ void ring_answers(RingLanes<2>& rl, N1 n_first, First first,
                                             N2 n_second, Second second) {
  int carry = 0;
  for (int t = 0; t < rl.ntiles; ++t) {
    rl.again(t);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (warp_past(t, q, rl.n) || rl.quiet(q)) continue;
      int rk = carry + rl.base[1][q];
      float v[4];
      int kind[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int o = rl.lt.code(4 * q + b);
        kind[b] = R_NONE;
        v[b] = 0.0f;
        if (o == OP_PUSH) {
          kind[b] = R_ACK;
        } else if (o == OP_POP) {
          if (rk < n_first) {
            kind[b] = R_VALUE;
            v[b] = first(rk);
          } else if (rk - n_first < n_second) {
            kind[b] = R_VALUE;
            v[b] = second((int)(rk - n_first));
          } else {
            kind[b] = R_EMPTY;
          }
          ++rk;
        }
      }
      store_quad(rl.resp, rl.kinds, rl.n, t, q, v, kind);
    }
    carry += rl.tsum[1];
  }
}

// Deque, before the barrier: pushL of rank < nl_elim -> elim_l(rank, v),
// pushR of rank < nr_elim -> elim_r(rank, v), the left surplus ->
// sink_l(rank - nl_elim, v).  The right surplus lands after the barrier
// (deque_answers), as the reference applies the right side after the left.
template <typename ElimL, typename ElimR, typename SinkL>
__device__ __forceinline__ void deque_pushes(RingLanes<4>& rl, int nl_elim, int nr_elim,
                                             ElimL elim_l, ElimR elim_r, SinkL sink_l) {
  int cl = 0, cr = 0;
  for (int t = 0; t < rl.ntiles; ++t) {
    rl.again(t);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (warp_past(t, q, rl.n)) continue;
      int rl_ = cl + rl.base[0][q], rr = cr + rl.base[2][q];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * q + b;
        const int o = rl.lt.code(j);
        if (o == OP_PUSHL) {
          const float v = rl.lt.par[j] + 0.0f;
          if (rl_ < nl_elim) elim_l(rl_, v); else sink_l(rl_ - nl_elim, v);
          ++rl_;
        } else if (o == OP_PUSHR) {
          if (rr < nr_elim) elim_r(rr, rl.lt.par[j] + 0.0f);
          ++rr;
        }
      }
    }
    cl += rl.tsum[0];
    cr += rl.tsum[2];
  }
}

// Deque answers (after the barrier that publishes the left pushes): pushes
// R_ACK, the right surplus to sink_r(rank - nr_elim, v); a popL of rank <
// nl_elim buf_l[rank], then pop_l(k) for k = rank - nl_elim < size; a popR
// of rank < nr_elim buf_r[rank], then pop_r(k) for k < size_after (the
// committed slots, then this phase's left pushes); else R_EMPTY.
template <typename SinkR, typename PopL, typename PopR>
__device__ __forceinline__ void deque_answers(RingLanes<4>& rl, int nl_elim, int nr_elim,
                                              const float* buf_l, const float* buf_r,
                                              long long size, long long size_after,
                                              SinkR sink_r, PopL pop_l, PopR pop_r) {
  int ql = 0, qr = 0, pr = 0;
  for (int t = 0; t < rl.ntiles; ++t) {
    rl.again(t);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (warp_past(t, q, rl.n) || rl.quiet(q)) continue;
      int rql = ql + rl.base[1][q], rqr = qr + rl.base[3][q], rpr = pr + rl.base[2][q];
      float v[4];
      int kind[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * q + b;
        const int o = rl.lt.code(j);
        kind[b] = R_NONE;
        v[b] = 0.0f;
        if (o == OP_PUSHL) {
          kind[b] = R_ACK;
        } else if (o == OP_PUSHR) {
          kind[b] = R_ACK;
          if (rpr >= nr_elim) sink_r(rpr - nr_elim, rl.lt.par[j] + 0.0f);
          ++rpr;
        } else if (o == OP_POPL) {
          if (rql < nl_elim) {
            kind[b] = R_VALUE;
            v[b] = buf_l[rql];
          } else if (rql - nl_elim < size) {
            kind[b] = R_VALUE;
            v[b] = pop_l(rql - nl_elim);
          } else {
            kind[b] = R_EMPTY;
          }
          ++rql;
        } else if (o == OP_POPR) {
          if (rqr < nr_elim) {
            kind[b] = R_VALUE;
            v[b] = buf_r[rqr];
          } else if (rqr - nr_elim < size_after) {
            kind[b] = R_VALUE;
            v[b] = pop_r(rqr - nr_elim);
          } else {
            kind[b] = R_EMPTY;
          }
          ++rqr;
        }
      }
      store_quad(rl.resp, rl.kinds, rl.n, t, q, v, kind);
    }
    ql += rl.tsum[1];
    qr += rl.tsum[3];
    pr += rl.tsum[2];
  }
}

// ------------------------------------------------------------- map walk
// One map shard's lanes apply in announcement order, a serial chain.  The
// block compacts up to kMapTile lanes at a time (16 a thread, one block-wide
// scan) into a shared array of live lanes (ops 1-4: index and op), and warp
// 0 walks only those, fetching their keys and params a chunk of 32 ahead.
// The bucket of the current lane sits in registers, one slot a lane; the
// buckets the walk touches sit in a direct-mapped cache in shared memory
// (kMapSets sets of one 8-slot bucket) with a dirty flag per set.  A dirty
// bucket is stored into the phase's row and every later row (rows k..K-1)
// when it is evicted and, by the whole block, at the end of the phase, so a
// miss reads the phase's row and row j holds the state after phase j.  The
// warp stages each lane's hit value and outcome bits in shared memory, and
// the block answers the lanes after the walk, so the chain per lane is the
// probe (two ballots, or none in a run of one key) and the slot update.
constexpr int kMapSets = 512;  // power of two
constexpr int kMapTile = kTile;
constexpr int kIdxMask = 0x0fffffff;           // l_io: lane index | op << 28

struct MapSmem {
  int tag[kMapSets];    // bucket held by each set, -1 when empty
  int dirty[kMapSets];  // the set's bucket changed since it was last stored
  int ck[kMapSets * 8];
  float cv[kMapSets * 8];
  int co[kMapSets * 8];
  int l_io[kMapTile];  // live lanes in order: index | op << 28
  float l_resp[kMapTile];         // the hit value
  unsigned char l_kind[kMapTile];  // MAP_HIT | MAP_FREE | MAP_CAS_OK
  int scan[kRankInts<1>];
};

// The table rows one phase writes: the phase's row of the shard and the
// ``n_rows - 1`` later ones, ``stride`` elements apart.
struct MapRows {
  int* keys;
  float* vals;
  int* occ;
  size_t stride;
  int n_rows;
};

// The walker's registers: the bucket in flight and its slot (one a lane).
struct MapCursor {
  int bkt = -1, set = 0, e = 0, wk = 0, wo = 0;  // e: this lane's slot of the set
  float wv = 0.0f;
  bool mod = false;  // the bucket changed since it came from its cache set
  // the previous lane's key fk: present (fpres) at slot fslot with value
  // fval; valid while ``fast``.  fmask, the bucket's free slots as the last
  // ballot saw them, is read only while fk is absent, and a lane that leaves
  // fk absent changes no slot
  bool fast = false, fpres = false;
  int fk = 0, fslot = 0;
  float fval = 0.0f;
  unsigned fmask = 0u;
  int cnt = 0;  // the live-entry count; all of these are the same in every lane
};

__device__ __forceinline__ void map_cache_init(MapSmem& sm) {
  for (int i = threadIdx.x; i < kMapSets; i += blockDim.x) sm.tag[i] = -1, sm.dirty[i] = 0;
}

// Store slot ``slot`` of bucket ``bkt`` into rows k..K-1.
__device__ __forceinline__ void map_store_slot(const MapRows& rows, int bkt, int bslots, int slot,
                                               int k_, float v_, int o_) {
  const size_t g = (size_t)bkt * bslots + slot;
  for (int r = 0; r < rows.n_rows; ++r) {
    rows.keys[r * rows.stride + g] = k_;
    rows.vals[r * rows.stride + g] = v_;
    rows.occ[r * rows.stride + g] = o_;
  }
}

// Compact tile ``tile`` of the lane row (whole block): live lanes into
// sm.l_io in lane order; every lane's response and kind start as 0.0 and
// R_NONE (the walk's scatter overwrites the live ones).  Returns the tile's
// live count; ``any`` gathers non-zero op codes.
__device__ __forceinline__ int map_compact(MapSmem& sm, const int* __restrict__ ops,
                                           float* resp, int* kinds, int N, int tile, int& any) {
  int o[kV];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int lo = quad_lo(tile, q);
    if (lo + 4 <= N && aligned16(ops + lo) && aligned16(resp + lo) && aligned16(kinds + lo)) {
      const int4 a = *reinterpret_cast<const int4*>(ops + lo);
      o[4 * q] = a.x, o[4 * q + 1] = a.y, o[4 * q + 2] = a.z, o[4 * q + 3] = a.w;
      *reinterpret_cast<float4*>(resp + lo) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<int4*>(kinds + lo) = make_int4(R_NONE, R_NONE, R_NONE, R_NONE);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        o[4 * q + b] = lo + b < N ? ops[lo + b] : 0;
        if (lo + b < N) resp[lo + b] = 0.0f, kinds[lo + b] = R_NONE;
      }
    }
  }
  auto live = [&](int, int q) {
    int n = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) n += o[4 * q + b] >= OP_MAP_INSERT && o[4 * q + b] <= OP_MAP_CAS;
    return n;
  };
  int base[1][kQ], total[1];
  rank_quads<1>(live, base, total, sm.scan);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int lo = quad_lo(tile, q);
    int pos = base[0][q];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = o[4 * q + b];
      any |= c != 0;
      if (c >= OP_MAP_INSERT && c <= OP_MAP_CAS) sm.l_io[pos++] = (lo + b) | (c << 28);
    }
  }
  __syncthreads();
  return total[0];
}

// Warp 0 walks the ``n_live`` compacted lanes of the tile in order (every
// lane of the warp calls it).  For each, the first ``bslots`` lanes hold the
// key's bucket and ballots give the first hit / free slot (offset 0 when
// there is none, as the reference's argmax gives it).  A lane whose key is
// the previous lane's, in the same bucket, skips the ballots: the cursor
// carries that key's slot, value and the bucket's free mask from the
// previous lane (dropped after a delete, so a second copy of a key in a
// bucket is still found by the ballots).  The warp stages the hit value
// (kSummedCur: the masked window sum, +0.0 plus the hit, or the hit alone
// when the window is one slot wide; else the hit slot's own value) and the
// outcome bits (MAP_HIT, MAP_FREE, MAP_CAS_OK); map_answer turns them into
// the response after the walk, off the chain.  The bucket's registers go
// back to its cache set when the walk leaves it.
constexpr int MAP_HIT = 1, MAP_FREE = 2, MAP_CAS_OK = 4;

// Write the bucket in flight back to its cache set, dirty, if it changed.
__device__ __forceinline__ void map_put_back(MapSmem& sm, MapCursor& cur, bool in_win) {
  if (!cur.mod) return;
  if (in_win) sm.ck[cur.e] = cur.wk, sm.cv[cur.e] = cur.wv, sm.co[cur.e] = cur.wo;
  if ((threadIdx.x & 31) == 0) sm.dirty[cur.set] = 1;
  cur.mod = false;
}

template <bool kSummedCur>
__device__ void map_walk(MapSmem& sm, MapCursor& cur, int n_live, const MapRows& rows,
                         const int* __restrict__ lkeys, const float* __restrict__ params,
                         int bslots, unsigned n_buckets) {
  const int lane = threadIdx.x & 31;
  const bool in_win = lane < bslots;
  int f_io = 0, f_key = 0;  // the next chunk's lanes, one a lane of the warp
  float f_par = 0.0f;
  auto fetch = [&](int base) {
    const int e = base + lane;
    f_io = e < n_live ? sm.l_io[e] : 0;
    f_key = e < n_live ? lkeys[f_io & kIdxMask] : 0;
    f_par = e < n_live ? params[f_io & kIdxMask] : 0.0f;
  };
  fetch(0);
  for (int base = 0; base < n_live; base += 32) {
    const int c_op = f_io >> 28, c_key = f_key;
    const float c_par = f_par;
    const int c_bkt = (int)map_bucket(c_key, n_buckets);
    if (base + 32 < n_live) fetch(base + 32);  // in flight while this chunk walks
    const int n_here = min(32, n_live - base);
    int key = __shfl_sync(kFull, c_key, 0), o = __shfl_sync(kFull, c_op, 0);
    int bkt = __shfl_sync(kFull, c_bkt, 0);
    float par = __shfl_sync(kFull, c_par, 0);
    for (int t = 0; t < n_here; ++t) {
      // the next lane's inputs, shuffled ahead of this lane's chain
      const int tn = min(t + 1, 31);
      const int key_n = __shfl_sync(kFull, c_key, tn), o_n = __shfl_sync(kFull, c_op, tn);
      const int bkt_n = __shfl_sync(kFull, c_bkt, tn);
      const float par_n = __shfl_sync(kFull, c_par, tn);
      if (bkt != cur.bkt) {
        map_put_back(sm, cur, in_win);
        __syncwarp();  // slot writes, dirty flags and tags are seen below
        const int set = bkt & (kMapSets - 1);
        const int e = set * 8 + lane;
        if (sm.tag[set] == bkt) {
          if (in_win) cur.wk = sm.ck[e], cur.wv = sm.cv[e], cur.wo = sm.co[e];
        } else {
          if (sm.tag[set] >= 0 && sm.dirty[set] && in_win)  // evict: store it forward
            map_store_slot(rows, sm.tag[set], bslots, lane, sm.ck[e], sm.cv[e], sm.co[e]);
          if (in_win) {  // a miss: the phase's row holds the bucket's current slots
            const size_t g = (size_t)bkt * bslots + lane;
            cur.wk = __ldcg(rows.keys + g);
            cur.wv = __ldcg(rows.vals + g);
            cur.wo = __ldcg(rows.occ + g);
            sm.ck[e] = cur.wk, sm.cv[e] = cur.wv, sm.co[e] = cur.wo;
          }
          __syncwarp();
          if (lane == 0) sm.tag[set] = bkt, sm.dirty[set] = 0;
        }
        if (!in_win) cur.wk = 0, cur.wv = 0.0f, cur.wo = 0;
        cur.bkt = bkt;
        cur.set = set;
        cur.e = e;
        cur.fast = false;
      }
      bool has_hit, has_free;
      int hit_off;
      float hv;
      if (cur.fast && key == cur.fk) {  // the previous lane's key: no ballots
        has_hit = cur.fpres;
        hit_off = cur.fslot;
        hv = cur.fval;
        has_free = cur.fmask != 0u;
      } else {
        // key 0 is legal: a hit needs the occupied flag
        const unsigned hit_m = __ballot_sync(kFull, in_win && cur.wo != 0 && cur.wk == key);
        cur.fmask = __ballot_sync(kFull, in_win && cur.wo == 0);
        has_hit = hit_m != 0u;
        has_free = cur.fmask != 0u;
        hit_off = has_hit ? __ffs(hit_m) - 1 : 0;
        hv = __shfl_sync(kFull, cur.wv, hit_off);
      }
      const int free_off = has_free ? __ffs(cur.fmask) - 1 : 0;
      const bool is_ins = o == OP_MAP_INSERT, is_del = o == OP_MAP_DELETE;
      const bool is_cas = o == OP_MAP_CAS;
      const float cv = has_hit ? (kSummedCur && bslots > 1 ? hv + 0.0f : hv) : 0.0f;
      const float expected = floorf(par / CAS_DOM);
      const bool cas_ok = is_cas && has_hit && cv == expected;
      const bool do_ins = is_ins && (has_hit || has_free);
      const bool do_del = is_del && has_hit;
      // every lane stores the same values: no branch on the chain
      sm.l_resp[base + t] = cv;
      sm.l_kind[base + t] = (unsigned char)((has_hit ? MAP_HIT : 0) |
                                            (has_free ? MAP_FREE : 0) |
                                            (cas_ok ? MAP_CAS_OK : 0));
      const bool wr = do_ins || cas_ok || do_del;
      const int woff = has_hit ? hit_off : free_off;
      const int nk = do_del ? 0 : key, no = do_del ? 0 : 1;
      const float nv = do_del ? 0.0f : (is_cas ? par - expected * CAS_DOM : par);
      const bool mine = wr && lane == woff;
      cur.wk = mine ? nk : cur.wk;
      cur.wv = mine ? nv : cur.wv;
      cur.wo = mine ? no : cur.wo;
      cur.mod = cur.mod || wr;
      // this key's slot after the lane, for the next lane if it has the key
      cur.fast = !do_del;
      cur.fk = key;
      cur.fpres = has_hit || do_ins;
      cur.fslot = woff;
      cur.fval = wr ? nv : hv;
      cur.cnt += (is_ins && !has_hit && has_free ? 1 : 0) - (do_del ? 1 : 0);
      key = key_n, o = o_n, bkt = bkt_n, par = par_n;
    }
  }
  map_put_back(sm, cur, in_win);
}

// The response of a walked lane with op ``o`` from its staged outcome bits
// and hit value, as the reference answers it.
__device__ __forceinline__ void map_answer(int o, int bits, float cv, float& resp, int& kind) {
  const bool has_hit = bits & MAP_HIT, has_free = bits & MAP_FREE;
  const bool cas_ok = bits & MAP_CAS_OK;
  const bool is_ins = o == OP_MAP_INSERT, is_lku = o == OP_MAP_LOOKUP;
  const bool is_del = o == OP_MAP_DELETE, is_cas = o == OP_MAP_CAS;
  kind = R_NONE;
  if (is_ins && (has_hit || has_free)) kind = R_ACK;
  if (is_ins && !has_hit && !has_free) kind = R_FULL;
  if ((is_lku || is_del || is_cas) && !has_hit) kind = R_EMPTY;
  if ((is_lku || is_del || cas_ok) && has_hit) kind = R_VALUE;
  if (is_cas && has_hit && !cas_ok) kind = R_CAS_FAIL;
  resp = ((is_lku || is_del || is_cas) && has_hit) ? cv : 0.0f;
}

// One phase of one map shard (whole block): tiles of lanes compacted and
// walked by warp 0, each tile's responses scattered, then every dirty
// bucket stored into rows k..K-1.  ``cur.cnt`` comes in as the shard's
// live-entry count and leaves updated (warp 0's registers).  Returns
// whether any lane held a non-zero op code (the same in every thread).
template <bool kSummedCur>
__device__ int map_phase(MapSmem& sm, MapCursor& cur, const MapRows& rows,
                         const int* __restrict__ lkeys, const int* __restrict__ ops,
                         const float* __restrict__ params, float* resp, int* kinds, int N,
                         int bslots, unsigned n_buckets) {
  int any = 0;
  cur.bkt = -1;  // the phase's rows are new: look the first bucket up
  for (int tile = 0; tile * kMapTile < N; ++tile) {
    const int n_live = map_compact(sm, ops, resp, kinds, N, tile, any);
    if (threadIdx.x < 32)
      map_walk<kSummedCur>(sm, cur, n_live, rows, lkeys, params, bslots, n_buckets);
    __syncthreads();
    for (int e = threadIdx.x; e < n_live; e += blockDim.x) {
      const int io = sm.l_io[e];
      float r;
      int kind;
      map_answer(io >> 28, sm.l_kind[e], sm.l_resp[e], r, kind);
      resp[io & kIdxMask] = r;
      kinds[io & kIdxMask] = kind;
    }
    __syncthreads();  // the next tile reuses the lane arrays
  }
  for (int i = threadIdx.x; i < kMapSets * 8; i += blockDim.x) {
    const int set = i >> 3, slot = i & 7;
    if (sm.dirty[set] && slot < bslots)
      map_store_slot(rows, sm.tag[set], bslots, slot, sm.ck[i], sm.cv[i], sm.co[i]);
  }
  const int live = __syncthreads_or(any);
  for (int set = threadIdx.x; set < kMapSets; set += blockDim.x) sm.dirty[set] = 0;
  return live;
}

inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// the elimination buffer: n_elim <= N/2 for every kind
inline size_t elim_bytes(int N) { return (size_t)((N + 1) / 2) * sizeof(float); }

}  // namespace

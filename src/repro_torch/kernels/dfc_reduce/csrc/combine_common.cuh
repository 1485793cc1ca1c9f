// Building blocks shared by the hand-written combine kernels
// (dfc_reduce.cu: one phase per launch; phase_grid.cu: K phases per launch).
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
constexpr int kMapThreads = 1024;   // map: the whole block copies, warp 0 walks
constexpr unsigned kFull = 0xffffffffu;

// Exclusive block-wide rank of K independent lane flags over ONE tile of
// blockDim lanes.  ``sm`` holds K x 32 ints.  Every thread of the block must
// call it (it synchronizes).  ``rank[k]`` is the number of set flags k in
// the tile before this thread; ``total[k]`` the tile's count.
template <int K>
__device__ __forceinline__ void tile_rank(const bool (&flag)[K], int (&rank)[K],
                                          int (&total)[K], int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  unsigned m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    m[k] = __ballot_sync(kFull, flag[k]);
    if (lane == 0) sm[k * 32 + warp] = __popc(m[k]);
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int v = lane < nw ? sm[k * 32 + lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += t;
      }
      sm[k * 32 + lane] = v;  // inclusive prefix over the warps
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    rank[k] = (warp ? sm[k * 32 + warp - 1] : 0) + __popc(m[k] & lt);
    total[k] = sm[k * 32 + nw - 1];
  }
  __syncthreads();  // sm is reused by the next tile
}

__device__ __forceinline__ unsigned map_bucket(int key, unsigned n_buckets) {
  unsigned h = (unsigned)key * 2654435761u;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  return h % n_buckets;
}

template <typename T>
__device__ __forceinline__ void copy_row(const T* __restrict__ src, T* dst, int n) {
  const bool vec = (n & 3) == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int k = threadIdx.x; k < (n >> 2); k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
  }
}

// One map shard's serial lane chain, walked by ONE warp (every lane of the
// warp calls it) over the table rows tk/tv/to in place.  Lanes apply in
// announcement order; lane inputs are fetched 32 at a time and broadcast
// with shuffles.  For each live lane, the first ``bslots`` threads read the
// key's bucket and ballots give the first hit / free slot (offset 0 when
// there is none, as the reference's argmax gives it).  Writes resp/kinds of
// every lane and returns the updated live-entry count (the same in every
// lane).
template <bool kSummedCur>
__device__ int map_walk(int* tk, float* tv, int* to, const int* __restrict__ lkeys,
                        const int* __restrict__ ops, const float* __restrict__ params,
                        float* resp, int* kinds, int N, int bslots, unsigned n_buckets,
                        int cnt) {
  const int lane = threadIdx.x;
  const bool in_win = lane < bslots;
  for (int base = 0; base < N; base += 32) {
    const int j = base + lane;
    const int key_l = j < N ? lkeys[j] : 0;
    const int op_l = j < N ? ops[j] : 0;
    const float par_l = j < N ? params[j] : 0.0f;
    float resp_l = 0.0f;
    int kind_l = R_NONE;
    // lanes without a map op (OP_NONE padding, foreign codes) read nothing
    // and write nothing: R_NONE with a zero response, so the chain skips
    // them and walks only this chunk's live lanes, in order
    unsigned live = __ballot_sync(
        kFull, j < N && op_l >= OP_MAP_INSERT && op_l <= OP_MAP_CAS);
    while (live) {
      const int t = __ffs(live) - 1;
      live &= live - 1u;
      const int key = __shfl_sync(kFull, key_l, t);
      const int o = __shfl_sync(kFull, op_l, t);
      const float par = __shfl_sync(kFull, par_l, t);
      const size_t slot0 = (size_t)map_bucket(key, n_buckets) * bslots;
      int wk = 0, wo = 0;
      float wv = 0.0f;
      if (in_win) {
        wk = tk[slot0 + lane];
        wo = to[slot0 + lane];
        wv = tv[slot0 + lane];
      }
      // key 0 is legal: a hit needs the occupied flag
      const unsigned hit_m = __ballot_sync(kFull, in_win && wo != 0 && wk == key);
      const unsigned free_m = __ballot_sync(kFull, in_win && wo == 0);
      const bool has_hit = hit_m != 0u, has_free = free_m != 0u;
      const int hit_off = has_hit ? __ffs(hit_m) - 1 : 0;
      const int free_off = has_free ? __ffs(free_m) - 1 : 0;
      const float hv = __shfl_sync(kFull, wv, hit_off);
      // kSummedCur: the masked window sum, +0.0 plus the hit (or the hit
      // alone when the window is one slot wide); else the hit slot's value
      const float cur =
          has_hit ? (kSummedCur && bslots > 1 ? hv + 0.0f : hv) : 0.0f;

      const bool is_ins = o == OP_MAP_INSERT, is_lku = o == OP_MAP_LOOKUP;
      const bool is_del = o == OP_MAP_DELETE, is_cas = o == OP_MAP_CAS;
      const float expected = floorf(par / CAS_DOM);
      const float cas_new = par - expected * CAS_DOM;
      const bool cas_hit = is_cas && has_hit;
      const bool cas_ok = cas_hit && cur == expected;
      const bool do_ins = is_ins && (has_hit || has_free);
      const bool do_del = is_del && has_hit;
      const bool do_write = do_ins || cas_ok;
      const int woff = has_hit ? hit_off : free_off;
      if (do_write && lane == woff) {
        tk[slot0 + lane] = key;
        tv[slot0 + lane] = is_cas ? cas_new : par;
        to[slot0 + lane] = 1;
      } else if (do_del && lane == hit_off) {
        tk[slot0 + lane] = 0;
        tv[slot0 + lane] = 0.0f;
        to[slot0 + lane] = 0;
      }
      cnt += (is_ins && !has_hit && has_free ? 1 : 0) - (do_del ? 1 : 0);

      int kind = R_NONE;
      if (do_ins) kind = R_ACK;
      if (is_ins && !has_hit && !has_free) kind = R_FULL;
      if ((is_lku || is_del || is_cas) && !has_hit) kind = R_EMPTY;
      if ((is_lku || do_del || cas_ok) && has_hit) kind = R_VALUE;
      if (cas_hit && !cas_ok) kind = R_CAS_FAIL;
      if (lane == t) {
        resp_l = ((is_lku || is_del || is_cas) && has_hit) ? cur : 0.0f;
        kind_l = kind;
      }
      __syncwarp();  // this lane's table write is seen by the next probe
    }
    if (j < N) {
      resp[j] = resp_l;
      kinds[j] = kind_l;
    }
  }
  return cnt;
}

inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// the elimination buffer: n_elim <= N/2 for every kind
inline size_t elim_bytes(int N) { return (size_t)((N + 1) / 2) * sizeof(float); }

}  // namespace

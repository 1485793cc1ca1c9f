// Hand-written Hopper (sm_90a) kernels for the DFC combining phase.
//
// Four kernels, one per structure kind, each running every shard of a kind
// group in one launch: one thread block per shard (grid = S).  They compute,
// bit for bit, what the plain PyTorch versions in ../ref.py compute.  Plain C
// interface (extern "C", raw pointers, the stream as void*), built by nvcc at
// first use and bound with ctypes by ../kernel.py; every entry point returns
// cudaGetLastError() of its launch.
//
// Replaces (JAX package, kernels/dfc_reduce/kernel.py):
//   dfc_stack_reduce  <- dfc_reduce_grid_call        :539 (math _stack_reduce_math :98)
//   dfc_queue_reduce  <- dfc_queue_reduce_grid_call  :569 (math _queue_reduce_math :142)
//   dfc_deque_reduce  <- dfc_deque_reduce_grid_call  :598 (math _deque_reduce_math :185)
//   dfc_map_reduce    <- dfc_map_reduce_grid_call    :664 (math _map_reduce_math   :266)
// and, at S = 1, the single-object dfc_reduce_call :398,
// dfc_queue_reduce_call :425 and dfc_deque_reduce_call :452.
//
// What bounds them on this card, and what the design does about it:
//
// * Stack, queue, deque.  The work is a few integer ops per lane, so the
//   bound is bytes: each lane's op, param and window value read once, its
//   response, kind and segment value written once (about 24-28 bytes per
//   lane).  The TPU kernels route values with one-hot f32 matrix products
//   (an N x N matrix per shard); here ranks are a block-wide exclusive
//   prefix sum (warp ballots + popcounts, a per-warp carry in shared memory,
//   looping over tiles of the N lanes) and values move by indexed stores.
//   Eliminated pairs meet in a shared-memory buffer of ceil(N/2) floats
//   (n_elim <= N/2 for every kind; the deque's two sides share it, since
//   nl_elim + nr_elim <= N/2); surplus values are stored straight into the
//   output segment row.  Three passes over the lanes (totals, push routing,
//   responses) re-read ops from L2 instead of holding ranks in shared
//   memory.  Routed values are stored as v + 0.0f so that a pushed -0.0
//   lands as +0.0, as the reference's scatter-add into zeros gives it.
// * Map.  Map ops do not commute, so one shard's lanes form a serial chain
//   of N dependent bucket probes: the bound is the latency of that chain,
//   not bytes.  One warp walks the lanes in announcement order, skipping
//   lanes without a map op (a routed row is mostly OP_NONE padding); for
//   each live lane, 8 threads read the key's 8-slot bucket and __ballot_sync gives the
//   hit and free masks (first set bit, or offset 0 when empty, as the
//   reference's argmax gives it).  Lane inputs are fetched 32 at a time and
//   broadcast with shuffles, so the chain waits only on the bucket loads.
//   Before the walk the whole block copies the shard's table row (keys,
//   values, occupied) into the output row with 16-byte loads, as the TPU
//   design carries the whole table in and out; that copy is the map's byte
//   cost (12 bytes per slot, read and written).

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

// ------------------------------------------------------------------ stack
__global__ void __launch_bounds__(kThreads)
stack_kernel(const int* __restrict__ ops, const float* __restrict__ params,
             const float* __restrict__ windows, const int* __restrict__ sizes,
             float* resp, int* kinds, float* segments, int* counts, int N) {
  extern __shared__ float elim_buf[];  // push params by rank < n_elim
  __shared__ int sm[2 * 32];
  const size_t row = (size_t)blockIdx.x * N;
  const int* op = ops + row;
  const float* par = params + row;
  const float* win = windows + row;
  float* seg = segments + row;
  const int size = sizes[blockIdx.x];

  int p_total = 0, q_total = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[2] = {o == OP_PUSH, o == OP_POP};
    int r[2], t[2];
    tile_rank<2>(f, r, t, sm);
    p_total += t[0];
    q_total += t[1];
  }
  const int n_elim = min(p_total, q_total);
  const int n_push_surplus = max(p_total - n_elim, 0);
  for (int k = n_push_surplus + threadIdx.x; k < N; k += blockDim.x) seg[k] = 0.0f;

  // pushes by rank: eliminated ones meet their pop in shared memory, the
  // surplus is rank-compacted into the segment row
  int carry = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[1] = {o == OP_PUSH};
    int r[1], t[1];
    tile_rank<1>(f, r, t, sm);
    if (f[0]) {
      const int rk = carry + r[0];
      const float v = par[i] + 0.0f;
      if (rk < n_elim) elim_buf[rk] = v; else seg[rk - n_elim] = v;
    }
    carry += t[0];
  }
  __syncthreads();

  carry = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[1] = {o == OP_POP};
    int r[1], t[1];
    tile_rank<1>(f, r, t, sm);
    if (i < N) {
      int kind = R_NONE;
      float v = 0.0f;
      if (o == OP_PUSH) {
        kind = R_ACK;
      } else if (f[0]) {
        const int rk = carry + r[0];
        if (rk < n_elim) {
          kind = R_VALUE;
          v = elim_buf[rk];
        } else {
          const int depth = rk - n_elim;
          const int src = N - 1 - depth;  // window[N-1] is the committed top
          if (src >= 0 && depth < size) {
            kind = R_VALUE;
            v = win[src];
          } else {
            kind = R_EMPTY;
          }
        }
      }
      resp[row + i] = v;
      kinds[row + i] = kind;
    }
    carry += t[0];
  }
  if (threadIdx.x == 0) {
    int* c = counts + (size_t)blockIdx.x * 4;
    c[0] = n_push_surplus;
    c[1] = min(max(q_total - n_elim, 0), size);
    c[2] = n_elim;
    c[3] = q_total;
  }
}

// ------------------------------------------------------------------ queue
__global__ void __launch_bounds__(kThreads)
queue_kernel(const int* __restrict__ ops, const float* __restrict__ params,
             const float* __restrict__ windows, const int* __restrict__ sizes,
             float* resp, int* kinds, float* segments, int* counts, int N) {
  extern __shared__ float elim_buf[];  // enq params by rank < n_elim
  __shared__ int sm[2 * 32];
  const size_t row = (size_t)blockIdx.x * N;
  const int* op = ops + row;
  const float* par = params + row;
  const float* win = windows + row;
  float* seg = segments + row;
  const int size = sizes[blockIdx.x];

  int p_total = 0, q_total = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[2] = {o == OP_PUSH, o == OP_POP};
    int r[2], t[2];
    tile_rank<2>(f, r, t, sm);
    p_total += t[0];
    q_total += t[1];
  }
  const int n_from_q = min(q_total, size);
  const int n_elim = min(max(q_total - size, 0), p_total);
  const int n_enq_surplus = max(p_total - n_elim, 0);
  for (int k = n_enq_surplus + threadIdx.x; k < N; k += blockDim.x) seg[k] = 0.0f;

  int carry = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[1] = {o == OP_PUSH};
    int r[1], t[1];
    tile_rank<1>(f, r, t, sm);
    if (f[0]) {
      const int rk = carry + r[0];
      const float v = par[i] + 0.0f;
      if (rk < n_elim) elim_buf[rk] = v; else seg[rk - n_elim] = v;
    }
    carry += t[0];
  }
  __syncthreads();

  carry = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[1] = {o == OP_POP};
    int r[1], t[1];
    tile_rank<1>(f, r, t, sm);
    if (i < N) {
      int kind = R_NONE;
      float v = 0.0f;
      if (o == OP_PUSH) {
        kind = R_ACK;
      } else if (f[0]) {
        const int rk = carry + r[0];
        if (rk < size) {  // served FIFO from the front window
          kind = R_VALUE;
          v = win[min(rk, N - 1)];
        } else if (rk - size < n_elim) {  // drained: pairs with enq rank rk-size
          kind = R_VALUE;
          v = elim_buf[rk - size];
        } else {
          kind = R_EMPTY;
        }
      }
      resp[row + i] = v;
      kinds[row + i] = kind;
    }
    carry += t[0];
  }
  if (threadIdx.x == 0) {
    int* c = counts + (size_t)blockIdx.x * 4;
    c[0] = n_enq_surplus;
    c[1] = n_from_q;
    c[2] = n_elim;
    c[3] = q_total;
  }
}

// ------------------------------------------------------------------ deque
__global__ void __launch_bounds__(kThreads)
deque_kernel(const int* __restrict__ ops, const float* __restrict__ params,
             const float* __restrict__ windows_l, const float* __restrict__ windows_r,
             const int* __restrict__ sizes, float* resp, int* kinds,
             float* segs_l, float* segs_r, int* counts, int N) {
  // [0, nl_elim): pushL params by rank; [nl_elim, nl_elim + nr_elim): pushR
  extern __shared__ float elim_buf[];
  __shared__ int sm[4 * 32];
  const size_t row = (size_t)blockIdx.x * N;
  const int* op = ops + row;
  const float* par = params + row;
  const float* wl = windows_l + row;
  const float* wr = windows_r + row;
  float* sgl = segs_l + row;
  float* sgr = segs_r + row;
  const int size = sizes[blockIdx.x];

  int npl = 0, nql = 0, npr = 0, nqr = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[4] = {o == OP_PUSHL, o == OP_POPL, o == OP_PUSHR, o == OP_POPR};
    int r[4], t[4];
    tile_rank<4>(f, r, t, sm);
    npl += t[0];
    nql += t[1];
    npr += t[2];
    nqr += t[3];
  }
  const int nl_elim = min(npl, nql);
  const int nr_elim = min(npr, nqr);
  const int sl = max(npl - nl_elim, 0);
  const int tl = max(nql - nl_elim, 0);
  const int dl = min(tl, size);
  const int size_after = size + sl - dl;
  const int sr = max(npr - nr_elim, 0);
  const int tr = max(nqr - nr_elim, 0);
  const int dr = min(tr, size_after);
  float* buf_l = elim_buf;
  float* buf_r = elim_buf + nl_elim;
  for (int k = sl + threadIdx.x; k < N; k += blockDim.x) sgl[k] = 0.0f;
  for (int k = sr + threadIdx.x; k < N; k += blockDim.x) sgr[k] = 0.0f;

  int cl = 0, cr = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[2] = {o == OP_PUSHL, o == OP_PUSHR};
    int r[2], t[2];
    tile_rank<2>(f, r, t, sm);
    if (f[0]) {
      const int rk = cl + r[0];
      const float v = par[i] + 0.0f;
      if (rk < nl_elim) buf_l[rk] = v; else sgl[rk - nl_elim] = v;
    } else if (f[1]) {
      const int rk = cr + r[1];
      const float v = par[i] + 0.0f;
      if (rk < nr_elim) buf_r[rk] = v; else sgr[rk - nr_elim] = v;
    }
    cl += t[0];
    cr += t[1];
  }
  __syncthreads();  // also publishes the seg_l row to the right pops below

  cl = cr = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int o = i < N ? op[i] : 0;
    const bool f[2] = {o == OP_POPL, o == OP_POPR};
    int r[2], t[2];
    tile_rank<2>(f, r, t, sm);
    if (i < N) {
      int kind = R_NONE;
      float v = 0.0f;
      if (o == OP_PUSHL || o == OP_PUSHR) {
        kind = R_ACK;
      } else if (f[0]) {
        const int rk = cl + r[0];
        if (rk < nl_elim) {
          kind = R_VALUE;
          v = buf_l[rk];
        } else if (rk - nl_elim < size) {
          kind = R_VALUE;
          v = wl[min(rk - nl_elim, N - 1)];
        } else {
          kind = R_EMPTY;
        }
      } else if (f[1]) {
        const int rk = cr + r[1];
        if (rk < nr_elim) {
          kind = R_VALUE;
          v = buf_r[rk];
        } else {
          const int kr = rk - nr_elim;
          if (kr < size_after) {
            kind = R_VALUE;
            // committed window first, then this phase's left pushes
            v = kr < size ? wr[min(kr, N - 1)] : sgl[min(max(kr - size, 0), N - 1)];
          } else {
            kind = R_EMPTY;
          }
        }
      }
      resp[row + i] = v;
      kinds[row + i] = kind;
    }
    cl += t[0];
    cr += t[1];
  }
  if (threadIdx.x == 0) {
    int* c = counts + (size_t)blockIdx.x * 8;
    c[0] = sl;
    c[1] = dl;
    c[2] = sr;
    c[3] = dr;
    c[4] = nl_elim;
    c[5] = nr_elim;
    c[6] = size_after;
    c[7] = 0;
  }
}

// -------------------------------------------------------------------- map
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

__global__ void __launch_bounds__(kMapThreads)
map_kernel(const int* __restrict__ mkeys, const float* __restrict__ mvals,
           const int* __restrict__ mocc, const int* __restrict__ counts_in,
           const int* __restrict__ lkeys, const int* __restrict__ ops,
           const float* __restrict__ params, int* keys_out, float* vals_out,
           int* occ_out, int* count_out, float* resp, int* kinds, int C, int N,
           int bslots, unsigned n_buckets) {
  const size_t trow = (size_t)blockIdx.x * C;
  const size_t lrow = (size_t)blockIdx.x * N;
  int* tk = keys_out + trow;
  float* tv = vals_out + trow;
  int* to = occ_out + trow;
  copy_row(mkeys + trow, tk, C);
  copy_row(mvals + trow, tv, C);
  copy_row(mocc + trow, to, C);
  __syncthreads();
  if (threadIdx.x >= 32) return;  // the serial lane chain is one warp's

  const int lane = threadIdx.x;
  const bool in_win = lane < bslots;
  int cnt = counts_in[blockIdx.x];
  for (int base = 0; base < N; base += 32) {
    const int j = base + lane;
    const int key_l = j < N ? lkeys[lrow + j] : 0;
    const int op_l = j < N ? ops[lrow + j] : 0;
    const float par_l = j < N ? params[lrow + j] : 0.0f;
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
      // the masked window sum: +0.0 plus the hit, or the hit alone when
      // the window is one slot wide
      const float cur = has_hit ? (bslots == 1 ? hv : hv + 0.0f) : 0.0f;

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
      resp[lrow + j] = resp_l;
      kinds[lrow + j] = kind_l;
    }
  }
  if (lane == 0) count_out[blockIdx.x] = cnt;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

size_t elim_bytes(int N) { return (size_t)((N + 1) / 2) * sizeof(float); }

}  // namespace

extern "C" {

int dfc_stack_reduce(const void* ops, const void* params, const void* windows,
                     const void* sizes, void* resp, void* kinds, void* segments,
                     void* counts, int S, int N, void* stream) {
  const size_t smem = elim_bytes(N);
  if (int err = set_smem((const void*)stack_kernel, smem)) return err;
  stack_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ops, (const float*)params, (const float*)windows, (const int*)sizes,
      (float*)resp, (int*)kinds, (float*)segments, (int*)counts, N);
  return (int)cudaGetLastError();
}

int dfc_queue_reduce(const void* ops, const void* params, const void* windows,
                     const void* sizes, void* resp, void* kinds, void* segments,
                     void* counts, int S, int N, void* stream) {
  const size_t smem = elim_bytes(N);
  if (int err = set_smem((const void*)queue_kernel, smem)) return err;
  queue_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ops, (const float*)params, (const float*)windows, (const int*)sizes,
      (float*)resp, (int*)kinds, (float*)segments, (int*)counts, N);
  return (int)cudaGetLastError();
}

int dfc_deque_reduce(const void* ops, const void* params, const void* windows_l,
                     const void* windows_r, const void* sizes, void* resp, void* kinds,
                     void* segs_l, void* segs_r, void* counts, int S, int N,
                     void* stream) {
  const size_t smem = elim_bytes(N);
  if (int err = set_smem((const void*)deque_kernel, smem)) return err;
  deque_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ops, (const float*)params, (const float*)windows_l,
      (const float*)windows_r, (const int*)sizes, (float*)resp, (int*)kinds,
      (float*)segs_l, (float*)segs_r, (int*)counts, N);
  return (int)cudaGetLastError();
}

int dfc_map_reduce(const void* mkeys, const void* mvals, const void* mocc,
                   const void* counts_in, const void* lkeys, const void* ops,
                   const void* params, void* keys_out, void* vals_out, void* occ_out,
                   void* count_out, void* resp, void* kinds, int S, int C, int N,
                   int bslots, int n_buckets, void* stream) {
  map_kernel<<<S, kMapThreads, 0, (cudaStream_t)stream>>>(
      (const int*)mkeys, (const float*)mvals, (const int*)mocc, (const int*)counts_in,
      (const int*)lkeys, (const int*)ops, (const float*)params, (int*)keys_out,
      (float*)vals_out, (int*)occ_out, (int*)count_out, (float*)resp, (int*)kinds, C,
      N, bslots, (unsigned)n_buckets);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels for the DFC combining phase.
//
// Four kernels, one per structure kind, each running every shard of a kind
// group in one launch: one thread block per shard (grid = S).  They compute,
// bit for bit, what the plain PyTorch versions in ../ref.py compute.  Plain C
// interface (extern "C", raw pointers, the stream as void*), built by nvcc at
// first use and bound with ctypes by ../kernel.py; every entry point returns
// cudaGetLastError() of its launches.
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
// * Map (dfc_map_reduce: two launches on the caller's stream).  The output
//   contract is the whole table, so the bound is bytes: the 415 MB of a
//   64-shard group at capacity 540,672 read once and written once, 0.25 ms
//   at 3.35 TB/s.  Map ops do not commute, so one shard's live lanes also
//   form a serial chain of dependent bucket probes (some hundreds in the
//   busiest shard at the main path's Zipf-1.1 traffic).  The design splits
//   the two: broadcast_kernel (combine_common.cuh) copies the three table
//   leaves into the output with a grid over every SM, 16-byte streaming
//   loads and stores; then map_kernel, one block per shard, runs map_phase
//   (combine_common.cuh): the block compacts the lanes into shared memory
//   (live lanes only; padding and foreign codes get R_NONE), and warp 0
//   walks them in announcement order with the key's bucket in registers
//   (one slot a lane, ballots for the first hit / free slot, offset 0 when
//   there is none, as the reference's argmax gives it; a run of lanes on one
//   key skips the ballots) and the buckets it touches cached in shared
//   memory, so a probe costs shared-memory latency and not an L2/HBM round
//   trip; a changed bucket is stored into the output row when it is evicted
//   or the walk ends, and the block answers the lanes after the walk.  A hit
//   reads the masked window sum, +0.0 plus the hit (the hit alone for a
//   one-slot window).

#include "combine_common.cuh"

namespace {

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
__global__ void __launch_bounds__(kMapThreads)
map_kernel(const int* __restrict__ counts_in, const int* __restrict__ lkeys,
           const int* __restrict__ ops, const float* __restrict__ params, int* keys_out,
           float* vals_out, int* occ_out, int* count_out, float* resp, int* kinds, int C,
           int N, int bslots, unsigned n_buckets) {
  extern __shared__ __align__(16) unsigned char smem[];
  MapSmem& sm = *reinterpret_cast<MapSmem*>(smem);
  const size_t trow = (size_t)blockIdx.x * C;
  const size_t lrow = (size_t)blockIdx.x * N;
  map_cache_init(sm);
  __syncthreads();
  MapCursor cur;
  cur.cnt = counts_in[blockIdx.x];
  const MapRows rows{keys_out + trow, vals_out + trow, occ_out + trow, 0, 1};
  map_phase<true>(sm, cur, rows, lkeys + lrow, ops + lrow, params + lrow, resp + lrow,
                  kinds + lrow, N, bslots, n_buckets);
  if (threadIdx.x == 0) count_out[blockIdx.x] = cur.cnt;
}

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
  if (int err = set_smem((const void*)map_kernel, sizeof(MapSmem))) return err;
  const Leaves lv{{mkeys, mvals, mocc}, {keys_out, vals_out, occ_out}};
  if (int err = launch_broadcast(lv, 3, (size_t)S * C, 1, (cudaStream_t)stream)) return err;
  map_kernel<<<S, kMapThreads, sizeof(MapSmem), (cudaStream_t)stream>>>(
      (const int*)counts_in, (const int*)lkeys, (const int*)ops, (const float*)params,
      (int*)keys_out, (float*)vals_out, (int*)occ_out, (int*)count_out, (float*)resp,
      (int*)kinds, C, N, bslots, (unsigned)n_buckets);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
//   bound is bytes: each lane's op read once, a param for each push and a
//   window value for each pop the window serves, each lane's response, kind
//   and segment value written once (about 16-20 bytes a lane at the main
//   path's mostly idle lanes).  The TPU kernels route values with one-hot
//   f32 matrix products (an N x N matrix per shard); here lanes are ranked
//   by block-wide prefix sums and values move by indexed stores.  Eliminated pairs meet in a
//   shared-memory buffer of ceil(N/2) floats (n_elim <= N/2 for every kind;
//   the deque's two sides share it, since nl_elim + nr_elim <= N/2); surplus
//   values are stored straight into the output segment row, and routed
//   values are stored as v + 0.0f so that a pushed -0.0 lands as +0.0, as
//   the reference's scatter-add into zeros gives it.  A block's steps
//   depend on each other (the pushes and pops are routed by ranks over the
//   whole row), so what bounds them is the card's bytes in each step plus
//   the chain between them.  Each block loads a tile of 16,384 lanes (the
//   main path's whole row) once into registers (LaneTile: quads of lanes
//   interleaved over the threads, 16-byte loads; a quad's params only if it
//   holds a push), answers every quad with no op of its kind at once
//   (R_NONE with 0.0: most of the row at the main path, whose rows are
//   mostly padding), so those stores overlap the scan, ranks the tile with
//   one block-wide scan (rank_quads: the totals and every quad's base for
//   the pushes and the pops), routes its pushes from the registers, and
//   after one barrier answers the rest from the same registers with 16-byte
//   stores (store_quad).  The segment rows are zeroed whole at the start,
//   beside the loads, and the surplus pushes overwrite their slots.  All
//   three ring kinds run these steps (RingLanes; ring_pushes and
//   ring_answers for the stack and the queue, deque_pushes and
//   deque_answers in combine_common.cuh), and so do the K-phase kernels
//   (phase_grid.cu), which differ only in where a surviving push lands and
//   where a pop past elimination reads.  A row of more tiles is reloaded
//   and re-ranked in each step.  Splitting a row over a cluster
//   of two blocks, so that 128 SMs carry the 64 rows, timed no faster at
//   the main path: the steps are bound by the card's bytes, not one SM's.
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
  __shared__ int sm[kRankInts<2>];
  const size_t row = (size_t)blockIdx.x * N;
  const float* win = windows + row;
  float* seg = segments + row;
  const int size = sizes[blockIdx.x];
  // the segment row is zero past the surplus: zeroed whole first, so these
  // stores overlap the loads and the scan, and the surplus pushes overwrite
  // their slots behind the scan's barriers
  zero_row(seg, N);
  RingLanes<2> rl(ops + row, params + row, resp + row, kinds + row, N, sm);
  int tot[2];
  rl.count(tot);
  const int n_elim = min(tot[0], tot[1]);
  const int n_push_surplus = tot[0] - n_elim;
  // eliminated pushes meet their pops in shared memory; the surplus is
  // rank-compacted into the segment row
  ring_pushes(rl, n_elim, [&](int j, float v) { elim_buf[j] = v; },
              [&](int j, float v) { seg[j] = v; });
  __syncthreads();
  // window[N-1] is the committed top
  ring_answers(rl, n_elim, [&](int j) { return elim_buf[j]; }, size,
               [&](int depth) { return win[N - 1 - depth]; });
  if (threadIdx.x == 0) {
    int* c = counts + (size_t)blockIdx.x * 4;
    c[0] = n_push_surplus;
    c[1] = min(max(tot[1] - n_elim, 0), size);
    c[2] = n_elim;
    c[3] = tot[1];
  }
}

// ------------------------------------------------------------------ queue
__global__ void __launch_bounds__(kThreads)
queue_kernel(const int* __restrict__ ops, const float* __restrict__ params,
             const float* __restrict__ windows, const int* __restrict__ sizes,
             float* resp, int* kinds, float* segments, int* counts, int N) {
  extern __shared__ float elim_buf[];  // enq params by rank < n_elim
  __shared__ int sm[kRankInts<2>];
  const size_t row = (size_t)blockIdx.x * N;
  const float* win = windows + row;
  float* seg = segments + row;
  const int size = sizes[blockIdx.x];
  zero_row(seg, N);  // as the stack's segment row
  RingLanes<2> rl(ops + row, params + row, resp + row, kinds + row, N, sm);
  int tot[2];
  rl.count(tot);
  const int n_from_q = min(tot[1], size);
  const int n_elim = min(max(tot[1] - size, 0), tot[0]);
  const int n_enq_surplus = tot[0] - n_elim;
  // the dequeues past the window pair with the first n_elim enqueues; the
  // surplus is rank-compacted into the segment row
  ring_pushes(rl, n_elim, [&](int j, float v) { elim_buf[j] = v; },
              [&](int j, float v) { seg[j] = v; });
  __syncthreads();
  // window[k] is the k-th committed value from the head
  ring_answers(rl, size, [&](int k) { return win[min(k, N - 1)]; }, n_elim,
               [&](int j) { return elim_buf[j]; });
  if (threadIdx.x == 0) {
    int* c = counts + (size_t)blockIdx.x * 4;
    c[0] = n_enq_surplus;
    c[1] = n_from_q;
    c[2] = n_elim;
    c[3] = tot[1];
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
  __shared__ int sm[kRankInts<4>];
  const size_t row = (size_t)blockIdx.x * N;
  const float* wl = windows_l + row;
  const float* wr = windows_r + row;
  float* sgl = segs_l + row;
  float* sgr = segs_r + row;
  const int size = sizes[blockIdx.x];
  zero_row(sgl, N);  // as the stack's segment row
  zero_row(sgr, N);
  RingLanes<4> rl(ops + row, params + row, resp + row, kinds + row, N, sm);
  int tot[4];
  rl.count(tot);
  const int nl_elim = min(tot[0], tot[1]);
  const int nr_elim = min(tot[2], tot[3]);
  const int sl = tot[0] - nl_elim;
  const int dl = min(tot[1] - nl_elim, size);
  const int size_after = size + sl - dl;
  const int sr = tot[2] - nr_elim;
  const int dr = min(tot[3] - nr_elim, size_after);
  float* buf_r = elim_buf + nl_elim;
  deque_pushes(rl, nl_elim, nr_elim, [&](int j, float v) { elim_buf[j] = v; },
               [&](int j, float v) { buf_r[j] = v; }, [&](int j, float v) { sgl[j] = v; });
  __syncthreads();  // also publishes the seg_l row to the right pops below
  deque_answers(rl, nl_elim, nr_elim, elim_buf, buf_r, size, size_after,
                [&](int j, float v) { sgr[j] = v; },
                [&](int k) { return wl[min(k, N - 1)]; },
                // the committed window first, then this phase's left pushes
                [&](int k) { return k < size ? wr[min(k, N - 1)] : sgl[min(k - size, N - 1)]; });
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

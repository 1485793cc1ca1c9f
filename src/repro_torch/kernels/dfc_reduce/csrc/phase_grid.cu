// Hand-written Hopper (sm_90a) kernels for the fused K-phase combine.
//
// Replaces the JAX package's _phase_grid_combine
// (src/repro/kernels/dfc_reduce/ops.py:482, pallas_call at :565): K combining
// phases of one kind group in ONE call.  On the TPU the grid is (K,): step k
// runs phase k over every shard of the group with the vectorized
// STRUCTS[kind].combine, the shard-stacked state carried in VMEM across the
// sequential grid.  The semantics are those of the vectorized combine
// (../../../core/torch_dfc.py), NOT of the one-phase kernels in
// dfc_reduce.cu: a map hit reads the hit slot's own value (a stored -0.0
// stays -0.0) and ring pops read the committed slots directly.  They
// compute, bit for bit, what ../ref.py phase_grid_combine_ref computes.
// Plain C interface, built by nvcc at first use and bound with ctypes by
// ../kernel.py; every entry point returns cudaGetLastError() of its launches.
//
// What bounds it on this card.  The output contract demands every phase's
// full state: at 256 mixed shards, capacity 540,672 and K = 8, a ring group
// reads its 138 MB state once and writes 8 x 138 MB of per-phase rows, a map
// group 415 MB and 8 x 415 MB, plus about 10-20 MB a phase of ops, params,
// keys, responses and kinds.  So the bound is bytes: 0.41 ms a ring group,
// 1.17 ms the map group at 3.35 TB/s.  The combine itself is a few integer
// ops per lane, and the map's serial lane chain is some hundreds of
// dependent bucket probes a phase in the busiest shard at the main path's
// Zipf-1.1 traffic.
//
// What the design does about it.  Each entry point makes two launches on
// the caller's stream:
//   1. broadcast_kernel (combine_common.cuh), a grid over every SM, reads
//      each 16-byte vector of the input state once and stores it into all K
//      output rows with streaming stores: the bound's state term, and all of
//      the call's bulk bytes;
//   2. the phase kernel, one block per shard (grid = S) looping over the K
//      phases, which writes only what each phase changes.  Stream order
//      gives it the complete broadcast.
// Ring kinds (stack, queue, deque).  A phase holds its lanes in registers
// (RingLanes, combine_common.cuh: quads of lanes interleaved over the
// threads, so every 16-byte load and store of a warp is contiguous; a
// quad's params only if it holds a push; one block-wide scan of per-thread
// counts ranks them), so the counts, the push routing and the responses
// read the ops once, and a quad with no op of the kind is answered as soon
// as it is loaded.  All three ring kinds run the one-phase kernels' steps
// (ring_pushes / ring_answers for the stack and the queue, deque_pushes /
// deque_answers) with their own push stores and pop reads.  A push that
// survives elimination is stored into its slot of rows k..K-1
// (store_forward); a later phase's push to the same slot overwrites rows
// j..K-1 after it, in program order, behind the barrier that ends each
// phase.  So row k-1 holds the input plus every earlier phase's pushes --
// the committed state that pops read -- and the deque's right pops read
// row k, which holds this phase's left pushes.
// Pops clear nothing, so untouched slots cost nothing.  Eliminated pairs
// meet in a shared-memory buffer of ceil(N/2) floats.  Thread 0 writes the
// double-buffered root (the inactive size / ends / count) and the epoch +2,
// or copies them when the phase left the shard untouched (all OP_NONE:
// state and epoch stay, responses are R_NONE with 0.0).
// Map.  map_phase (combine_common.cuh): the block compacts the live lanes
// into shared memory and warp 0 walks only those, in announcement order,
// with the buckets it touches in a shared-memory cache that lives for the
// whole launch (a hot bucket is read from global memory once) and a dirty
// bucket stored into rows k..K-1 when it is evicted or the phase ends.
// Row k of shard s starts at (k*S + s)*cap elements: 2.8e8 at K = 8, S = 64,
// cap = 540,672, so every offset is size_t.

#include "combine_common.cuh"

namespace {

__device__ __forceinline__ int active_slot(int epoch) { return (epoch >> 1) & 1; }
__device__ __forceinline__ int inactive_slot(int epoch) { return ((epoch >> 1) + 1) & 1; }

// floor-mod of a ring position (negative deque counters wrap from the end)
__device__ __forceinline__ size_t ring_slot(long long pos, int cap) {
  long long m = pos % cap;
  return (size_t)(m < 0 ? m + cap : m);
}

// ring_slot(pos + j, cap) for j >= 0, from slot = ring_slot(pos, cap), in
// 32 bits: a 64-bit remainder per lane takes registers that the queue's
// phase kernel does not have to spare (it spilled)
__device__ __forceinline__ size_t ring_after(size_t slot, int j, int cap) {
  const unsigned m = (unsigned)slot + (unsigned)(j % cap);
  return m >= (unsigned)cap ? m - (unsigned)cap : m;
}

// ------------------------------------------------------------------ stack
__global__ void __launch_bounds__(kThreads)
phase_stack_kernel(const float* __restrict__ values_in, const int* __restrict__ size_in,
                   const int* __restrict__ epoch_in, const int* __restrict__ ops,
                   const float* __restrict__ params, float* values_out, int* size_out,
                   int* epoch_out, float* resp, int* kinds, int K, int S, int cap,
                   int N) {
  extern __shared__ float elim_buf[];  // push params by rank < n_elim
  __shared__ int sm[kRankInts<2>];
  const int s = blockIdx.x;
  const size_t stride = (size_t)S * cap;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const float* src = k ? values_out + prev * cap : values_in + (size_t)s * cap;
    const int* src_size = k ? size_out + prev * 2 : size_in + (size_t)s * 2;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    float* dst = values_out + ph * cap;
    const size_t row = ph * N;
    RingLanes<2> rl(ops + row, params + row, resp + row, kinds + row, N, sm);
    int tot[2];
    const int live = __syncthreads_or(rl.count(tot));
    const int old = src_size[active_slot(epoch)];
    const int n_elim = min(tot[0], tot[1]);
    const int n_push_surplus = tot[0] - n_elim;
    // the surplus segment lands at clip(old, 0, cap - N); only the slots in
    // [old, old + n_push_surplus) are kept
    const int start = min(max(old, 0), cap - N);
    ring_pushes(rl, n_elim, [&](int j, float v) { elim_buf[j] = v; },
                [&](int j, float v) {
                  const int pos = start + j;
                  if (pos >= old && pos < old + n_push_surplus)
                    store_forward(dst, stride, K - k, pos, v);
                });
    __syncthreads();
    ring_answers(rl, n_elim, [&](int j) { return elim_buf[j]; }, old,
                 [&](int depth) { return src[min(old - 1 - depth, cap - 1)]; });
    if (threadIdx.x == 0) {
      int* so = size_out + ph * 2;
      so[0] = src_size[0];
      so[1] = src_size[1];
      if (live) {
        const int n_popped = min(max(tot[1] - n_elim, 0), old);
        so[inactive_slot(epoch)] = old + n_push_surplus - n_popped;
      }
      epoch_out[ph] = live ? epoch + 2 : epoch;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ queue
__global__ void __launch_bounds__(kThreads)
phase_queue_kernel(const float* __restrict__ values_in, const int* __restrict__ ends_in,
                   const int* __restrict__ epoch_in, const int* __restrict__ ops,
                   const float* __restrict__ params, float* values_out, int* ends_out,
                   int* epoch_out, float* resp, int* kinds, int K, int S, int cap,
                   int N) {
  extern __shared__ float elim_buf[];  // enq params by rank < n_elim
  __shared__ int sm[kRankInts<2>];
  const int s = blockIdx.x;
  const size_t stride = (size_t)S * cap;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const float* src = k ? values_out + prev * cap : values_in + (size_t)s * cap;
    const int* src_ends = k ? ends_out + prev * 4 : ends_in + (size_t)s * 4;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    float* dst = values_out + ph * cap;
    const size_t row = ph * N;
    RingLanes<2> rl(ops + row, params + row, resp + row, kinds + row, N, sm);
    int tot[2];
    const int live = __syncthreads_or(rl.count(tot));
    const int a = active_slot(epoch);
    const long long head = src_ends[2 * a], tail = src_ends[2 * a + 1];
    const long long size = tail - head;
    const long long n_from_q = min((long long)tot[1], size);
    const int n_elim = (int)min(max((long long)tot[1] - size, 0LL), (long long)tot[0]);
    const int n_enq_surplus = tot[0] - n_elim;
    const size_t head_slot = ring_slot(head, cap), tail_slot = ring_slot(tail, cap);
    // enqueue j of the surplus lands at tail + j
    ring_pushes(rl, n_elim, [&](int j, float v) { elim_buf[j] = v; },
                [&](int j, float v) {
                  store_forward(dst, stride, K - k, ring_after(tail_slot, j, cap), v);
                });
    __syncthreads();
    // the committed slots from the head: row k-1
    ring_answers(rl, size, [&](int j) { return src[ring_after(head_slot, j, cap)]; }, n_elim,
                 [&](int j) { return elim_buf[j]; });
    if (threadIdx.x == 0) {
      int* eo = ends_out + ph * 4;
      for (int j = 0; j < 4; ++j) eo[j] = src_ends[j];
      if (live) {
        const int ia = inactive_slot(epoch);
        eo[2 * ia] = (int)(head + n_from_q);
        eo[2 * ia + 1] = (int)(tail + n_enq_surplus);
      }
      epoch_out[ph] = live ? epoch + 2 : epoch;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ deque
__global__ void __launch_bounds__(kThreads)
phase_deque_kernel(const float* __restrict__ values_in, const int* __restrict__ ends_in,
                   const int* __restrict__ epoch_in, const int* __restrict__ ops,
                   const float* __restrict__ params, float* values_out, int* ends_out,
                   int* epoch_out, float* resp, int* kinds, int K, int S, int cap,
                   int N) {
  // [0, nl_elim): pushL params by rank; [nl_elim, nl_elim + nr_elim): pushR
  extern __shared__ float elim_buf[];
  __shared__ int sm[kRankInts<4>];
  const int s = blockIdx.x;
  const size_t stride = (size_t)S * cap;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const float* src = k ? values_out + prev * cap : values_in + (size_t)s * cap;
    const int* src_ends = k ? ends_out + prev * 4 : ends_in + (size_t)s * 4;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    float* dst = values_out + ph * cap;
    const size_t row = ph * N;
    RingLanes<4> rl(ops + row, params + row, resp + row, kinds + row, N, sm);
    int tot[4];
    const int live = __syncthreads_or(rl.count(tot));
    const int a = active_slot(epoch);
    const long long left = src_ends[2 * a], right = src_ends[2 * a + 1];
    const long long size = right - left;
    const int nl_elim = min(tot[0], tot[1]), nr_elim = min(tot[2], tot[3]);
    const long long sl = tot[0] - nl_elim, tl = tot[1] - nl_elim;
    const long long sr = tot[2] - nr_elim, tr = tot[3] - nr_elim;
    const long long dl = min(tl, size);
    const long long size_after = size + sl - dl;
    const long long dr = min(tr, size_after);
    float* buf_r = elim_buf + nl_elim;
    // left push j of the surplus lands at left-1-j, right push j at right+j
    // (after the barrier: the reference applies the right side after the left)
    deque_pushes(rl, nl_elim, nr_elim, [&](int j, float v) { elim_buf[j] = v; },
                 [&](int j, float v) { buf_r[j] = v; },
                 [&](int j, float v) {
                   store_forward(dst, stride, K - k, ring_slot(left - 1 - j, cap), v);
                 });
    __syncthreads();  // row k now holds this phase's left pushes
    // a phase with right surplus pushes has no right surplus pops
    deque_answers(rl, nl_elim, nr_elim, elim_buf, buf_r, size, size_after,
                  [&](int j, float v) {
                    store_forward(dst, stride, K - k, ring_slot(right + j, cap), v);
                  },
                  [&](int j) { return src[ring_slot(left + j, cap)]; },
                  // committed slots first, then this phase's left pushes
                  [&](int j) { return dst[ring_slot(right - 1 - j, cap)]; });
    if (threadIdx.x == 0) {
      int* eo = ends_out + ph * 4;
      for (int j = 0; j < 4; ++j) eo[j] = src_ends[j];
      if (live) {
        const int ia = inactive_slot(epoch);
        eo[2 * ia] = (int)(left - sl + dl);
        eo[2 * ia + 1] = (int)(right + sr - dr);
      }
      epoch_out[ph] = live ? epoch + 2 : epoch;
    }
    __syncthreads();
  }
}

// -------------------------------------------------------------------- map
__global__ void __launch_bounds__(kMapThreads)
phase_map_kernel(const int* __restrict__ count_in, const int* __restrict__ epoch_in,
                 const int* __restrict__ lkeys, const int* __restrict__ ops,
                 const float* __restrict__ params, int* keys_out, float* vals_out,
                 int* occ_out, int* count_out, int* epoch_out, float* resp, int* kinds,
                 int K, int S, int C, int N, int bslots, unsigned n_buckets) {
  extern __shared__ __align__(16) unsigned char smem[];
  MapSmem& sm = *reinterpret_cast<MapSmem*>(smem);
  const int s = blockIdx.x;
  map_cache_init(sm);
  __syncthreads();
  MapCursor cur;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const int* src_count = k ? count_out + prev * 2 : count_in + (size_t)s * 2;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    const MapRows rows{keys_out + ph * C, vals_out + ph * C, occ_out + ph * C,
                       (size_t)S * C, K - k};
    cur.cnt = src_count[active_slot(epoch)];
    const size_t row = ph * N;
    const int live = map_phase<false>(sm, cur, rows, lkeys + row, ops + row, params + row,
                                      resp + row, kinds + row, N, bslots, n_buckets);
    if (threadIdx.x == 0) {
      int* co = count_out + ph * 2;
      co[0] = src_count[0];
      co[1] = src_count[1];
      if (live) co[inactive_slot(epoch)] = cur.cnt;
      epoch_out[ph] = live ? epoch + 2 : epoch;
    }
    __syncthreads();
  }
}

template <typename Kernel>
int launch_ring(Kernel kernel, const void* values_in, const void* root_in,
                const void* epoch_in, const void* ops, const void* params,
                void* values_out, void* root_out, void* epoch_out, void* resp,
                void* kinds, int K, int S, int cap, int N, void* stream) {
  const size_t smem = elim_bytes(N);
  if (int err = set_smem((const void*)kernel, smem)) return err;
  const Leaves lv{{values_in, nullptr, nullptr}, {values_out, nullptr, nullptr}};
  if (int err = launch_broadcast(lv, 1, (size_t)S * cap, K, (cudaStream_t)stream))
    return err;
  kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values_in, (const int*)root_in, (const int*)epoch_in,
      (const int*)ops, (const float*)params, (float*)values_out, (int*)root_out,
      (int*)epoch_out, (float*)resp, (int*)kinds, K, S, cap, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ring kinds: values f32[S,cap], root (stack size i32[S,2] / ends i32[S,2,2]),
// epoch i32[S]; ops i32[K,S,N], params f32[K,S,N] -> values f32[K,S,cap],
// root [K,...], epoch i32[K,S], resp f32[K,S,N], kinds i32[K,S,N]
int dfc_phase_stack(const void* values_in, const void* size_in, const void* epoch_in,
                    const void* ops, const void* params, void* values_out,
                    void* size_out, void* epoch_out, void* resp, void* kinds, int K,
                    int S, int cap, int N, void* stream) {
  return launch_ring(phase_stack_kernel, values_in, size_in, epoch_in, ops, params,
                     values_out, size_out, epoch_out, resp, kinds, K, S, cap, N, stream);
}

int dfc_phase_queue(const void* values_in, const void* ends_in, const void* epoch_in,
                    const void* ops, const void* params, void* values_out,
                    void* ends_out, void* epoch_out, void* resp, void* kinds, int K,
                    int S, int cap, int N, void* stream) {
  return launch_ring(phase_queue_kernel, values_in, ends_in, epoch_in, ops, params,
                     values_out, ends_out, epoch_out, resp, kinds, K, S, cap, N, stream);
}

int dfc_phase_deque(const void* values_in, const void* ends_in, const void* epoch_in,
                    const void* ops, const void* params, void* values_out,
                    void* ends_out, void* epoch_out, void* resp, void* kinds, int K,
                    int S, int cap, int N, void* stream) {
  return launch_ring(phase_deque_kernel, values_in, ends_in, epoch_in, ops, params,
                     values_out, ends_out, epoch_out, resp, kinds, K, S, cap, N, stream);
}

// map: tables i32/f32/i32[S,C], count i32[S,2], epoch i32[S]; lane keys/ops
// i32[K,S,N], params f32[K,S,N] -> tables [K,S,C], count i32[K,S,2], epoch
// i32[K,S], resp f32[K,S,N], kinds i32[K,S,N]
int dfc_phase_map(const void* keys_in, const void* vals_in, const void* occ_in,
                  const void* count_in, const void* epoch_in, const void* lkeys,
                  const void* ops, const void* params, void* keys_out, void* vals_out,
                  void* occ_out, void* count_out, void* epoch_out, void* resp,
                  void* kinds, int K, int S, int C, int N, int bslots, int n_buckets,
                  void* stream) {
  if (int err = set_smem((const void*)phase_map_kernel, sizeof(MapSmem))) return err;
  const Leaves lv{{keys_in, vals_in, occ_in}, {keys_out, vals_out, occ_out}};
  if (int err = launch_broadcast(lv, 3, (size_t)S * C, K, (cudaStream_t)stream))
    return err;
  phase_map_kernel<<<S, kMapThreads, sizeof(MapSmem), (cudaStream_t)stream>>>(
      (const int*)count_in, (const int*)epoch_in, (const int*)lkeys, (const int*)ops,
      (const float*)params, (int*)keys_out, (float*)vals_out, (int*)occ_out,
      (int*)count_out, (int*)epoch_out, (float*)resp, (int*)kinds, K, S, C, N, bslots,
      (unsigned)n_buckets);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels for the fused K-phase combine.
//
// Replaces the JAX package's _phase_grid_combine
// (src/repro/kernels/dfc_reduce/ops.py:482, pallas_call at :565): K combining
// phases of one kind group in ONE launch.  On the TPU the grid is (K,): step
// k runs phase k over every shard of the group with the vectorized
// STRUCTS[kind].combine, the shard-stacked state carried in VMEM across the
// sequential grid.  Here the grid is one thread block per SHARD (grid = S),
// and the K phases are a loop inside the block: shards never read each
// other's state, so nothing crosses blocks.  The semantics are those of the
// vectorized combine (../../../core/torch_dfc.py), NOT of the one-phase
// kernels in dfc_reduce.cu: a map hit reads the hit slot's own value (a
// stored -0.0 stays -0.0) and ring pops read the committed slots directly.
// They compute, bit for bit, what ../ref.py phase_grid_combine_ref computes.
// Plain C interface, built by nvcc at first use and bound with ctypes by
// ../kernel.py; every entry point returns cudaGetLastError() of its launch.
//
// Working state.  A full-width shard row (2.16 MB for a ring kind, 6.5 MB for
// a map at capacity 540,672) does not fit in 227 KB of shared memory, so the
// working state is the block's own OUTPUT row.  For phase k the block
//   1. copies row k-1 (the input state at k = 0) into row k with 16-byte
//      loads, then __syncthreads();
//   2. counts the phase's ops with block-wide ballot ranks (tile_rank) --
//      which also tells whether the shard is touched at all;
//   3. routes pushes by rank: eliminated ones into a shared-memory buffer of
//      ceil(N/2) floats, the surplus straight into row k at its ring slot;
//   4. writes responses and kinds, reading pops from row k-1 (the committed
//      state; the deque's right pops read row k, which already holds this
//      phase's left pushes, as the vectorized combine reads them);
//   5. thread 0 writes the double-buffered root (the inactive size / ends /
//      count) and the epoch +2 -- or copies them when the phase left the
//      shard untouched (all OP_NONE: state and epoch stay, responses are
//      R_NONE with 0.0);
//   6. __syncthreads(), so phase k+1 reads a complete row k.
// Row k of shard s starts at (k*S + s)*cap elements: 2.8e8 at K = 8, S = 64,
// cap = 540,672, so every offset is size_t.
//
// What bounds it on this card.  The output contract demands every phase's
// full state: at 256 mixed shards, capacity 540,672 and K = 8 the kernel
// reads the 0.83 GB input state once and writes 8 x 0.83 GB of per-phase
// states, plus about 84 MB a phase of ops, params, keys, responses and
// kinds: about 8.1 GB, 2.4 ms at 3.35 TB/s (0.30 ms a phase).  Bytes, not
// operations: the combine is a few integer ops per lane.  This first
// version copies each row with one block per shard (64 blocks per kind
// group) and is simple rather than fast.

#include "combine_common.cuh"

namespace {

__device__ __forceinline__ int active_slot(int epoch) { return (epoch >> 1) & 1; }
__device__ __forceinline__ int inactive_slot(int epoch) { return ((epoch >> 1) + 1) & 1; }

// floor-mod of a ring position (negative deque counters wrap from the end)
__device__ __forceinline__ size_t ring_slot(long long pos, int cap) {
  long long m = pos % cap;
  return (size_t)(m < 0 ? m + cap : m);
}

// ------------------------------------------------------------------ stack
__global__ void __launch_bounds__(kThreads)
phase_stack_kernel(const float* __restrict__ values_in, const int* __restrict__ size_in,
                   const int* __restrict__ epoch_in, const int* __restrict__ ops,
                   const float* __restrict__ params, float* values_out, int* size_out,
                   int* epoch_out, float* resp, int* kinds, int K, int S, int cap,
                   int N) {
  extern __shared__ float elim_buf[];  // push params by rank < n_elim
  __shared__ int sm[3 * 32];
  const int s = blockIdx.x;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const float* src = k ? values_out + prev * cap : values_in + (size_t)s * cap;
    const int* src_size = k ? size_out + prev * 2 : size_in + (size_t)s * 2;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    float* dst = values_out + ph * cap;
    copy_row(src, dst, cap);
    __syncthreads();
    const size_t row = ph * N;
    const int* op = ops + row;
    const float* par = params + row;

    int p_total = 0, q_total = 0, live = 0;
    for (int base = 0; base < N; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int o = i < N ? op[i] : 0;
      const bool f[3] = {o == OP_PUSH, o == OP_POP, o != 0};
      int r[3], t[3];
      tile_rank<3>(f, r, t, sm);
      p_total += t[0];
      q_total += t[1];
      live += t[2];
    }
    const int old = src_size[active_slot(epoch)];
    const int n_elim = min(p_total, q_total);
    const int n_push_surplus = p_total - n_elim;
    // the surplus segment lands at clip(old, 0, cap - N); only the slots in
    // [old, old + n_push_surplus) are kept
    const int start = min(max(old, 0), cap - N);

    int carry = 0;
    for (int base = 0; base < N; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int o = i < N ? op[i] : 0;
      const bool f[1] = {o == OP_PUSH};
      int r[1], t[1];
      tile_rank<1>(f, r, t, sm);
      if (f[0]) {
        const int rk = carry + r[0];
        const float v = par[i] + 0.0f;  // routed -0.0 lands as +0.0
        if (rk < n_elim) {
          elim_buf[rk] = v;
        } else {
          const int pos = start + rk - n_elim;
          if (pos >= old && pos < old + n_push_surplus) dst[pos] = v;
        }
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
            const int src_pos = old - 1 - (rk - n_elim);
            if (src_pos >= 0) {
              kind = R_VALUE;
              v = src[min(src_pos, cap - 1)];
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
      int* so = size_out + ph * 2;
      so[0] = src_size[0];
      so[1] = src_size[1];
      if (live) {
        const int n_popped = min(max(q_total - n_elim, 0), old);
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
  __shared__ int sm[3 * 32];
  const int s = blockIdx.x;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const float* src = k ? values_out + prev * cap : values_in + (size_t)s * cap;
    const int* src_ends = k ? ends_out + prev * 4 : ends_in + (size_t)s * 4;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    float* dst = values_out + ph * cap;
    copy_row(src, dst, cap);
    __syncthreads();
    const size_t row = ph * N;
    const int* op = ops + row;
    const float* par = params + row;

    int p_total = 0, q_total = 0, live = 0;
    for (int base = 0; base < N; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int o = i < N ? op[i] : 0;
      const bool f[3] = {o == OP_PUSH, o == OP_POP, o != 0};
      int r[3], t[3];
      tile_rank<3>(f, r, t, sm);
      p_total += t[0];
      q_total += t[1];
      live += t[2];
    }
    const int a = active_slot(epoch);
    const long long head = src_ends[2 * a], tail = src_ends[2 * a + 1];
    const long long size = tail - head;
    const long long n_from_q = min((long long)q_total, size);
    const long long n_elim = min(max((long long)q_total - size, 0LL), (long long)p_total);
    const long long n_enq_surplus = p_total - n_elim;

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
        if (rk < n_elim) elim_buf[rk] = v;
        else dst[ring_slot(tail + rk - n_elim, cap)] = v;  // appended at the tail
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
          const long long rk = carry + r[0];
          if (rk < size) {  // served FIFO from the committed ring
            kind = R_VALUE;
            v = src[ring_slot(head + rk, cap)];
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
  __shared__ int sm[5 * 32];
  const int s = blockIdx.x;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const float* src = k ? values_out + prev * cap : values_in + (size_t)s * cap;
    const int* src_ends = k ? ends_out + prev * 4 : ends_in + (size_t)s * 4;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    float* dst = values_out + ph * cap;
    copy_row(src, dst, cap);
    __syncthreads();
    const size_t row = ph * N;
    const int* op = ops + row;
    const float* par = params + row;

    int npl = 0, nql = 0, npr = 0, nqr = 0, live = 0;
    for (int base = 0; base < N; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int o = i < N ? op[i] : 0;
      const bool f[5] = {o == OP_PUSHL, o == OP_POPL, o == OP_PUSHR, o == OP_POPR,
                         o != 0};
      int r[5], t[5];
      tile_rank<5>(f, r, t, sm);
      npl += t[0];
      nql += t[1];
      npr += t[2];
      nqr += t[3];
      live += t[4];
    }
    const int a = active_slot(epoch);
    const long long left = src_ends[2 * a], right = src_ends[2 * a + 1];
    const long long size = right - left;
    const int nl_elim = min(npl, nql), nr_elim = min(npr, nqr);
    const long long sl = npl - nl_elim, tl = nql - nl_elim;
    const long long sr = npr - nr_elim, tr = nqr - nr_elim;
    const long long dl = min(tl, size);
    const long long size_after = size + sl - dl;
    const long long dr = min(tr, size_after);
    float* buf_l = elim_buf;
    float* buf_r = elim_buf + nl_elim;

    // left pushes (and both sides' eliminated pushes): push j of the left
    // surplus lands at left-1-j
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
        if (rk < nl_elim) buf_l[rk] = v;
        else dst[ring_slot(left - 1 - (rk - nl_elim), cap)] = v;
      } else if (f[1]) {
        const int rk = cr + r[1];
        if (rk < nr_elim) buf_r[rk] = par[i] + 0.0f;
      }
      cl += t[0];
      cr += t[1];
    }
    __syncthreads();  // row k now holds this phase's left pushes

    // responses; right surplus pushes land at right+j after the left ones
    // (a phase with right surplus pushes has no right surplus pops)
    int ql = 0, qr = 0, pr = 0;
    for (int base = 0; base < N; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int o = i < N ? op[i] : 0;
      const bool f[3] = {o == OP_POPL, o == OP_POPR, o == OP_PUSHR};
      int r[3], t[3];
      tile_rank<3>(f, r, t, sm);
      if (i < N) {
        int kind = R_NONE;
        float v = 0.0f;
        if (o == OP_PUSHL) {
          kind = R_ACK;
        } else if (f[2]) {
          kind = R_ACK;
          const int rk = pr + r[2];
          if (rk >= nr_elim)
            dst[ring_slot(right + (rk - nr_elim), cap)] = par[i] + 0.0f;
        } else if (f[0]) {
          const int rk = ql + r[0];
          if (rk < nl_elim) {
            kind = R_VALUE;
            v = buf_l[rk];
          } else if (rk - nl_elim < size) {
            kind = R_VALUE;
            v = src[ring_slot(left + (rk - nl_elim), cap)];
          } else {
            kind = R_EMPTY;
          }
        } else if (f[1]) {
          const int rk = qr + r[1];
          if (rk < nr_elim) {
            kind = R_VALUE;
            v = buf_r[rk];
          } else if (rk - nr_elim < size_after) {
            // committed slots first, then this phase's left pushes
            kind = R_VALUE;
            v = dst[ring_slot(right - 1 - (rk - nr_elim), cap)];
          } else {
            kind = R_EMPTY;
          }
        }
        resp[row + i] = v;
        kinds[row + i] = kind;
      }
      ql += t[0];
      qr += t[1];
      pr += t[2];
    }
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
phase_map_kernel(const int* __restrict__ keys_in, const float* __restrict__ vals_in,
                 const int* __restrict__ occ_in, const int* __restrict__ count_in,
                 const int* __restrict__ epoch_in, const int* __restrict__ lkeys,
                 const int* __restrict__ ops, const float* __restrict__ params,
                 int* keys_out, float* vals_out, int* occ_out, int* count_out,
                 int* epoch_out, float* resp, int* kinds, int K, int S, int C, int N,
                 int bslots, unsigned n_buckets) {
  const int s = blockIdx.x;
  for (int k = 0; k < K; ++k) {
    const size_t ph = (size_t)k * S + s, prev = ph - S;
    const size_t src_row = k ? prev * C : (size_t)s * C;
    const int* src_count = k ? count_out + prev * 2 : count_in + (size_t)s * 2;
    const int epoch = k ? epoch_out[prev] : epoch_in[s];
    int* tk = keys_out + ph * C;
    float* tv = vals_out + ph * C;
    int* to = occ_out + ph * C;
    copy_row(k ? keys_out + src_row : keys_in + src_row, tk, C);
    copy_row(k ? vals_out + src_row : vals_in + src_row, tv, C);
    copy_row(k ? occ_out + src_row : occ_in + src_row, to, C);
    const size_t row = ph * N;
    int any = 0;
    for (int i = threadIdx.x; i < N; i += blockDim.x) any |= ops[row + i] != 0;
    const int live = __syncthreads_or(any);  // also publishes the row copies
    if (threadIdx.x < 32) {  // the serial lane chain is one warp's
      const int cnt = map_walk<false>(tk, tv, to, lkeys + row, ops + row, params + row,
                                      resp + row, kinds + row, N, bslots, n_buckets,
                                      src_count[active_slot(epoch)]);
      if (threadIdx.x == 0) {
        int* co = count_out + ph * 2;
        co[0] = src_count[0];
        co[1] = src_count[1];
        if (live) co[inactive_slot(epoch)] = cnt;
        epoch_out[ph] = live ? epoch + 2 : epoch;
      }
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
  phase_map_kernel<<<S, kMapThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys_in, (const float*)vals_in, (const int*)occ_in,
      (const int*)count_in, (const int*)epoch_in, (const int*)lkeys, (const int*)ops,
      (const float*)params, (int*)keys_out, (float*)vals_out, (int*)occ_out,
      (int*)count_out, (int*)epoch_out, (float*)resp, (int*)kinds, K, S, C, N, bslots,
      (unsigned)n_buckets);
  return (int)cudaGetLastError();
}

}  // extern "C"

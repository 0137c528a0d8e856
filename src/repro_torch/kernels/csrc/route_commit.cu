// route_commit for Hopper (sm_90a): fused score -> route -> queue-commit of
// one arrival batch, with sequential conflict resolution inside the batch.
//
// Replaces the Pallas TPU kernels src/repro/kernels/route_commit.py
// `_kernel_full` (Balanced-Pandas, argmin over all M servers) and
// `_kernel_pod` (Balanced-Pandas-Pod, argmin over C candidates).
// Same function as the plain version route_commit_ref
// (src/repro_torch/kernels/ref.py):
//
//   W0[m] = (q0*i0 + q1*i1) + q2*i2      finite inverse rates (dead -> 0)
//   n_proc = 1 + the last b with valid[b]        (0 if none is valid)
//   for b in 0..n_proc-1, in order:
//     score[m] = (W0[m] + dW[m]) * inv[m, cls]   (+inf if dead / cls >= 3)
//     pick the least (score, rank); rank is the exact integer tie lane
//       full: (cls*M + prio)*M + m      pod: cls*C + slot + (1-valid)*4C
//     if valid[b]: dW[sel] += inv[sel, sel_cls]; Q[sel, sel_cls] += 1
//   arrivals n_proc..B-1 commit nothing: each takes the same argmin against
//   the final W0 + dW, all of them at once
//
// Bound: a dependent chain of n_proc steps, not bytes (the byte bound is
// three orders of magnitude lower).  A step costs one block barrier and
// four `redux.sync` (full) or two (pod), and waits on no device memory;
// in the full variant it also rescores every server, so from about a
// thousand servers up a step is bound by one SM's instruction issue (the
// batch is one CTA: a cluster-wide barrier costs more than the step).
// What keeps work off the chain:
//   - n_proc is a block-wide max over `valid`, on the device: the chain
//     stops at the last valid arrival, and the tail (arrivals n_proc..B-1)
//     is scored in parallel, one warp a row, against the final workloads.
//   - a warp's lexicographic (score, rank) minimum is two `redux.sync`
//     (scores are >= 0 or +inf, so their f32 bits order as uint32): the
//     minimum score bits, then the minimum rank among the lanes that hold
//     that score.
//   - full: one CTA of up to 1024 threads; server m has one owner thread,
//     m = tid + k*blockDim.  A step: score the owned servers into one u64
//     (score bits, rank) key, reduce in the warp, write the warp's key into
//     a slot double-buffered by arrival parity, ONE __syncthreads, then
//     every warp reduces the <= 32 slots itself and knows the winner.  The
//     thread whose own key is the winner owns the pick: it writes the
//     outputs, adds the commit to its own dW entry (no other thread reads
//     it) and the Q increment with a fire-and-forget atomic.  A warp can
//     write slot b&1 again (arrival b+2) only after barrier b+1, which every
//     warp reaches only after it has read arrival b's slots, so one barrier
//     a step is enough.
//   - full, rank lanes: (cls << 30) | (prio << 15) | m orders as the
//     reference's (cls*M + prio)*M + m (M <= 32768), and the pick's server
//     and class come back with a mask and a shift, not a division.  Dead
//     rates and class >= 3 enter as a rate of +inf and the score bits are
//     clamped to +inf (umin), which also maps 0 * inf = NaN to +inf.
//   - full, cls stream: the classes of arrival b+1 for a thread's first
//     kPrefetch servers are loaded into registers while arrival b is scored
//     and reduced (a register double buffer), so the step does not wait on
//     device memory up to M = kPrefetch * 1024 = 6144 (M = 500 and 5000 on
//     the main path); servers beyond that load their class in the step.
//     kPrefetch = 6 is the most that fits the 64 registers a thread has at
//     1024 threads without spilling (ptxas -v: 7 spills, 8 spills more).
//     Registers, not a shared-memory ring: at the largest M the wrapper
//     accepts, (W0, dW) fill shared memory, and a ring would need a second
//     code path.  The owner of server tid keeps its (W0, dW) in registers,
//     the rest sit in shared memory, which leaves room for the slots at
//     every accepted M.  After the chain the final W goes to shared memory
//     too, and the tail runs one warp a row, so the rows' class loads are
//     in flight together; a lane issues kTailUnroll loads before it scores.
//     (All threads on one row at a time, with W kept in registers, was
//     slower: each row then waits for its own loads.)
//   - pod: in a prologue every thread stages the candidate rows in shared
//     memory, 16 bytes a slot: server index (bit 31 = slot invalid), class,
//     the candidate's W0 (computed from its Q row, by the same formula, so
//     duplicates agree) and its finite rate (sign bit = scores +inf), and
//     zeroes dW[M] in shared memory.  Warp 0 then walks the chain from
//     shared memory only (one lane a candidate, two redux.sync, the winning
//     lane commits to dW) while the other warps compute W0 and copy Q for
//     all M servers; after a barrier the committed Q increments are
//     applied, committed servers get W0 + dW, and the tail scores its rows
//     from the staging area where they are.  Rows that do not fit are
//     staged chunk by chunk; slots beyond what fits of one row are built
//     from device memory in the step.

// Cells: a launch routes the batches of N independent cells (grid cells of
// the simulator), one CTA a cell (gridDim.x = N).  blockIdx.x selects the
// cell's operands by their cell strides; an operand every cell shares (the
// [3] or [M, 3] rates, BP-Pod's candidate classes, batched JSQ's all-valid
// mask) has a cell stride of 0.  Inside a CTA the work is the one-cell
// kernel's, unchanged; the outputs of cell n start at n * (their one-cell
// size).  At M = 5000 the full variant is one CTA of 1024 threads an SM, so
// 132 cells are one wave and more cells run in further waves.
//
// Parity: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction) in the reference's order, and W0 and dW are kept apart
// (score = (W0 + dW) * inv, W_new = W0 + dW), so exact lattice ties break
// the same way as in the plain version.
//
// Rates operand: `inv` is the [3] or [M, 3] float32 inverse-rate operand
// itself (inv_stride 0 or 3).  A non-finite entry is dead: it scores +inf
// and contributes 0 workload -- the split kernels/invrates.py encodes, done
// here per element, so the wrapper launches nothing to prepare it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kNone = 0xffffffffu;      // (score, rank) of no entry
constexpr uint32_t kInfBits = 0x7f800000u;   // +inf
constexpr uint32_t kBadBit = 0x80000000u;
constexpr int kPrefetch = 6;                 // full: prefetched strip entries
constexpr int kTailUnroll = 8;               // full: tail servers a lane loads at once
constexpr int kSmemLimit = 232448;           // bytes of shared memory a block may use

// The finite part of an inverse rate: dead (non-finite) entries give 0.
__device__ __forceinline__ float finite_rate(float r) {
  return isfinite(r) ? r : 0.0f;
}

// The rate column a class reads: 0 and 1 their own, any other 2.
__device__ __forceinline__ int rate_lane(int c) { return c < 2 ? c : 2; }

// W0 = sum_c Q[m,c] * finite_inv[m,c] in the pinned order.
__device__ __forceinline__ float workload(const int* __restrict__ q,
                                          const float* __restrict__ r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(q[0]), finite_rate(r[0])),
                             __fmul_rn(static_cast<float>(q[1]), finite_rate(r[1]))),
                   __fmul_rn(static_cast<float>(q[2]), finite_rate(r[2])));
}

// The warp's lexicographic (score bits, rank) minimum, in every lane.
__device__ __forceinline__ void warp_lexmin(uint32_t& s, uint32_t& r) {
  const uint32_t smin = __reduce_min_sync(0xffffffffu, s);
  r = __reduce_min_sync(0xffffffffu, s == smin ? r : kNone);
  s = smin;
}

// 1 + the last b with valid[b], over the block (0 if none): each thread's
// part, reduced in the warp.  The caller publishes it and reduces again.
__device__ __forceinline__ uint32_t last_valid_part(const uint8_t* __restrict__ valid,
                                                    int B) {
  uint32_t n = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    if (valid[b]) n = static_cast<uint32_t>(b) + 1;
  return __reduce_max_sync(0xffffffffu, n);
}

// ---------------------------------------------------------------------------
// full: argmin over all M servers
// ---------------------------------------------------------------------------

struct FullArgs {
  const int* __restrict__ Q;
  const uint8_t* __restrict__ valid;
  const float* __restrict__ inv;
  const int* __restrict__ cls;
  const int* __restrict__ prio;
  int M, B;
  int* __restrict__ Qn;
  float* __restrict__ Wn;
  int* __restrict__ sel;
  int* __restrict__ selcls;
  float* __restrict__ val;
  long long sQ, sValid, sInv, sCls, sPrio;   // cell strides (elements)
};

// The operands of this CTA's cell.
__device__ __forceinline__ FullArgs cell_of(FullArgs a) {
  const long long n = blockIdx.x;
  a.Q += n * a.sQ;
  a.valid += n * a.sValid;
  a.inv += n * a.sInv;
  a.cls += n * a.sCls;
  if (a.prio) a.prio += n * a.sPrio;
  a.Qn += n * 3 * a.M;
  a.Wn += n * a.M;
  a.sel += n * a.B;
  a.selcls += n * a.B;
  a.val += n * a.B;
  return a;
}

// Rank lanes of the full variant: (cls << 30) | (prio << 15) | m orders as
// the reference's (cls*M + prio)*M + m for M <= 32768 and cls <= 3, and
// gives the pick's server and class back with a mask and a shift.
constexpr uint32_t kServerMask = 0x7fffu;
constexpr uint32_t kNoBase = 0x3fffffffu;   // with class 3: the rank kNone

__device__ __forceinline__ unsigned long long key_of(uint32_t score, uint32_t rank) {
  return (static_cast<unsigned long long>(score) << 32) | rank;
}

// (W0 + dW) * r as ordered bits, +inf where r is +inf or non-finite (a
// dead rate or a class >= 3): umin clamps +inf, NaN and -inf to +inf.
__device__ __forceinline__ uint32_t score_bits(float w0, float dw, float r) {
  return min(__float_as_uint(__fmul_rn(__fadd_rn(w0, dw), r)), kInfBits);
}

// The rate server m's class c scores with: +inf for class >= 3; the [3]
// operand from the block's rate table, the [M, 3] one from device memory.
template <bool kHomo>
__device__ __forceinline__ float score_rate(const FullArgs& a, const float* hr, int m,
                                            int c) {
  const uint32_t uc = static_cast<uint32_t>(c);
  if (kHomo) return hr[min(uc, 3u)];
  const float r = __ldg(a.inv + 3 * static_cast<long>(m) + min(uc, 2u));
  return uc > 2 ? __int_as_float(kInfBits) : r;
}

template <bool kHomo>
__global__ void __launch_bounds__(1024, 1) route_commit_full_kernel(FullArgs cells) {
  const FullArgs a = cell_of(cells);
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* slots = reinterpret_cast<uint2*>(smem);          // [2][32] by parity
  float* hr = reinterpret_cast<float*>(smem + 512);       // [4] class -> rate
  float* wf = hr + 4;                                     // [T]
  float2* wd = reinterpret_cast<float2*>(wf + blockDim.x);
  // wd[m - T] = (W0, dW) of server m >= T; server tid's pair is in
  // registers; after the chain wf[m] / wd[m - T].x hold the final W

  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  const int M = a.M, B = a.B;
  const int kmax = (M + T - 1) / T;       // entries a thread owns, at most
  const int stride = kHomo ? 0 : 3;

  // prologue: W0, Qn = Q, the rate table, the strip's rank bases,
  // arrival 0's classes
  if (kHomo && tid < 4) {
    const float r = tid < 3 ? a.inv[tid] : 0.0f;
    hr[tid] = tid < 3 && isfinite(r) ? r : __int_as_float(kInfBits);
  }
  float w0 = 0.0f, dw = 0.0f;
#pragma unroll 4
  for (int m = tid; m < M; m += T) {
    const float w = workload(a.Q + 3 * m, a.inv + static_cast<long>(m) * stride);
    if (m == tid) w0 = w;
    else wd[m - T] = make_float2(w, 0.0f);
    a.Qn[3 * m] = a.Q[3 * m];
    a.Qn[3 * m + 1] = a.Q[3 * m + 1];
    a.Qn[3 * m + 2] = a.Q[3 * m + 2];
  }
  uint32_t base[kPrefetch];   // (prio << 15) | m; kNoBase past M
  int cnext[kPrefetch];       // classes of the next arrival; 3 past M
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {       // loads first, all in flight
    const int m = min(tid + k * T, M - 1);
    base[k] = a.prio ? static_cast<uint32_t>(__ldg(a.prio + m)) : static_cast<uint32_t>(m);
    cnext[k] = B > 0 ? __ldg(a.cls + m) : 3;
  }
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int m = tid + k * T;
    const bool in = k < kmax && m < M;
    base[k] = in ? (base[k] << 15) | static_cast<uint32_t>(m) : kNoBase;
    cnext[k] = in ? cnext[k] : 3;
  }
  uint8_t vnext = B > 0 ? __ldg(a.valid) : 0;
  {
    const uint32_t n = last_valid_part(a.valid, B);
    if (lane == 0) slots[32 + warp].x = n;                 // parity-1 slots
  }
  __syncthreads();
  const int n_proc = static_cast<int>(
      __reduce_max_sync(0xffffffffu, lane < n_warps ? slots[32 + lane].x : 0u));

  // the chain: arrivals 0..n_proc-1, one barrier each
  const float2* mine = wd + (tid - T);   // mine[k * T]: entry k >= 1 of the strip
  for (int b = 0; b < n_proc; ++b) {
    int ccur[kPrefetch];
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) ccur[k] = cnext[k];
    const uint8_t vb = vnext;
    if (b + 1 < n_proc) {
      const int* row = a.cls + static_cast<long>(b + 1) * M;
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int m = tid + k * T;
        if (k < kmax && m < M) cnext[k] = __ldg(row + m);
      }
      vnext = __ldg(a.valid + b + 1);
    }

    // this thread's least (score, rank) key; entries past M score +inf
    // with rank kNone, so the guard k < kmax is the same for the block
    // (their rate is read at server M - 1, as in the prologue, and dropped)
    unsigned long long best = ~0ull;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      if (k < kmax) {
        const int m = tid + k * T;
        float2 p = make_float2(w0, dw);
        if (k > 0 && m < M) p = mine[k * T];
        const int c = ccur[k];
        const uint32_t rank = (static_cast<uint32_t>(c) << 30) | base[k];
        const float r = score_rate<kHomo>(a, hr, min(m, M - 1), c);
        best = min(best, key_of(score_bits(p.x, p.y, r), rank));
      }
    }
    const int* row = a.cls + static_cast<long>(b) * M;
    for (int m = tid + kPrefetch * T; m < M; m += T) {
      const int c = __ldg(row + m);
      const float2 p = wd[m - T];
      const uint32_t pr = a.prio ? static_cast<uint32_t>(__ldg(a.prio + m))
                                 : static_cast<uint32_t>(m);
      const uint32_t rank = (static_cast<uint32_t>(c) << 30) | (pr << 15) |
                            static_cast<uint32_t>(m);
      best = min(best, key_of(score_bits(p.x, p.y, score_rate<kHomo>(a, hr, m, c)),
                              rank));
    }
    uint32_t gs = static_cast<uint32_t>(best >> 32), gr = static_cast<uint32_t>(best);
    warp_lexmin(gs, gr);
    uint2* par = slots + 32 * (b & 1);
    if (lane == 0) par[warp] = make_uint2(gs, gr);
    __syncthreads();
    gs = kNone;
    gr = kNone;
    if (lane < n_warps) {
      const uint2 o = par[lane];
      gs = o.x;
      gr = o.y;
    }
    warp_lexmin(gs, gr);

    // ranks are distinct, so exactly one thread holds the pick: its owner
    if (best == key_of(gs, gr)) {
      const int m = static_cast<int>(gr & kServerMask);
      const int c = static_cast<int>(gr >> 30);
      a.sel[b] = m;
      a.selcls[b] = c;
      a.val[b] = __uint_as_float(gs);
      if (vb && c < 3) {
        const float r = finite_rate(__ldg(a.inv + static_cast<long>(m) * stride + c));
        if (m == tid) dw = __fadd_rn(dw, r);
        else wd[m - T].y = __fadd_rn(wd[m - T].y, r);
        atomicAdd(a.Qn + 3 * m + c, 1);
      }
    }
  }

  // W_new = W0 + dW, to the output and, for the tail, to shared memory
  for (int m = tid; m < M; m += T) {
    float w;
    if (m == tid) {
      w = __fadd_rn(w0, dw);
      wf[tid] = w;
    } else {
      const float2 p = wd[m - T];
      w = __fadd_rn(p.x, p.y);
      wd[m - T].x = w;
    }
    a.Wn[m] = w;
  }
  if (n_proc == B) return;

  // the tail: arrivals n_proc..B-1, one warp a row, against the final W;
  // a lane issues the loads of kTailUnroll servers before it scores any
  __syncthreads();
  for (int b = n_proc + warp; b < B; b += n_warps) {
    const int* row = a.cls + static_cast<long>(b) * M;
    unsigned long long best = ~0ull;
    for (int m0 = lane; m0 < M; m0 += 32 * kTailUnroll) {
      int c[kTailUnroll];
      uint32_t pr[kTailUnroll];
#pragma unroll
      for (int u = 0; u < kTailUnroll; ++u) {      // clamped: no branch
        const int m = min(m0 + 32 * u, M - 1);
        c[u] = __ldg(row + m);
        pr[u] = a.prio ? static_cast<uint32_t>(__ldg(a.prio + m)) : static_cast<uint32_t>(m);
      }
#pragma unroll
      for (int u = 0; u < kTailUnroll; ++u) {
        const int m = min(m0 + 32 * u, M - 1);
        const float w = m < T ? wf[m] : wd[m - T].x;
        const uint32_t rank = (static_cast<uint32_t>(c[u]) << 30) | (pr[u] << 15) |
                              static_cast<uint32_t>(m);
        const unsigned long long key =
            key_of(score_bits(w, 0.0f, score_rate<kHomo>(a, hr, m, c[u])), rank);
        if (m0 + 32 * u < M) best = min(best, key);
      }
    }
    uint32_t gs = static_cast<uint32_t>(best >> 32), gr = static_cast<uint32_t>(best);
    warp_lexmin(gs, gr);
    if (lane == 0) {
      a.sel[b] = static_cast<int>(gr & kServerMask);
      a.selcls[b] = static_cast<int>(gr >> 30);
      a.val[b] = __uint_as_float(gs);
    }
  }
}

// ---------------------------------------------------------------------------
// pod: argmin over C candidates
// ---------------------------------------------------------------------------

struct PodArgs {
  const int* __restrict__ Q;
  const uint8_t* __restrict__ valid;
  const float* __restrict__ inv;
  int inv_stride;
  const int* __restrict__ cand_idx;
  const int* __restrict__ cand_cls;
  const uint8_t* __restrict__ cand_valid;
  int M, B, C;
  int Cs, R;   // slots of a row that are staged, rows a chunk stages
  int* __restrict__ Qn;
  float* __restrict__ Wn;
  int* __restrict__ sel;
  int* __restrict__ selcls;
  float* __restrict__ val;
  long long sQ, sValid, sInv, sIdx, sCls, sCandValid;   // cell strides
};

__device__ __forceinline__ PodArgs cell_of(PodArgs a) {
  const long long n = blockIdx.x;
  a.Q += n * a.sQ;
  a.valid += n * a.sValid;
  a.inv += n * a.sInv;
  a.cand_idx += n * a.sIdx;
  a.cand_cls += n * a.sCls;
  a.cand_valid += n * a.sCandValid;
  a.Qn += n * 3 * a.M;
  a.Wn += n * a.M;
  a.sel += n * a.B;
  a.selcls += n * a.B;
  a.val += n * a.B;
  return a;
}

// Slot (b, c) as the chain reads it: x = server (bit 31: slot invalid),
// y = class, z = the server's W0, w = finite rate (sign bit: scores +inf).
__device__ __forceinline__ int4 pod_entry(const PodArgs& a, int b, int c) {
  const long i = static_cast<long>(b) * a.C + c;
  const int m = __ldg(a.cand_idx + i);
  const int k = __ldg(a.cand_cls + i);
  const bool v = __ldg(a.cand_valid + i) != 0;
  const float* r = a.inv + static_cast<long>(m) * a.inv_stride;
  const float raw = __ldg(r + rate_lane(k));
  const bool bad = !v || k >= 3 || !isfinite(raw);
  const uint32_t fac = __float_as_uint(finite_rate(raw)) | (bad ? kBadBit : 0u);
  return make_int4(m | (v ? 0 : static_cast<int>(kBadBit)), k,
                   __float_as_int(workload(a.Q + 3 * static_cast<long>(m), r)),
                   static_cast<int>(fac));
}

__device__ __forceinline__ uint32_t pod_score(int4 e, float dw) {
  const uint32_t fac = static_cast<uint32_t>(e.w);
  if (fac & kBadBit) return kInfBits;
  return __float_as_uint(__fmul_rn(__fadd_rn(__int_as_float(e.z), dw),
                                   __uint_as_float(fac)));
}

__device__ __forceinline__ uint32_t pod_rank(int4 e, int c, uint32_t CC) {
  return static_cast<uint32_t>(e.y) * CC + static_cast<uint32_t>(c) +
         ((static_cast<uint32_t>(e.x) & kBadBit) ? 4u * CC : 0u);
}

__device__ __forceinline__ int pod_server(int4 e) {
  return e.x & static_cast<int>(~kBadBit);
}

// W0 (+0 for an idle server: W0 + 0, as the reference adds dW = 0) and the
// Q copy of every server, by the threads of warps 1.. .
__device__ void pod_full_pass(const PodArgs& a) {
  for (int m = threadIdx.x - 32; m < a.M; m += blockDim.x - 32) {
    const float* r = a.inv + static_cast<long>(m) * a.inv_stride;
    a.Wn[m] = __fadd_rn(workload(a.Q + 3 * m, r), 0.0f);
    a.Qn[3 * m] = a.Q[3 * m];
    a.Qn[3 * m + 1] = a.Q[3 * m + 1];
    a.Qn[3 * m + 2] = a.Q[3 * m + 2];
  }
}

__device__ void pod_stage(const PodArgs& a, int4* st, int r0, int r1) {
  const int n = (r1 - r0) * a.Cs;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    st[i] = pod_entry(a, r0 + i / a.Cs, i % a.Cs);
}

// This lane's least (score, rank) over the slots c = lane, lane + 32, ...
// of row b, with the slot and the dW it scored with: staged slots (c < Cs)
// from `row` when it is given, the others built from device memory.
__device__ __forceinline__ void pod_lane_min(const PodArgs& a, const int4* row,
                                             const float* dw, int b, uint32_t& bs,
                                             uint32_t& br, int4& be, float& bd) {
  const uint32_t CC = static_cast<uint32_t>(a.C);
  for (int c = threadIdx.x & 31; c < a.C; c += 32) {
    const int4 e = (row && c < a.Cs) ? row[c] : pod_entry(a, b, c);
    const float d = dw[pod_server(e)];
    const uint32_t s = pod_score(e, d);
    const uint32_t r = pod_rank(e, c, CC);
    if (s < bs || (s == bs && r < br)) {
      bs = s;
      br = r;
      be = e;
      bd = d;
    }
  }
}

// Warp 0: arrivals r0..r1-1 of the chain, from the staged rows.  When a
// row fits one slot a lane and is staged whole (C <= 32, the main path's
// C = 11), each lane loads its next slot a step ahead.
__device__ void pod_chain(const PodArgs& a, const int4* st, float* dw, int r0,
                          int r1) {
  const int lane = threadIdx.x;
  const bool one = a.C <= 32 && a.Cs == a.C;   // each lane holds at most one slot
  int4 enext = make_int4(0, 3, 0, static_cast<int>(kBadBit));
  if (one && lane < a.C) enext = st[lane];
  uint8_t vnext = __ldg(a.valid + r0);
  for (int b = r0; b < r1; ++b) {
    const uint8_t vb = vnext;
    const int4 ecur = enext;
    if (b + 1 < r1) {                             // staged rows never change
      vnext = __ldg(a.valid + b + 1);
      if (one && lane < a.C) enext = st[(b + 1 - r0) * a.Cs + lane];
    }
    uint32_t bs = kNone, br = kNone;
    int4 be = ecur;
    float bd = 0.0f;
    if (one) {
      if (lane < a.C) {
        bd = dw[pod_server(ecur)];
        bs = pod_score(ecur, bd);
        br = pod_rank(ecur, lane, static_cast<uint32_t>(a.C));
      }
    } else {
      pod_lane_min(a, st + (b - r0) * a.Cs, dw, b, bs, br, be, bd);
    }
    uint32_t gs = bs, gr = br;
    warp_lexmin(gs, gr);
    if (bs != kNone && bs == gs && br == gr) {    // this lane holds the pick
      const int s = pod_server(be);
      a.sel[b] = s;
      a.selcls[b] = be.y;
      a.val[b] = __uint_as_float(gs);
      if (vb) dw[s] = __fadd_rn(bd, __uint_as_float(static_cast<uint32_t>(be.w) & ~kBadBit));
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(1024, 1) route_commit_pod_kernel(PodArgs cells) {
  const PodArgs a = cell_of(cells);
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* red = reinterpret_cast<uint32_t*>(smem);                 // [32]
  float* dw = reinterpret_cast<float*>(smem + 128);                  // [M]
  int4* st = reinterpret_cast<int4*>(smem + 128 + ((4 * a.M + 15) & ~15));

  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;

  // prologue: dW = 0, the first chunk of rows staged, n_proc
  for (int m = tid; m < a.M; m += T) dw[m] = 0.0f;
  pod_stage(a, st, 0, min(a.R, a.B));
  {
    const uint32_t n = last_valid_part(a.valid, a.B);
    if (lane == 0) red[warp] = n;
  }
  __syncthreads();
  const int n_proc = static_cast<int>(
      __reduce_max_sync(0xffffffffu, lane < n_warps ? red[lane] : 0u));

  // the chain, chunk by chunk; warps 1.. do the full-M pass meanwhile
  for (int r0 = 0; r0 < n_proc; r0 += a.R) {
    const int r1 = min(r0 + a.R, n_proc);
    if (r0 > 0) {
      __syncthreads();
      pod_stage(a, st, r0, r1);
      __syncthreads();
    }
    if (warp == 0) pod_chain(a, st, dw, r0, r1);
    else if (r0 == 0) pod_full_pass(a);
  }
  if (n_proc == 0 && warp > 0) pod_full_pass(a);
  __syncthreads();

  // epilogue: the committed Q increments, W0 + dW of committed servers,
  // and the tail (arrivals n_proc..B-1, one warp a row) against the final W
  // (staged rows are read from shared memory)
  for (int b = tid; b < n_proc; b += T) {
    if (__ldg(a.valid + b)) {
      const int sc = a.selcls[b];
      if (sc < 3) atomicAdd(a.Qn + 3 * a.sel[b] + sc, 1);
    }
  }
  if (warp > 0) {                        // pod_full_pass's servers and threads
    for (int m = tid - 32; m < a.M; m += T - 32) {
      const float d = dw[m];
      if (d != 0.0f) a.Wn[m] = __fadd_rn(a.Wn[m], d);
    }
  }
  // a tail row was staged if it lies in the first chunk, which is still in
  // place unless the chain ran past it (and then no tail row lies there)
  for (int b = n_proc + warp; b < a.B; b += n_warps) {
    uint32_t bs = kNone, br = kNone;
    int4 be = make_int4(0, 0, 0, 0);
    float bd = 0.0f;
    pod_lane_min(a, b < a.R ? st + b * a.Cs : nullptr, dw, b, bs, br, be, bd);
    uint32_t gs = bs, gr = br;
    warp_lexmin(gs, gr);
    if (bs != kNone && bs == gs && br == gr) {
      a.sel[b] = pod_server(be);
      a.selcls[b] = be.y;
      a.val[b] = __uint_as_float(gs);
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// cell_stride: the cell strides (elements) of Q, valid, inv, cls, prio;
// `cells` CTAs, one a cell.
int route_commit_full(const int* Q, const uint8_t* valid, const float* inv,
                      int inv_stride, const int* cls, const int* prio, int M,
                      int B, int* Qn, float* Wn, int* sel, int* selcls,
                      float* val, int threads, int cells,
                      const long long* cell_stride, cudaStream_t stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || M > 32768 || cells < 1)
    return cudaErrorInvalidValue;
  const int spill = M > threads ? M - threads : 0;
  const size_t smem = 2 * 32 * sizeof(uint2) + sizeof(float) * (4 + threads) +
                      sizeof(float2) * static_cast<size_t>(spill);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  const void* fn = inv_stride ? reinterpret_cast<const void*>(route_commit_full_kernel<false>)
                              : reinterpret_cast<const void*>(route_commit_full_kernel<true>);
  int err = set_smem(fn, smem);
  if (err) return err;
  const long long* s = cell_stride;
  FullArgs a{Q,  valid, inv, cls,  prio, M,    B,    Qn,   Wn,  sel,
             selcls, val, s[0], s[1], s[2], s[3], s[4]};
  if (inv_stride) route_commit_full_kernel<false><<<cells, threads, smem, stream>>>(a);
  else route_commit_full_kernel<true><<<cells, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cell_stride: the cell strides of Q, valid, inv, cand_idx, cand_cls,
// cand_valid.
int route_commit_pod(const int* Q, const uint8_t* valid, const float* inv,
                     int inv_stride, const int* cand_idx, const int* cand_cls,
                     const uint8_t* cand_valid, int M, int B, int C, int* Qn,
                     float* Wn, int* sel, int* selcls, float* val, int threads,
                     int cells, const long long* cell_stride, cudaStream_t stream) {
  if (threads < 64 || threads > 1024 || threads % 32 || C < 1 || cells < 1)
    return cudaErrorInvalidValue;
  const size_t fixed = 128 + ((4 * static_cast<size_t>(M) + 15) & ~static_cast<size_t>(15));
  if (fixed + 16 > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  const int cap = static_cast<int>((kSmemLimit - fixed) / 16);   // staged slots
  const int Cs = C < cap ? C : cap;
  const int R = B < cap / Cs ? B : cap / Cs;
  const size_t smem = fixed + 16 * static_cast<size_t>(R) * Cs;
  int err = set_smem(reinterpret_cast<const void*>(route_commit_pod_kernel), smem);
  if (err) return err;
  const long long* s = cell_stride;
  PodArgs a{Q,      valid, inv, inv_stride, cand_idx, cand_cls, cand_valid, M,
            B,      C,     Cs,  R > 0 ? R : 1, Qn,   Wn,       sel,        selcls,
            val,    s[0],  s[1], s[2],      s[3],     s[4],     s[5]};
  route_commit_pod_kernel<<<cells, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Snapshot routing for Hopper (sm_90a): the three kernels of one routing
// tick against a shared workload snapshot, the path of the paper's
// complexity claim (§IV-C): weighted_argmin is the O(M) scan of
// Balanced-Pandas, pod_route the O(d) probe of Balanced-Pandas-Pod, and
// queue_update commits the routed batch and refreshes the workloads.
// Each computes what its plain version in src/repro_torch/kernels/ref.py
// computes, bit for bit.
//
// Shared rules: an entry scores +inf when its inverse rate is non-finite
// (a dead server or column) or its class is 3 or more (the Pallas
// kernels' pad class), after the multiply, so a zero workload never meets
// 0 * inf.  Classes 0 and 1 read their own rate and any other class reads
// class 2's (the TPU kernels' select chain).  The rates operand `inv` is
// the raw [3] (inv_stride 0) or [M, 3] (inv_stride 3) float32 array, so a
// launch needs no encoding pass.  Scores are one __fmul_rn of float32
// operands and workloads are (q0*i0 + q1*i1) + q2*i2 in __fmul_rn /
// __fadd_rn, the plain versions' operations in their order.  A bfloat16
// W is widened by shifting its bits up 16, which is exact, as the plain
// version's cast is.
//
// All three are launched with programmatic stream serialization
// (programmatic dependent launch): their blocks may start while the kernel
// in front of them in the stream is still finishing, and each waits
// (griddepcontrol.wait) before its first global read, since that kernel
// may have written any of its inputs.  On a routing tick the kernel in
// front of each is a PyTorch one, which never lets its dependents start
// early; the launch still saves ~1 us a kernel on the H100 (PERF.md §6).
// None of these kernels lets its own dependents start early
// (griddepcontrol.launch_dependents): on a tick a PyTorch kernel follows
// each routing kernel, and such a trigger measured no gain there.
//
// weighted_argmin -- replaces src/repro/kernels/weighted_argmin.py:45
// `_kernel` (pallas_call at :98).
//   sel[b] = lowest m minimising W[m] * inv[m, cls[b, m]], val[b] = that
//   score; a row of +inf gives sel 0.
//   Bound: the read of cls, B*M*4 bytes (8.4 MB at B = 256, M = 8192:
//   about 2.5 us at 3.35 TB/s).  What it costs on the card beyond that is
//   launch latency (which the dependent launch partly hides), memory
//   round trips and the instructions a score takes.  One block of 256
//   threads a task row (two rows an SM at B = 256); each thread issues a
//   batch of 64 bytes of cls (four int4, or sixteen ints when the row is
//   not 16-byte aligned) and the W and rates of those servers before it
//   uses any, so a block has 16 KB of cls in flight and an SM 32 KB, and
//   W is read once a block.
//   A score is one __fmul_rn of the lane's rate, selected without a
//   branch; a running (val, idx) a thread, then a lexicographic (val, idx)
//   block reduction, so the lower index wins every tie in any split of M.
//   Loads stay inside cls, W and inv.
//   (A ring of bulk asynchronous copies, one block an SM with 64-96 KB of
//   cls in flight, ran slower than this design on the card: PERF.md §6.)
//
// pod_route -- replaces src/repro/kernels/pod_route.py:45 `_kernel`
// (pallas_call at :111).
//   over the C candidates of task b: the lowest slot c* minimising
//   W[cand] * inv[cand, cls] (an invalid slot, or a candidate outside
//   0..M-1, scores +inf); sel[b] = cand_idx[b, c*], val[b] = its score.
//   Bound: B*C*9 bytes of candidate lists plus the W and inv entries they
//   name (~30 KB at B = 256, C = 11, ~0.01 us at 3.35 TB/s), so what it
//   costs is its launch and its chain of dependent memory round trips.
//   The dependent launch hides most of the first.  The chain is two round
//   trips: right after griddepcontrol.wait a lane issues every load of its
//   slots at once (cand_idx, cand_cls, valid, and the [3] rates), with no
//   branch; then, in one batch, W[m] and all three [M, 3] rates of m, with
//   m clamped into 0..M-1, so no address waits on the class and no load
//   leaves its buffer.  The lane's rate is selected in registers
//   (class_score) and the score masked to +inf for an invalid slot or an
//   outside candidate.  kPodLanes lanes a task, each loading kPodSlots
//   slots a batch (a row of up to 16 candidates is one batch; longer rows
//   loop, two more round trips a batch); a lexicographic (score, slot)
//   reduction over the task's lanes (xor shuffles that stay inside its
//   segment of the warp) carries the winner's candidate index, so nothing
//   is read after it.  Eight lanes a task (four tasks a warp, two slots a
//   lane at C = 11, three shuffle rounds) in blocks of 128 threads ran
//   fastest of the layouts measured on the H100 (PERF.md §6):
//   0.07-0.17 us ahead of 16 or 32 lanes a task and of 4, and 0.6-1.1 us
//   ahead of 2 lanes or a thread a task, whose strided loads of 8-16 slots
//   a thread cost more than the shuffles they save.
//
// queue_update -- replaces src/repro/kernels/queue_update.py:37 `_kernel`
// (pallas_call at :86).
//   Q_new[sel[b], sel_cls[b]] += 1 for each valid arrival whose server is
//   in 0..M-1 and class in 0..2 (the wrapper's pad server M and the pad
//   class 3 drop), then W[m] = (q0*i0 + q1*i1) + q2*i2 over Q_new with
//   non-finite rates taken as 0.
//   Bound: Q read and written once, W written once (28 bytes a server):
//   230 KB at M = 8192, ~0.07 us at 3.35 TB/s, so launch latency and
//   dependent round trips; the dependent launch hides most of the first.
//   Each block owns a tile of kTile servers, one a thread.  Before
//   griddepcontrol.wait it only zeroes its hit counters in shared memory;
//   after it, every thread issues all of its loads at once (its server's Q
//   row and rate row, its share of sel / sel_cls / valid): one dependent
//   round trip.  Then it counts the hits on its tile with shared-memory
//   integer atomics (exact in any order), one barrier, and writes its
//   Q_new row and W.  No global atomics and no second pass: the result is
//   deterministic.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kArgminThreads = 256;       // threads a weighted_argmin block
constexpr int kTile = 256;                // servers (threads) a queue_update block owns
constexpr int kPodMaxThreads = 256;       // threads a pod_route block, at most
constexpr int kPodLanes = 8;              // lanes a pod_route task: a quarter warp
constexpr int kPodSlots = 2;              // slots a lane loads a batch: 16 a task

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

template <bool kBf16>
__device__ __forceinline__ float load_w(const void* __restrict__ W, int m) {
  if (kBf16) {
    uint32_t bits = static_cast<const uint16_t*>(W)[m];
    return __uint_as_float(bits << 16);
  }
  return static_cast<const float*>(W)[m];
}

__device__ __forceinline__ float finite_rate(float r) {
  return isfinite(r) ? r : 0.0f;
}

// (bv, bi) <- the lexicographic minimum of (bv, bi) and (v, i).
__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_take(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(kFull, bv, off);
    int oi = __shfl_xor_sync(kFull, bi, off);
    take(bv, bi, ov, oi);
  }
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// W[m] * inv[m, lane(c)], or +inf for a class >= 3 or a dead rate: one
// __fmul_rn of the lane's rate, selected without a branch.
__device__ __forceinline__ float class_score(float w, float r0, float r1,
                                             float r2, int c) {
  const float r = c == 0 ? r0 : c == 1 ? r1 : r2;
  const float v = __fmul_rn(w, r);
  return c >= 3 || !isfinite(r) ? inf() : v;
}

// Fold servers V*q .. V*q+V-1 (q = q0 + u * blockDim.x, u < kLoads) of one
// cls row into (bv, bi).  Every load of the batch (its cls, W and [M, 3]
// rates) is issued before the first is used: kLoads * 16 bytes of cls in
// flight a thread.  V = 4 reads cls as int4 (the row is 16-byte aligned),
// V = 1 as int.
template <bool kBf16, bool kPerServer, int V>
__device__ __forceinline__ void scan_row(const void* __restrict__ W,
                                         const int* __restrict__ row,
                                         const float* __restrict__ inv, int M,
                                         float h0, float h1, float h2,
                                         float& bv, int& bi) {
  constexpr int kLoads = 16 / V;
  const int n = M / V;
  for (int q0 = threadIdx.x; q0 < n; q0 += kLoads * blockDim.x) {
    int c[kLoads][V];
    float w[kLoads][V];
    float r[kPerServer ? kLoads : 1][V][3];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        c[u][j] = 3;
        w[u][j] = 0.0f;
      }
      if (q < n) {
        if (V == 4) {
          const int4 c4 = __ldcs(reinterpret_cast<const int4*>(row) + q);
          c[u][0] = c4.x;
          c[u][V > 1 ? 1 : 0] = c4.y;
          c[u][V > 2 ? 2 : 0] = c4.z;
          c[u][V > 3 ? 3 : 0] = c4.w;
        } else {
          c[u][0] = __ldcs(row + q);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int m = V * q + j;
          w[u][j] = load_w<kBf16>(W, m);
          if (kPerServer) {
            r[kPerServer ? u : 0][j][0] = inv[3L * m];
            r[kPerServer ? u : 0][j][1] = inv[3L * m + 1];
            r[kPerServer ? u : 0][j][2] = inv[3L * m + 2];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q >= n) break;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = kPerServer
            ? class_score(w[u][j], r[kPerServer ? u : 0][j][0],
                          r[kPerServer ? u : 0][j][1], r[kPerServer ? u : 0][j][2],
                          c[u][j])
            : class_score(w[u][j], h0, h1, h2, c[u][j]);
        take(bv, bi, v, V * q + j);
      }
    }
  }
}

template <bool kBf16, bool kPerServer>
__global__ void __launch_bounds__(kArgminThreads)
weighted_argmin_kernel(const void* __restrict__ W, const int* __restrict__ cls,
                       const float* __restrict__ inv, int M, int vec,
                       int* __restrict__ sel, float* __restrict__ val) {
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  // The kernel in front may have written any input: no global read before
  // this point.
  wait_for_primary();
  const int b = blockIdx.x;
  const int* row = cls + static_cast<long>(b) * M;
  float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
  if (!kPerServer) {
    h0 = inv[0];
    h1 = inv[1];
    h2 = inv[2];
  }
  float bv = inf();
  int bi = INT_MAX;
  if (vec)
    scan_row<kBf16, kPerServer, 4>(W, row, inv, M, h0, h1, h2, bv, bi);
  else
    scan_row<kBf16, kPerServer, 1>(W, row, inv, M, h0, h1, h2, bv, bi);
  warp_take(bv, bi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_v[warp] = bv;
    warp_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    bv = lane < n_warps ? warp_v[lane] : inf();
    bi = lane < n_warps ? warp_i[lane] : INT_MAX;
    warp_take(bv, bi);
    if (lane == 0) {
      sel[b] = bi;
      val[b] = bv;
    }
  }
}

// (bv, bs, bm) <- the lexicographic (score, slot) minimum of itself and
// (v, s), carrying the slot's candidate index m.
__device__ __forceinline__ void take_slot(float& bv, int& bs, int& bm, float v,
                                          int s, int m) {
  if (v < bv || (v == bv && s < bs)) {
    bv = v;
    bs = s;
    bm = m;
  }
}

template <bool kBf16, bool kPerServer>
__global__ void __launch_bounds__(kPodMaxThreads)
pod_route_kernel(const void* __restrict__ W, const int* __restrict__ cand_idx,
                 const int* __restrict__ cand_cls,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ inv, int M, int B, int C,
                 int* __restrict__ sel, float* __restrict__ val) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = t / kPodLanes;
  const int j = t % kPodLanes;         // the lane's place in its task
  // A lane past the last task reads the last row and writes nothing: every
  // lane of a warp takes part in the shuffles.
  const long row = static_cast<long>(min(b, B - 1)) * C;
  float bv = inf();
  int bs = INT_MAX, bm = 0;
  // The kernel in front may have written any input: no global read before
  // this point.
  wait_for_primary();
  float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
  if (!kPerServer) {
    h0 = inv[0];
    h1 = inv[1];
    h2 = inv[2];
  }
  for (int c0 = 0; c0 < C; c0 += kPodLanes * kPodSlots) {
    int m[kPodSlots], k[kPodSlots];
    bool ok[kPodSlots];
    float w[kPodSlots], r[kPerServer ? kPodSlots : 1][3];
#pragma unroll
    for (int u = 0; u < kPodSlots; ++u) {   // round trip 1: the lists
      const long at = row + min(c0 + u * kPodLanes + j, C - 1);
      m[u] = cand_idx[at];
      k[u] = cand_cls[at];
      ok[u] = valid[at] != 0;
    }
#pragma unroll
    for (int u = 0; u < kPodSlots; ++u) {   // round trip 2: what they name
      const int mc = min(max(m[u], 0), M - 1);
      w[u] = load_w<kBf16>(W, mc);
      if (kPerServer) {
        r[kPerServer ? u : 0][0] = inv[3L * mc];
        r[kPerServer ? u : 0][1] = inv[3L * mc + 1];
        r[kPerServer ? u : 0][2] = inv[3L * mc + 2];
      }
    }
#pragma unroll
    for (int u = 0; u < kPodSlots; ++u) {
      const int c = c0 + u * kPodLanes + j;
      const float s = kPerServer
          ? class_score(w[u], r[kPerServer ? u : 0][0], r[kPerServer ? u : 0][1],
                        r[kPerServer ? u : 0][2], k[u])
          : class_score(w[u], h0, h1, h2, k[u]);
      const bool in = ok[u] && c < C && m[u] >= 0 && m[u] < M;
      take_slot(bv, bs, bm, in ? s : inf(), c, m[u]);
    }
  }
#pragma unroll
  for (int off = kPodLanes / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int os = __shfl_xor_sync(kFull, bs, off);
    const int om = __shfl_xor_sync(kFull, bm, off);
    take_slot(bv, bs, bm, ov, os, om);
  }
  if (j == 0 && b < B) {
    sel[b] = bm;
    val[b] = bv;
  }
}

__global__ void __launch_bounds__(kTile)
queue_update_kernel(const int* __restrict__ Q, const int* __restrict__ sel,
                    const int* __restrict__ sel_cls,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ inv, int inv_stride, int M, int B,
                    int* __restrict__ Qn, float* __restrict__ Wn) {
  __shared__ int hits[kTile * 3];
  const int lo = blockIdx.x * kTile;
  const int hi = min(lo + kTile, M);
  const int m = lo + threadIdx.x;
  for (int i = threadIdx.x; i < kTile * 3; i += kTile) hits[i] = 0;
  __syncthreads();
  // The kernel in front may have written any input: no global read before
  // this point.
  wait_for_primary();
  int q0 = 0, q1 = 0, q2 = 0;
  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  if (m < M) {
    const float* r = inv + static_cast<long>(m) * inv_stride;
    q0 = Q[3L * m];
    q1 = Q[3L * m + 1];
    q2 = Q[3L * m + 2];
    r0 = r[0];
    r1 = r[1];
    r2 = r[2];
  }
  for (int b = threadIdx.x; b < B; b += kTile) {
    int s = sel[b];
    int c = sel_cls[b];
    if (valid[b] && s >= lo && s < hi && c >= 0 && c < 3)
      atomicAdd(&hits[(s - lo) * 3 + c], 1);
  }
  __syncthreads();
  if (m < M) {
    const int* h = hits + threadIdx.x * 3;
    q0 += h[0];
    q1 += h[1];
    q2 += h[2];
    Qn[3L * m] = q0;
    Qn[3L * m + 1] = q1;
    Qn[3L * m + 2] = q2;
    Wn[m] = __fadd_rn(
        __fadd_rn(__fmul_rn(static_cast<float>(q0), finite_rate(r0)),
                  __fmul_rn(static_cast<float>(q1), finite_rate(r1))),
        __fmul_rn(static_cast<float>(q2), finite_rate(r2)));
  }
}

// Launch `kernel` with programmatic stream serialization: its blocks may
// start before the kernel in front of it in the stream has finished, so it
// must call griddepcontrol.wait before its first global read.  Returns the
// cudaError_t of the launch.
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                     size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, bool kPerServer>
int launch_weighted_argmin(const void* W, const int* cls, const float* inv,
                           int M, int B, int* sel, float* val, int threads,
                           cudaStream_t stream) {
  const int vec = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(cls) % 16 == 0);
  return launch_dependent(weighted_argmin_kernel<kBf16, kPerServer>, dim3(B),
                          dim3(threads), 0, stream, W, cls, inv, M, vec, sel, val);
}

template <bool kBf16, bool kPerServer>
int launch_pod_route(const void* W, const int* cand_idx, const int* cand_cls,
                     const uint8_t* valid, const float* inv, int M, int B, int C,
                     int* sel, float* val, int threads, cudaStream_t stream) {
  const int blocks =
      static_cast<int>((static_cast<long>(B) * kPodLanes + threads - 1) / threads);
  return launch_dependent(pod_route_kernel<kBf16, kPerServer>, dim3(blocks),
                          dim3(threads), 0, stream, W, cand_idx, cand_cls, valid,
                          inv, M, B, C, sel, val);
}

}  // namespace

extern "C" {

// W: [M] float32 (w_bf16 = 0) or bfloat16 bits (w_bf16 = 1); cls: [B, M];
// inv: [3] (inv_stride 0) or [M, 3] (inv_stride 3).  B, M >= 1; threads a
// multiple of 32, at most 256.  Returns the launch's cudaError_t.
int weighted_argmin(const void* W, int w_bf16, const int* cls, const float* inv,
                    int inv_stride, int M, int B, int* sel, float* val,
                    int threads, cudaStream_t stream) {
  if (threads < 32 || threads > kArgminThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_bf16)
    return inv_stride
        ? launch_weighted_argmin<true, true>(W, cls, inv, M, B, sel, val, threads, stream)
        : launch_weighted_argmin<true, false>(W, cls, inv, M, B, sel, val, threads, stream);
  return inv_stride
      ? launch_weighted_argmin<false, true>(W, cls, inv, M, B, sel, val, threads, stream)
      : launch_weighted_argmin<false, false>(W, cls, inv, M, B, sel, val, threads, stream);
}

// W: as weighted_argmin; cand_idx/cand_cls: [B, C] int32; valid: [B, C]
// bool bytes.  B, C >= 1; threads a multiple of 32, at most 256.  Launched
// with programmatic stream serialization.  Returns the launch's
// cudaError_t.
int pod_route(const void* W, int w_bf16, const int* cand_idx,
              const int* cand_cls, const uint8_t* valid, const float* inv,
              int inv_stride, int M, int B, int C, int* sel, float* val,
              int threads, cudaStream_t stream) {
  if (threads < 32 || threads > kPodMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_bf16)
    return inv_stride
        ? launch_pod_route<true, true>(W, cand_idx, cand_cls, valid, inv, M, B, C, sel, val, threads, stream)
        : launch_pod_route<true, false>(W, cand_idx, cand_cls, valid, inv, M, B, C, sel, val, threads, stream);
  return inv_stride
      ? launch_pod_route<false, true>(W, cand_idx, cand_cls, valid, inv, M, B, C, sel, val, threads, stream)
      : launch_pod_route<false, false>(W, cand_idx, cand_cls, valid, inv, M, B, C, sel, val, threads, stream);
}

// Q, Qn: [M, 3] int32; sel/sel_cls: [B] int32; valid: [B] bool bytes;
// Wn: [M] float32.  M >= 1; one block of kTile threads per kTile servers,
// launched with programmatic stream serialization.
int queue_update(const int* Q, const int* sel, const int* sel_cls,
                 const uint8_t* valid, const float* inv, int inv_stride, int M,
                 int B, int* Qn, float* Wn, cudaStream_t stream) {
  return launch_dependent(queue_update_kernel, dim3((M + kTile - 1) / kTile),
                          dim3(kTile), 0, stream, Q, sel, sel_cls, valid, inv,
                          inv_stride, M, B, Qn, Wn);
}

}  // extern "C"

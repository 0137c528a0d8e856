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
// weighted_argmin -- replaces src/repro/kernels/weighted_argmin.py:45
// `_kernel` (pallas_call at :98).
//   sel[b] = lowest m minimising W[m] * inv[m, cls[b, m]], val[b] = that
//   score; a row of +inf gives sel 0.
//   Bound: the read of cls, B*M*4 bytes (8.4 MB at B = 256, M = 8192:
//   about 2.5 us at 3.35 TB/s); W and a per-server inv stay in L2.  One
//   block per task row streams cls[b, :] with 16-byte loads when the row
//   is 16-byte aligned, keeps a running (val, idx) per thread and reduces
//   across the block lexicographically on (val, idx), so the lower index
//   wins every tie.  B = 256 rows give ~2 blocks per SM: enough to stream,
//   too few to hide all memory latency; at small M a launch costs more
//   than the bytes.
//
// pod_route -- replaces src/repro/kernels/pod_route.py:45 `_kernel`
// (pallas_call at :111).
//   over the C candidates of task b: the lowest slot c* minimising
//   W[cand] * inv[cand, cls] (an invalid slot, or a candidate outside
//   0..M-1, scores +inf); sel[b] = cand_idx[b, c*], val[b] = its score.
//   Bound: B*C*9 bytes of candidate lists plus the W and inv entries they
//   name (~30 KB at B = 256, C = 11): launch latency, not bandwidth.  A
//   warp per task, a lane per candidate (looping when C > 32), exact
//   indexed loads of W[cand] and inv[cand, cls] where the TPU kernel used
//   a one-hot matmul, and a lexicographic (score, slot) warp reduction.
//
// queue_update -- replaces src/repro/kernels/queue_update.py:37 `_kernel`
// (pallas_call at :86).
//   Q_new[sel[b], sel_cls[b]] += 1 for each valid arrival whose server is
//   in 0..M-1 and class in 0..2 (the wrapper's pad server M and the pad
//   class 3 drop), then W[m] = (q0*i0 + q1*i1) + q2*i2 over Q_new with
//   non-finite rates taken as 0.
//   Bound: Q read and written once, W written once (28 bytes a server):
//   230 KB at M = 8192, ~0.07 us at 3.35 TB/s, so latency again.  One
//   launch; each block owns a tile of servers, walks the whole batch and
//   counts the hits on its tile with shared-memory integer atomics (exact
//   in any order), then writes its tile of Q_new and W.  No global
//   atomics and no second pass: the result is deterministic.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

// inv[m, lane(c)] * w, or +inf for a dead entry or a class >= 3.
__device__ __forceinline__ float score(float w, const float* __restrict__ inv,
                                       int inv_stride, int m, int c) {
  int lane = (c == 0 || c == 1) ? c : 2;
  float r = inv[static_cast<long>(m) * inv_stride + lane];
  if (c >= 3 || !isfinite(r)) return inf();
  return __fmul_rn(w, r);
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

template <bool kBf16>
__global__ void weighted_argmin_kernel(const void* __restrict__ W,
                                       const int* __restrict__ cls,
                                       const float* __restrict__ inv,
                                       int inv_stride, int M, int vec,
                                       int* __restrict__ sel,
                                       float* __restrict__ val) {
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  const int b = blockIdx.x;
  const int* row = cls + static_cast<long>(b) * M;
  float bv = inf();
  int bi = INT_MAX;
  if (vec) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    for (int q = threadIdx.x; q < M / 4; q += blockDim.x) {
      int4 c = row4[q];
      int m = 4 * q;
      take(bv, bi, score(load_w<kBf16>(W, m), inv, inv_stride, m, c.x), m);
      take(bv, bi, score(load_w<kBf16>(W, m + 1), inv, inv_stride, m + 1, c.y), m + 1);
      take(bv, bi, score(load_w<kBf16>(W, m + 2), inv, inv_stride, m + 2, c.z), m + 2);
      take(bv, bi, score(load_w<kBf16>(W, m + 3), inv, inv_stride, m + 3, c.w), m + 3);
    }
  } else {
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      take(bv, bi, score(load_w<kBf16>(W, m), inv, inv_stride, m, row[m]), m);
  }
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

template <bool kBf16>
__global__ void pod_route_kernel(const void* __restrict__ W,
                                 const int* __restrict__ cand_idx,
                                 const int* __restrict__ cand_cls,
                                 const uint8_t* __restrict__ valid,
                                 const float* __restrict__ inv, int inv_stride,
                                 int M, int B, int C, int* __restrict__ sel,
                                 float* __restrict__ val) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;                 // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(b) * C;
  float bv = inf();
  int bs = INT_MAX;
  for (int c = lane; c < C; c += 32) {
    int m = cand_idx[row + c];
    float s = inf();
    if (valid[row + c] && m >= 0 && m < M)
      s = score(load_w<kBf16>(W, m), inv, inv_stride, m, cand_cls[row + c]);
    take(bv, bs, s, c);
  }
  warp_take(bv, bs);
  if (lane == 0) {
    sel[b] = cand_idx[row + bs];
    val[b] = bv;
  }
}

constexpr int kTile = 256;            // servers a queue_update block owns

__global__ void queue_update_kernel(const int* __restrict__ Q,
                                    const int* __restrict__ sel,
                                    const int* __restrict__ sel_cls,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ inv,
                                    int inv_stride, int M, int B,
                                    int* __restrict__ Qn,
                                    float* __restrict__ Wn) {
  __shared__ int hits[kTile * 3];
  const int lo = blockIdx.x * kTile;
  const int hi = min(lo + kTile, M);
  for (int i = threadIdx.x; i < kTile * 3; i += blockDim.x) hits[i] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int s = sel[b];
    int c = sel_cls[b];
    if (valid[b] && s >= lo && s < hi && c >= 0 && c < 3)
      atomicAdd(&hits[(s - lo) * 3 + c], 1);
  }
  __syncthreads();
  for (int m = lo + threadIdx.x; m < hi; m += blockDim.x) {
    const int* h = hits + (m - lo) * 3;
    const float* r = inv + static_cast<long>(m) * inv_stride;
    int q0 = Q[3 * m] + h[0];
    int q1 = Q[3 * m + 1] + h[1];
    int q2 = Q[3 * m + 2] + h[2];
    Qn[3 * m] = q0;
    Qn[3 * m + 1] = q1;
    Qn[3 * m + 2] = q2;
    Wn[m] = __fadd_rn(
        __fadd_rn(__fmul_rn(static_cast<float>(q0), finite_rate(r[0])),
                  __fmul_rn(static_cast<float>(q1), finite_rate(r[1]))),
        __fmul_rn(static_cast<float>(q2), finite_rate(r[2])));
  }
}

}  // namespace

extern "C" {

// W: [M] float32 (w_bf16 = 0) or bfloat16 bits (w_bf16 = 1); cls: [B, M];
// inv: [3] (inv_stride 0) or [M, 3] (inv_stride 3).  B, M >= 1; threads a
// multiple of 32, at most 1024.  Returns the launch's cudaError_t.
int weighted_argmin(const void* W, int w_bf16, const int* cls, const float* inv,
                    int inv_stride, int M, int B, int* sel, float* val,
                    int threads, cudaStream_t stream) {
  int vec = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(cls) % 16 == 0);
  if (w_bf16)
    weighted_argmin_kernel<true><<<B, threads, 0, stream>>>(
        W, cls, inv, inv_stride, M, vec, sel, val);
  else
    weighted_argmin_kernel<false><<<B, threads, 0, stream>>>(
        W, cls, inv, inv_stride, M, vec, sel, val);
  return static_cast<int>(cudaGetLastError());
}

// W: as weighted_argmin; cand_idx/cand_cls: [B, C] int32; valid: [B, C]
// bool bytes.  B, C >= 1; threads a multiple of 32, at most 1024.
int pod_route(const void* W, int w_bf16, const int* cand_idx,
              const int* cand_cls, const uint8_t* valid, const float* inv,
              int inv_stride, int M, int B, int C, int* sel, float* val,
              int threads, cudaStream_t stream) {
  int per_block = threads / 32;
  int blocks = (B + per_block - 1) / per_block;
  if (w_bf16)
    pod_route_kernel<true><<<blocks, threads, 0, stream>>>(
        W, cand_idx, cand_cls, valid, inv, inv_stride, M, B, C, sel, val);
  else
    pod_route_kernel<false><<<blocks, threads, 0, stream>>>(
        W, cand_idx, cand_cls, valid, inv, inv_stride, M, B, C, sel, val);
  return static_cast<int>(cudaGetLastError());
}

// Q, Qn: [M, 3] int32; sel/sel_cls: [B] int32; valid: [B] bool bytes;
// Wn: [M] float32.  M >= 1; one block of kTile threads per kTile servers.
int queue_update(const int* Q, const int* sel, const int* sel_cls,
                 const uint8_t* valid, const float* inv, int inv_stride, int M,
                 int B, int* Qn, float* Wn, cudaStream_t stream) {
  int blocks = (M + kTile - 1) / kTile;
  queue_update_kernel<<<blocks, kTile, 0, stream>>>(
      Q, sel, sel_cls, valid, inv, inv_stride, M, B, Qn, Wn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

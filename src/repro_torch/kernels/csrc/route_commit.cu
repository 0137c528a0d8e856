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
//   for b in 0..B-1, in order:
//     score[m] = (W0[m] + dW[m]) * inv[m, cls]   (+inf if dead / cls >= 3)
//     pick the least (score, rank); rank is the exact integer tie lane
//       full: (cls*M + prio)*M + m      pod: cls*C + slot + (1-valid)*4C
//     if valid[b]: dW[sel] += inv[sel, sel_cls]; Q[sel, sel_cls] += 1
//
// Bound: the batch is a chain of B dependent argmins, so the card's memory
// rate is not what limits it: each arrival costs one block-wide reduction
// (full) or one warp reduction (pod) plus barriers.  One CTA per call; W0
// and dW live in shared memory (8 bytes a server: 40 KB at M = 5000).
//
// Parity: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction) in the reference's order, so exact lattice ties break the
// same way as in the plain version.  Scores are >= 0 or +inf, so their f32
// bits order as uint32 and (score, rank) packs into one u64 whose integer
// minimum is the lexicographic minimum.
//
// Rates operand: `inv` is the [3] or [M, 3] float32 inverse-rate operand
// itself (inv_stride 0 or 3).  A non-finite entry is dead: it scores +inf
// and contributes 0 workload -- the split kernels/invrates.py encodes, done
// here per element, so the wrapper launches nothing to prepare it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kKeyMax = ~0ull;

__device__ __forceinline__ unsigned long long pack(float score, uint32_t rank) {
  return (static_cast<unsigned long long>(__float_as_uint(score)) << 32) | rank;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o < k ? o : k;
  }
  return k;
}

// The finite part of an inverse rate: dead (non-finite) entries give 0.
__device__ __forceinline__ float finite_rate(float r) {
  return isfinite(r) ? r : 0.0f;
}

// W0 = sum_c Q[m,c] * finite_inv[m,c] in the pinned order; dW = 0; Qn = Q.
__device__ void init_workload(const int* __restrict__ Q,
                              const float* __restrict__ inv, int inv_stride,
                              int M, float* w0, float* dw, int* __restrict__ Qn) {
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float* r = inv + static_cast<long>(m) * inv_stride;
    float q0 = static_cast<float>(Q[3 * m]);
    float q1 = static_cast<float>(Q[3 * m + 1]);
    float q2 = static_cast<float>(Q[3 * m + 2]);
    w0[m] = __fadd_rn(__fadd_rn(__fmul_rn(q0, finite_rate(r[0])),
                                __fmul_rn(q1, finite_rate(r[1]))),
                      __fmul_rn(q2, finite_rate(r[2])));
    dw[m] = 0.0f;
    Qn[3 * m] = Q[3 * m];
    Qn[3 * m + 1] = Q[3 * m + 1];
    Qn[3 * m + 2] = Q[3 * m + 2];
  }
}

__device__ __forceinline__ float score_of(const float* w0, const float* dw,
                                          const float* __restrict__ inv,
                                          int inv_stride, int m, int c, bool ok) {
  float r = inv[static_cast<long>(m) * inv_stride + (c < 2 ? c : 2)];
  if (!ok || c >= 3 || !isfinite(r)) return __int_as_float(0x7f800000);
  return __fmul_rn(__fadd_rn(w0[m], dw[m]), r);
}

__global__ void route_commit_full_kernel(
    const int* __restrict__ Q, const uint8_t* __restrict__ valid,
    const float* __restrict__ inv, int inv_stride,
    const int* __restrict__ cls, const int* __restrict__ prio, int M, int B,
    int* __restrict__ Qn, float* __restrict__ Wn, int* __restrict__ sel_out,
    int* __restrict__ selcls_out, float* __restrict__ val_out) {
  extern __shared__ float smem[];
  float* w0 = smem;
  float* dw = smem + M;
  __shared__ unsigned long long warp_best[32];

  init_workload(Q, inv, inv_stride, M, w0, dw, Qn);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const uint32_t MM = static_cast<uint32_t>(M);

  for (int b = 0; b < B; ++b) {
    const int* cls_b = cls + static_cast<long>(b) * M;
    unsigned long long best = kKeyMax;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      int c = cls_b[m];
      float s = score_of(w0, dw, inv, inv_stride, m, c, true);
      uint32_t p = prio ? static_cast<uint32_t>(prio[m]) : static_cast<uint32_t>(m);
      uint32_t rank = (static_cast<uint32_t>(c) * MM + p) * MM + static_cast<uint32_t>(m);
      unsigned long long k = pack(s, rank);
      best = k < best ? k : best;
    }
    best = warp_min(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < n_warps ? warp_best[lane] : kKeyMax;
      best = warp_min(best);
      if (lane == 0) {
        uint32_t rank = static_cast<uint32_t>(best & 0xffffffffull);
        int s = static_cast<int>(rank % MM);
        int sc = static_cast<int>(rank / (MM * MM));
        sel_out[b] = s;
        selcls_out[b] = sc;
        val_out[b] = __uint_as_float(static_cast<uint32_t>(best >> 32));
        if (valid[b] && sc < 3) {
          float r = finite_rate(inv[static_cast<long>(s) * inv_stride + sc]);
          dw[s] = __fadd_rn(dw[s], r);
          Qn[3 * s + sc] += 1;
        }
      }
    }
    __syncthreads();
  }

  for (int m = threadIdx.x; m < M; m += blockDim.x) Wn[m] = __fadd_rn(w0[m], dw[m]);
}

__global__ void route_commit_pod_kernel(
    const int* __restrict__ Q, const uint8_t* __restrict__ valid,
    const float* __restrict__ inv, int inv_stride,
    const int* __restrict__ cand_idx, const int* __restrict__ cand_cls,
    const uint8_t* __restrict__ cand_valid, int M, int B, int C,
    int* __restrict__ Qn, float* __restrict__ Wn, int* __restrict__ sel_out,
    int* __restrict__ selcls_out, float* __restrict__ val_out) {
  extern __shared__ float smem[];
  float* w0 = smem;
  float* dw = smem + M;

  init_workload(Q, inv, inv_stride, M, w0, dw, Qn);
  __syncthreads();

  // the batch is one dependent chain: warp 0 walks it, one lane a candidate
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint32_t CC = static_cast<uint32_t>(C);
    for (int b = 0; b < B; ++b) {
      const long row = static_cast<long>(b) * C;
      unsigned long long best = kKeyMax;
      for (int c = lane; c < C; c += 32) {
        int m = cand_idx[row + c];
        int k = cand_cls[row + c];
        int v = cand_valid[row + c] != 0;
        float s = score_of(w0, dw, inv, inv_stride, m, k, v != 0);
        uint32_t rank = static_cast<uint32_t>(k) * CC + static_cast<uint32_t>(c) +
                        static_cast<uint32_t>(1 - v) * 4u * CC;
        unsigned long long key = pack(s, rank);
        best = key < best ? key : best;
      }
      best = warp_min(best);
      if (lane == 0) {
        int slot = static_cast<int>(static_cast<uint32_t>(best & 0xffffffffull) % CC);
        int s = cand_idx[row + slot];
        int sc = cand_cls[row + slot];
        sel_out[b] = s;
        selcls_out[b] = sc;
        val_out[b] = __uint_as_float(static_cast<uint32_t>(best >> 32));
        if (valid[b]) {
          float r = finite_rate(inv[static_cast<long>(s) * inv_stride + (sc < 2 ? sc : 2)]);
          dw[s] = __fadd_rn(dw[s], r);
          if (sc < 3) Qn[3 * s + sc] += 1;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int m = threadIdx.x; m < M; m += blockDim.x) Wn[m] = __fadd_rn(w0[m], dw[m]);
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

int route_commit_full(const int* Q, const uint8_t* valid, const float* inv,
                      int inv_stride, const int* cls, const int* prio, int M,
                      int B, int* Qn, float* Wn, int* sel, int* selcls,
                      float* val, int threads, cudaStream_t stream) {
  size_t smem = 2 * sizeof(float) * static_cast<size_t>(M);
  int err = set_smem(reinterpret_cast<const void*>(route_commit_full_kernel), smem);
  if (err) return err;
  route_commit_full_kernel<<<1, threads, smem, stream>>>(
      Q, valid, inv, inv_stride, cls, prio, M, B, Qn, Wn, sel, selcls, val);
  return static_cast<int>(cudaGetLastError());
}

int route_commit_pod(const int* Q, const uint8_t* valid, const float* inv,
                     int inv_stride, const int* cand_idx, const int* cand_cls,
                     const uint8_t* cand_valid, int M, int B, int C, int* Qn,
                     float* Wn, int* sel, int* selcls, float* val, int threads,
                     cudaStream_t stream) {
  size_t smem = 2 * sizeof(float) * static_cast<size_t>(M);
  int err = set_smem(reinterpret_cast<const void*>(route_commit_pod_kernel), smem);
  if (err) return err;
  route_commit_pod_kernel<<<1, threads, smem, stream>>>(
      Q, valid, inv, inv_stride, cand_idx, cand_cls, cand_valid, M, B, C, Qn, Wn,
      sel, selcls, val);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Latency of the synchronisation a route_commit step is built from, on one
// card: a dependent redux.sync and shuffle, __syncthreads at 32-1024
// threads, the full variant's step skeleton (warp lexicographic minimum,
// slot write, one barrier, slot read, second minimum), and the same step
// across a thread block cluster of 1-16 CTAs (DSMEM slot writes and one
// cluster barrier).  Cycles from clock64, 10 000 dependent iterations.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o sync_latency \
//        scripts/sync_latency.cu && ./sync_latency
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__global__ void k_redux(uint32_t* out, long long* t, int iters) {
  uint32_t v = threadIdx.x * 2654435761u;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) v = __reduce_min_sync(0xffffffffu, v ^ i) + threadIdx.x;
  long long t1 = clock64();
  if (threadIdx.x == 0) t[0] = (t1 - t0) / iters;
  out[threadIdx.x] = v;
}
__global__ void k_shfl(uint32_t* out, long long* t, int iters) {
  uint32_t v = threadIdx.x * 2654435761u;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) v = __shfl_xor_sync(0xffffffffu, v ^ i, 1) + threadIdx.x;
  long long t1 = clock64();
  if (threadIdx.x == 0) t[0] = (t1 - t0) / iters;
  out[threadIdx.x] = v;
}
// the chain's skeleton: warp lexmin, slot write, barrier, slot read, lexmin
__global__ void k_step(uint32_t* out, long long* t, int iters) {
  __shared__ uint2 slots[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  uint32_t s = threadIdx.x * 2654435761u, r = threadIdx.x;
  __syncthreads();
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    uint32_t gs = s ^ i, gr = r;
    uint32_t m = __reduce_min_sync(~0u, gs); gr = __reduce_min_sync(~0u, gs == m ? gr : ~0u); gs = m;
    if (lane == 0) slots[i & 1][warp] = make_uint2(gs, gr);
    __syncthreads();
    gs = ~0u; gr = ~0u;
    if (lane < nw) { uint2 o = slots[i & 1][lane]; gs = o.x; gr = o.y; }
    m = __reduce_min_sync(~0u, gs); gr = __reduce_min_sync(~0u, gs == m ? gr : ~0u); gs = m;
    s += gs & 1; r += gr & 1;
  }
  long long t1 = clock64();
  if (threadIdx.x == 0) t[0] = (t1 - t0) / iters;
  out[threadIdx.x] = s + r;
}
__global__ void k_bar(uint32_t* out, long long* t, int iters) {
  uint32_t v = threadIdx.x;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) { __syncthreads(); v += i; }
  long long t1 = clock64();
  if (threadIdx.x == 0) t[0] = (t1 - t0) / iters;
  out[threadIdx.x] = v;
}
// per step: every warp writes its (s, r) into every CTA's slot array, one
// cluster barrier, every warp reduces all G * n_warps slots
__global__ void k_cstep(uint32_t* out, long long* t, int iters) {
  __shared__ uint2 slots[2][512];
  cg::cluster_group cl = cg::this_cluster();
  const int G = cl.num_blocks(), me = cl.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  uint32_t s = threadIdx.x * 2654435761u + me, r = threadIdx.x;
  cl.sync();
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    uint32_t gs = s ^ i, gr = r;
    uint32_t m = __reduce_min_sync(~0u, gs); gr = __reduce_min_sync(~0u, gs == m ? gr : ~0u); gs = m;
    if (lane < G) {
      uint2* dst = cl.map_shared_rank(&slots[i & 1][0], lane);
      dst[me * nw + warp] = make_uint2(gs, gr);
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    gs = ~0u; gr = ~0u;
    for (int j = lane; j < G * nw; j += 32) {
      uint2 o = slots[i & 1][j];
      if (o.x < gs || (o.x == gs && o.y < gr)) { gs = o.x; gr = o.y; }
    }
    m = __reduce_min_sync(~0u, gs); gr = __reduce_min_sync(~0u, gs == m ? gr : ~0u); gs = m;
    s += gs & 1; r += gr & 1;
  }
  long long t1 = clock64();
  if (threadIdx.x == 0 && me == 0) t[0] = (t1 - t0) / iters;
  out[threadIdx.x] = s + r;
  cl.sync();
}
__global__ void k_cbar(uint32_t* out, long long* t, int iters) {
  cg::cluster_group cl = cg::this_cluster();
  uint32_t v = threadIdx.x;
  cl.sync();
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    v += i;
  }
  long long t1 = clock64();
  if (threadIdx.x == 0 && cl.block_rank() == 0) t[0] = (t1 - t0) / iters;
  out[threadIdx.x] = v;
}
template <typename K>
void run(K k, const char* name, int G, int T, uint32_t* out, long long* t) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G); cfg.blockDim = dim3(T);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = G; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
  cfg.attrs = at; cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k, out, t, 10000);
  long long h = -1;
  cudaMemcpy(&h, t, 8, cudaMemcpyDeviceToHost);
  printf("%s G=%d T=%d: %lld cycles (%s)\n", name, G, T, h, cudaGetErrorString(e));
}
int main() {
  uint32_t* out; long long* t; cudaMalloc(&out, 4096 * 4); cudaMalloc(&t, 8);
  long long h; int iters = 10000;
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  printf("clock %d kHz\n", clk);
  k_redux<<<1, 32>>>(out, t, iters); cudaMemcpy(&h, t, 8, cudaMemcpyDeviceToHost); printf("redux.sync dependent latency: %lld cycles\n", h);
  k_shfl<<<1, 32>>>(out, t, iters); cudaMemcpy(&h, t, 8, cudaMemcpyDeviceToHost); printf("shfl dependent latency: %lld cycles\n", h);
  for (int T : {32, 128, 512, 1024}) {
    k_bar<<<1, T>>>(out, t, iters); cudaMemcpy(&h, t, 8, cudaMemcpyDeviceToHost); printf("bar.sync T=%d: %lld cycles\n", T, h);
    k_step<<<1, T>>>(out, t, iters); cudaMemcpy(&h, t, 8, cudaMemcpyDeviceToHost); printf("step skeleton T=%d: %lld cycles\n", T, h);
  }

  cudaFuncSetAttribute(k_cstep, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(k_cbar, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int G : {1, 2, 4, 8, 16}) {
    for (int T : {128, 256, 640, 1024}) {
      run(k_cbar, "cluster barrier", G, T, out, t);
      run(k_cstep, "cluster step", G, T, out, t);
    }
  }
  printf("%s\n", cudaGetErrorString(cudaDeviceSynchronize()));
}

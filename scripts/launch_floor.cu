// The launch floor of a kernel on one card: a kernel that does nothing but
// wait for the kernel in front of it (griddepcontrol.wait) and store one
// int a block.  chip_smoke.py builds it with the port's nvcc flags and
// times it behind a plain PyTorch kernel, launched plainly and as a
// programmatic dependent launch, beside the snapshot kernels: for a kernel
// whose bytes take far less than a launch, this is the least it can cost.
// It is no part of the port.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o launch_floor.so scripts/launch_floor.cu
#include <cuda_runtime.h>

__global__ void floor_kernel(int* out) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<int>(blockIdx.x);
}

// out: at least `blocks` ints.  dependent = 1 launches with programmatic
// stream serialization, as the snapshot kernels are; 0 with <<<>>>.
// Returns the launch's cudaError_t.
extern "C" int launch_floor(int* out, int blocks, int threads, int dependent,
                            cudaStream_t stream) {
  if (!dependent) {
    floor_kernel<<<blocks, threads, 0, stream>>>(out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, floor_kernel, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

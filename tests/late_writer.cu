// A kernel for the launch-order tests of tests/test_torch_gpu.py: it lets
// the kernel after it in the stream start at once
// (griddepcontrol.launch_dependents, so a programmatic dependent launch
// behind it begins while it runs), spins for `spin` clock cycles, and only
// then copies `nbytes` bytes from src over dst.  A dependent kernel that
// reads dst before its griddepcontrol.wait sees the old bytes; one that
// waits sees the new ones, since the wait returns only when this kernel has
// finished and its writes are visible.
#include <cuda_runtime.h>

__global__ void late_write_kernel(const unsigned char* src, unsigned char* dst,
                                  long nbytes, long long spin) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {
  }
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < nbytes;
       i += static_cast<long>(gridDim.x) * blockDim.x)
    dst[i] = src[i];
}

// Returns the launch's cudaError_t.
extern "C" int late_write(const void* src, void* dst, long nbytes, long long spin,
                          cudaStream_t stream) {
  late_write_kernel<<<4, 256, 0, stream>>>(static_cast<const unsigned char*>(src),
                                           static_cast<unsigned char*>(dst), nbytes,
                                           spin);
  return static_cast<int>(cudaGetLastError());
}

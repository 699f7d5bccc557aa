// An empty kernel.  Its device time is the least any launch takes on the
// card: chip_smoke.py times it beside the kernels whose bounds lie below
// it.  It ports no TPU kernel, and no path of the package launches it.
#include <cuda_runtime.h>

__global__ void svgir_empty_kernel() {}

extern "C" int svgir_empty(int blocks, int threads, void* stream) {
  svgir_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

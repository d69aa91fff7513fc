// Kernel-route probe: out = x + 1 on an (8, 128) float32 block.
//
// Replaces: src/repro/kernels/ops.py::can_lower_noninterpret (a trivial
// Pallas TPU kernel, x + 1 on (8, 128) float32, compiled without the
// interpreter). kernels/ops.py::can_launch_kernels builds this source with
// nvcc, launches it once and checks the result, so the engine can refuse
// the kernel route with a stated reason before the first inference.
//
// What bounds it: nothing worth measuring (4 KB in, 4 KB out, one block);
// it is not timed.
#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

// x and out hold n float32 each. Returns cudaGetLastError() after the
// launch.
extern "C" int repro_probe(const void* x, void* out, int n, void* stream) {
  probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

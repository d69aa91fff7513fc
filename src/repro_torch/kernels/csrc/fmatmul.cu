// Tiled float matmul with a float32 accumulator, result in the input dtype.
//
// Replaces: src/repro/kernels/qmatmul.py::fmatmul (Pallas TPU kernel
// _fmatmul_kernel). It runs the float FULLY_CONNECTED layers of the
// compiled engine's kernel route (a float graph with use_kernels=True),
// through kernels/ops.py::fmatmul, which pads to 128 like the reference.
//
// What bounds it on an H100: at the shapes it runs (the speech model's
// float FC, 8 x 4000 x 4, padded to 128 x 4096 x 128) it moves about 2 MB
// and does about 0.13 GFLOP, so both bounds are around a microsecond. The
// kernel is written to be right and simple: CUDA cores, full IEEE float32
// fused multiply-adds (no tensor cores, so never TF32: the reference's
// tolerance is 1e-5).
//
// Design: one 256-thread block per 64x64 output tile; the TPU grid's
// sequential K axis becomes a loop inside the block. Each step stages a
// 64x32 x tile (transposed, so a thread's four rows are one stride apart)
// and a 32x64 w tile in shared memory as float32 (bf16 is widened with
// __bfloat162float while staging). Each thread owns a 4x4 set of outputs
// (rows ty + 16i, cols tx + 16j). Like the reference, which adds each K
// tile's product into its f32 accumulator, the products of one K tile are
// summed first and then added to the accumulator. The result is rounded
// once to the output dtype (__float2bfloat16_rn for bf16).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fmatmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 2048 elements of each tile, 8 per thread; neighbouring threads read
    // neighbouring addresses
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      xs[kk][r] = widen(x[static_cast<size_t>(m0 + r) * K + k0 + kk]);
    }
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN;
      const int c = idx % BN;
      ws[kk][c] = widen(w[static_cast<size_t>(k0 + kk) * N + n0 + c]);
    }
    __syncthreads();

    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[i][j] = __fmaf_rn(a[i], b[j], part[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      narrow(acc[i][j], out + static_cast<size_t>(m) * N + n0 + tx + 16 * j);
    }
  }
}

}  // namespace

// x (M, K), w (K, N), out (M, N), all float32 (bf16 == 0) or all bfloat16
// (bf16 == 1); row-major, contiguous; M, N multiples of 64 and K a multiple
// of 32 (the Python wrapper checks). Returns cudaGetLastError() after the
// launch.
extern "C" int repro_fmatmul(const void* x, const void* w, void* out, int M,
                             int N, int K, int bf16, void* stream) {
  const dim3 grid(N / BN, M / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    fmatmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    fmatmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

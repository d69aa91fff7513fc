// Quantized int8 matmul with the folded requant epilogue (Eq. 3/4/7).
//
// Replaces: src/repro/kernels/qmatmul.py::qmatmul (Pallas TPU kernel
// _qmatmul_kernel). It runs every FULLY_CONNECTED and, through im2col,
// every CONV_2D of the compiled engine's kernel route.
//
// What bounds it on an H100: at the person detector's shapes
// (M <= 18432, K <= 1152, N <= 256) the work is a few hundred MOPs and a few
// MB, so both the int8 tensor-core bound and the 3.35 TB/s memory bound are
// around a microsecond; a launch costs more than that. The kernel is
// therefore written to be right and simple: CUDA cores, __dp4a (four int8
// products per instruction), no tensor cores.
//
// Design: one 256-thread block per 64x64 output tile. The TPU grid carried
// the int32 accumulator and the row sum ΣX across its sequential K steps in
// scratch memory; blocks on the GPU run in no order, so the K walk becomes a
// loop inside the block: each step stages a 64x64 x tile (row-major) and a
// 64x64 w tile (transposed, so four consecutive k pack into one 32-bit word
// for __dp4a) in shared memory. Each thread owns a 4x4 set of outputs (rows
// ty + 16i, cols tx + 16j) in registers and also sums its four rows of x
// (ΣX) from the same staged words with __dp4a against 0x01010101. The
// epilogue applies requant.cuh and writes zero for columns >= n_true (the
// padded-layout contract the next layer's K padding relies on).
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int KW = BK / 4;        // 32-bit words per staged row
constexpr int WS_STRIDE = KW + 1; // padded: conflict-free column reads

__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ resc,
               const int32_t* __restrict__ wsum,
               const int32_t* __restrict__ coff,
               const int32_t* __restrict__ zw, int8_t* __restrict__ out,
               int M, int N, int K, float lo, float hi, int n_true) {
  __shared__ __align__(16) int32_t xs[BM * KW];
  __shared__ __align__(16) int32_t ws[BN * WS_STRIDE];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // staging map: each thread moves 16 bytes of x and 16 bytes of w per step
  const int lr = tid / 4;          // tile row (x) / tile k (w)
  const int lq = tid % 4;          // 16-byte chunk within the row
  int8_t* wsb = reinterpret_cast<int8_t*>(ws);

  int32_t acc[4][4];
  int32_t sx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sx[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int4 xv = *reinterpret_cast<const int4*>(
        x + static_cast<size_t>(m0 + lr) * K + k0 + lq * 16);
    reinterpret_cast<int4*>(xs)[lr * (KW / 4) + lq] = xv;

    const int4 wv = *reinterpret_cast<const int4*>(
        w + static_cast<size_t>(k0 + lr) * N + n0 + lq * 16);
    const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      wsb[(lq * 16 + b) * (WS_STRIDE * 4) + lr] = wb[b];
    }
    __syncthreads();

#pragma unroll
    for (int kq = 0; kq < KW; ++kq) {
      int32_t a[4];
      int32_t bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * KW + kq];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = ws[(tx + 16 * j) * WS_STRIDE + kq];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sx[i] = __dp4a(a[i], 0x01010101, sx[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    const float b = bias[n];
    const float r = resc[n];
    const int32_t s = wsum[n];
    const int32_t c = coff[n];
    const int32_t z = zw[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      out[static_cast<size_t>(m) * N + n] =
          n < n_true ? requant_i8(acc[i][j], sx[i], b, r, s, c, z, lo, hi)
                     : static_cast<int8_t>(0);
    }
  }
}

}  // namespace

// x (M, K) int8, w (K, N) int8, five (N,) consts, out (M, N) int8; all
// row-major and contiguous, 16-byte aligned, M, N, K multiples of 64 (the
// Python wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int repro_qmatmul(const void* x, const void* w, const void* bias,
                             const void* resc, const void* wsum,
                             const void* coff, const void* zw, void* out,
                             int M, int N, int K, float lo, float hi,
                             int n_true, void* stream) {
  const dim3 grid(N / BN, M / BM);
  qmatmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(resc),
      static_cast<const int32_t*>(wsum), static_cast<const int32_t*>(coff),
      static_cast<const int32_t*>(zw), static_cast<int8_t*>(out), M, N, K,
      lo, hi, n_true);
  return static_cast<int>(cudaGetLastError());
}

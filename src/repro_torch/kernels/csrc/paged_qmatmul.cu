// Paged quantized int8 FullyConnected with the folded requant epilogue
// (Sec. 4.3 / Fig. 6; Eqs. 3/4).
//
// Replaces: src/repro/kernels/paged_matmul.py::paged_qmatmul (Pallas TPU
// kernel _paged_kernel). It runs every paged FULLY_CONNECTED layer of the
// compiled engine's kernel route (CompiledModel(paged={op: n_pages})).
//
// A page is all connections into page = N / n_pages output units: a
// (K, page) slice of W. The TPU kernel kept x (M, K) resident in VMEM and
// walked a sequential grid over pages, staging one page per step. Here one
// block owns one page: its W slice is staged in shared memory (the "one
// page resident" of Fig. 6), transposed so that four consecutive k of one
// output unit pack into one 32-bit word, together with a tile of BM rows
// of x. When K x page does not fit the block's shared memory the page is
// staged in chunks of K (and, for pages wider than PN units, in slices of
// PN units), accumulating in shared memory between chunks.
//
// What bounds it on an H100: the paged layers of the paper models have
// M <= 8 and K x N <= 16,000, so bytes and operations both come to well
// under a microsecond; launch and latency set the time. The paper's page is
// one output unit, which leaves one dot product of length K per row, so
// the design gives each output to one warp: the lanes split K into 32-bit
// words of four int8, reduce them with __dp4a, take the row sum ΣX from
// the same words (__dp4a against 0x01010101) in the same pass, and combine
// with warp shuffles. x rows are read as char4 when K % 4 == 0, else byte
// by byte (K = 1 on the sine model's first layer); the last word of a row
// is zero-padded, which adds nothing to either sum. Any M, any K, any page
// that divides N. The epilogue is requant.cuh, shared with qmatmul.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 8;                      // rows of x per block
constexpr int PN = 128;                    // page units staged at once
constexpr int SMEM_WORDS = 48 * 1024 / 4;  // default dynamic shared memory

__device__ __forceinline__ int32_t x_word(const int8_t* __restrict__ x,
                                          size_t row_off, int k, int K,
                                          bool vec) {
  if (vec) {
    const char4 v = *reinterpret_cast<const char4*>(x + row_off + k);
    return *reinterpret_cast<const int32_t*>(&v);
  }
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (k + b < K) {
      word |= static_cast<uint32_t>(static_cast<uint8_t>(x[row_off + k + b]))
              << (8 * b);
    }
  }
  return static_cast<int32_t>(word);
}

__global__ void __launch_bounds__(THREADS)
paged_qmatmul_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ resc,
                     const int32_t* __restrict__ wsum,
                     const int32_t* __restrict__ coff,
                     const int32_t* __restrict__ zw, int8_t* __restrict__ out,
                     int M, int N, int K, int page, int pn, int kcw, float lo,
                     float hi) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* acc_s = smem;              // BM x pn accumulators
  int32_t* sx_s = acc_s + BM * pn;    // BM row sums
  int32_t* xs = sx_s + BM;            // BM x kcw words of x
  const int ws_stride = kcw + 1;      // padded: conflict-free staging
  int32_t* ws = xs + BM * kcw;        // pn x ws_stride words of W, transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int kw_total = (K + 3) / 4;
  const bool vec = (K % 4) == 0;

  for (int c0 = 0; c0 < page; c0 += pn) {
    const int cols = min(pn, page - c0);
    const int n0 = blockIdx.x * page + c0;
    for (int o = tid; o < BM * pn; o += THREADS) acc_s[o] = 0;
    if (tid < BM) sx_s[tid] = 0;

    for (int q0 = 0; q0 < kw_total; q0 += kcw) {
      const int nw = min(kcw, kw_total - q0);
      for (int i = tid; i < rows * nw; i += THREADS) {
        const int r = i / nw;
        const int q = i % nw;
        xs[r * kcw + q] = x_word(x, static_cast<size_t>(m0 + r) * K,
                                 (q0 + q) * 4, K, vec);
      }
      // neighbouring threads take neighbouring units of one k row of W
      for (int i = tid; i < cols * nw; i += THREADS) {
        const int c = i % cols;
        const int q = i / cols;
        const int k = (q0 + q) * 4;
        const int8_t* src = w + static_cast<size_t>(k) * N + n0 + c;
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (k + b < K) {
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        src[static_cast<size_t>(b) * N]))
                    << (8 * b);
          }
        }
        ws[c * ws_stride + q] = static_cast<int32_t>(word);
      }
      __syncthreads();

      for (int o = warp; o < rows * cols; o += WARPS) {
        const int r = o / cols;
        const int c = o % cols;
        const int32_t* xr = xs + r * kcw;
        const int32_t* wc = ws + c * ws_stride;
        int32_t a = 0;
        int32_t s = 0;
        for (int q = lane; q < nw; q += 32) {
          const int32_t xv = xr[q];
          a = __dp4a(xv, wc[q], a);
          s = __dp4a(xv, 0x01010101, s);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        if (lane == 0) {
          acc_s[r * pn + c] += a;
          if (c == 0) sx_s[r] += s;
        }
      }
      __syncthreads();
    }

    for (int o = tid; o < rows * cols; o += THREADS) {
      const int r = o / cols;
      const int c = o % cols;
      const int n = n0 + c;
      out[static_cast<size_t>(m0 + r) * N + n] =
          requant_i8(acc_s[r * pn + c], sx_s[r], bias[n], resc[n], wsum[n],
                     coff[n], zw[n], lo, hi);
    }
    __syncthreads();
  }
}

}  // namespace

// x (M, K) int8, w (K, N) int8, five (N,) consts, out (M, N) int8; all
// row-major, contiguous, x 4-byte aligned; page > 0 divides N, M > 0, K > 0
// (the Python wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int repro_paged_qmatmul(const void* x, const void* w,
                                   const void* bias, const void* resc,
                                   const void* wsum, const void* coff,
                                   const void* zw, void* out, int M, int N,
                                   int K, int page, float lo, float hi,
                                   void* stream) {
  const int pn = page < PN ? page : PN;
  const int kw_total = (K + 3) / 4;
  int kcw = (SMEM_WORDS - BM * pn - BM - pn) / (BM + pn);
  if (kcw > kw_total) kcw = kw_total;
  const size_t smem =
      static_cast<size_t>(BM * pn + BM + BM * kcw + pn * (kcw + 1)) * 4;
  const dim3 grid(N / page, (M + BM - 1) / BM);
  paged_qmatmul_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(resc),
      static_cast<const int32_t*>(wsum), static_cast<const int32_t*>(coff),
      static_cast<const int32_t*>(zw), static_cast<int8_t*>(out), M, N, K,
      page, pn, kcw, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

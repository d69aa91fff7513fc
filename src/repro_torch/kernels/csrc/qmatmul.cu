// Quantized int8 matmul with the folded requant epilogue (Eq. 3/4/7), on
// the int8 tensor cores.
//
// Replaces: src/repro/kernels/qmatmul.py::qmatmul (Pallas TPU kernel
// _qmatmul_kernel). It runs every FULLY_CONNECTED and, through im2col,
// every CONV_2D of the compiled engine's kernel route.
//
// What bounds it on an H100: bytes. The person detector's largest call is
// conv0 at bucket 8, an 18432-row im2col matrix. At the TPU's 128-lane
// quantum it is 18432 x 1152 x 128 (23.7 MB moved: 23.7 MB / 3.35 TB/s =
// 7.1 us, against 5.4 GOP / 1,979 TOPS = 2.7 us); at the engine's 32-lane
// quantum 18432 x 288 x 32 (5.9 MB = 1.8 us). Every other call of the
// person path is smaller, so a launch costs more than its work.
//
// Design:
// * Tensor cores: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (no
//   .satfinite: int32 sums wrap as the reference's do, and are exact in any
//   order, so the result is bit-exact). One mma depth is 32 bytes of K,
//   which is why the layout quantum is 32 lanes.
// * W arrives transposed, (N, K) with K contiguous: the .col B operand then
//   reads one 32-bit word per register, like the .row A operand reads x.
//   The engine makes that copy once per planned weight (plan_layout).
// * Block tile 64x64 where N allows (128x64 for 4096 rows or more), else
//   128x32: warps of 32x32 (2 x 4 mma tiles of 16x8) either way. A
//   pipeline stage carries BK = 32, 64 or 128 bytes of K (K itself up to
//   64, else 128; a stage past K is zero-filled).
// * Staging: each stage's x tile (BM x BK) and w tile (BN x BK) are copied
//   with cp.async, 16 bytes a thread, into a ring of four shared-memory
//   buffers, three stages ahead of the mma. Rows are padded by 16 bytes, so
//   the fragment reads hit 32 distinct banks. The epilogue's per-column
//   constants travel into shared memory with the first stage.
// * ΣX in the same pass: each lane adds its A-fragment words with
//   __dp4a(a, 0x01010101, .) (rows g and g+8 of each 16-row tile), and the
//   four lanes of a row group sum theirs with two shuffles at the end. The
//   lanes that hold a row's sum are the ones that hold its accumulators.
// * Ragged M: copies of rows >= M zero-fill (cp.async with source size 0)
//   and their stores are skipped, so M is any positive size. K and N are
//   multiples of 32.
// * Epilogue: requant.cuh on each accumulator fragment, and zero for
//   columns >= n_true (the padded-layout contract the next layer's K
//   padding relies on). All 32 results of a lane are computed before any
//   store, in straight-line code: with a store (and its row test) after
//   each one, the requant chains ran one after another and the epilogue
//   took about half of a small call.
// * Launch: a programmatic dependent launch (griddepcontrol), so a call's
//   launch overlaps the previous kernel's tail on the stream; the kernel
//   reads nothing before that kernel has finished. Launch bounds name a
//   block count, so ptxas may use up to 128 registers (with the thread
//   count alone it traded registers for occupancy and spilled).
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int STAGES = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shared memory of one block: the five per-column constants of its BN
// columns, then the ring of x and w tiles (rows of BK bytes padded by 16).
template <int BM, int BN, int BK>
struct Smem {
  static constexpr int SK = BK + 16;
  static constexpr int CONSTS = 5 * BN * 4;
  static constexpr int X = CONSTS;
  static constexpr int W = X + STAGES * BM * SK;
  static constexpr int BYTES = W + STAGES * BN * SK;
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(BM * BN / 32,
                                  BM * BN >= 16384 ? 1 : 16384 / (BM * BN))
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ resc,
               const int32_t* __restrict__ wsum,
               const int32_t* __restrict__ coff,
               const int32_t* __restrict__ zw, int8_t* __restrict__ out,
               int M, int N, int K, float lo, float hi, int n_true) {
  // programmatic dependent launch: this grid may start while the previous
  // kernel on the stream finishes; nothing is read before it has
  asm volatile("griddepcontrol.wait;" ::: "memory");
  using L = Smem<BM, BN, BK>;
  constexpr int THREADS = BM * BN / 32;
  constexpr int WARPS_M = BM / 32;
  constexpr int CH = BK / 16;  // 16-byte chunks of a staged row
  extern __shared__ __align__(16) int8_t smem[];
  auto xs = reinterpret_cast<int8_t(*)[BM][L::SK]>(smem + L::X);
  auto ws = reinterpret_cast<int8_t(*)[BN][L::SK]>(smem + L::W);
  const float* c_bias = reinterpret_cast<const float*>(smem);
  const float* c_resc = c_bias + BN;
  const int32_t* c_wsum = reinterpret_cast<const int32_t*>(c_resc + BN);
  const int32_t* c_coff = c_wsum + BN;
  const int32_t* c_zw = c_coff + BN;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;    // row group of the mma fragments
  const int t4 = lane % 4;   // lane within the group
  const int wm = (warp % WARPS_M) * 32;
  const int wn = (warp / WARPS_M) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int steps = (K + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int c = tid; c < BM * CH; c += THREADS) {
      const int r = c / CH;
      const int kc = (c % CH) * 16;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(&xs[stage][r][kc],
                 ok ? x + static_cast<size_t>(m0 + r) * K + k0 + kc : x, ok);
    }
#pragma unroll
    for (int c = tid; c < BN * CH; c += THREADS) {
      const int r = c / CH;
      const int kc = (c % CH) * 16;
      const bool ok = k0 + kc < K;
      cp_async16(&ws[stage][r][kc],
                 ok ? w + static_cast<size_t>(n0 + r) * K + k0 + kc : w, ok);
    }
  };

  // the epilogue's constants travel with the first stage
  for (int c = tid; c < 5 * BN / 4; c += THREADS) {
    const int which = c / (BN / 4);
    const int col = n0 + (c % (BN / 4)) * 4;
    const void* src = which == 0   ? static_cast<const void*>(bias + col)
                      : which == 1 ? static_cast<const void*>(resc + col)
                      : which == 2 ? static_cast<const void*>(wsum + col)
                      : which == 3 ? static_cast<const void*>(coff + col)
                                   : static_cast<const void*>(zw + col);
    cp_async16(smem + c * 16, src, true);
  }

  int32_t acc[2][4][4];
  int32_t sx[2][2];  // [m tile][row g, row g + 8]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sx[i][0] = sx[i][1] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s * BK);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's) ...
    __syncthreads();              // ... everyone's, and step s-1 is consumed
    const int next = s + STAGES - 1;
    if (next < steps) load(next % STAGES, next * BK);
    cp_async_commit();
    const int st = s % STAGES;

#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {  // one mma depth at a time
      uint32_t a[2][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = &xs[st][wm + i * 16 + g][kb + t4 * 4];
        const int8_t* r8 = &xs[st][wm + i * 16 + g + 8][kb + t4 * 4];
        a[i][0] = word(r0);
        a[i][1] = word(r8);
        a[i][2] = word(r0 + 16);
        a[i][3] = word(r8 + 16);
        sx[i][0] = __dp4a(static_cast<int>(a[i][0]), 0x01010101, sx[i][0]);
        sx[i][0] = __dp4a(static_cast<int>(a[i][2]), 0x01010101, sx[i][0]);
        sx[i][1] = __dp4a(static_cast<int>(a[i][1]), 0x01010101, sx[i][1]);
        sx[i][1] = __dp4a(static_cast<int>(a[i][3]), 0x01010101, sx[i][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c = &ws[st][wn + j * 8 + g][kb + t4 * 4];
        b[j][0] = word(c);
        b[j][1] = word(c + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
    }
  }

  // the next kernel on the stream may start its launch now; it reads
  // nothing of ours before this grid has finished
  asm volatile("griddepcontrol.launch_dependents;");

  // full row sums: the four lanes of a group hold disjoint K words
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sx[i][h] += __shfl_xor_sync(0xffffffffu, sx[i][h], 1);
      sx[i][h] += __shfl_xor_sync(0xffffffffu, sx[i][h], 2);
    }
  }

  // epilogue, first every result (straight-line code, so the 32
  // independent requant chains of a lane interleave), then the stores
  char2 q[4][2][2];  // [n tile][m tile][rows g, g + 8]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nl = wn + j * 8 + t4 * 2;  // this lane's two columns
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int8_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int8_t r = requant_i8(acc[i][j][2 * h + e], sx[i][h],
                                      c_bias[nl + e], c_resc[nl + e],
                                      c_wsum[nl + e], c_coff[nl + e],
                                      c_zw[nl + e], lo, hi);
          v[e] = n0 + nl + e < n_true ? r : static_cast<int8_t>(0);
        }
        q[j][i][h] = make_char2(v[0], v[1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m < M) {
        char2* row = reinterpret_cast<char2*>(out + static_cast<size_t>(m) * N +
                                              n0 + wn + t4 * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j * 4] = q[j][i][h];
      }
    }
  }
}

template <int BM, int BN, int BK>
int launch(const void* x, const void* w, const void* bias, const void* resc,
           const void* wsum, const void* coff, const void* zw, void* out,
           int M, int N, int K, float lo, float hi, int n_true,
           cudaStream_t stream) {
  constexpr int bytes = Smem<BM, BN, BK>::BYTES;
  if (bytes > 48 * 1024) {  // once per tile: dynamic shared memory above 48 KB
    static const cudaError_t set = cudaFuncSetAttribute(
        qmatmul_kernel<BM, BN, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(BM * BN / 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, qmatmul_kernel<BM, BN, BK>,
                     static_cast<const int8_t*>(x),
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(resc),
                     static_cast<const int32_t*>(wsum),
                     static_cast<const int32_t*>(coff),
                     static_cast<const int32_t*>(zw), static_cast<int8_t*>(out),
                     M, N, K, lo, hi, n_true);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) int8, w (N, K) int8 (the weight transposed: K contiguous), five
// (N,) consts, out (M, N) int8; all contiguous and 16-byte aligned; M any
// positive size, K and N multiples of 32, N a multiple of bn; (bm, bn, bk)
// one of the tiles built below (the Python wrapper checks and chooses).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// tile that is not built).
extern "C" int repro_qmatmul(const void* x, const void* w, const void* bias,
                             const void* resc, const void* wsum,
                             const void* coff, const void* zw, void* out,
                             int M, int N, int K, float lo, float hi,
                             int n_true, int bm, int bn, int bk,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_QMATMUL_TILE(BM_, BN_, BK_)                                   \
  if (bm == BM_ && bn == BN_ && bk == BK_) {                                \
    return launch<BM_, BN_, BK_>(x, w, bias, resc, wsum, coff, zw, out, M, N, \
                                 K, lo, hi, n_true, s);                     \
  }
  REPRO_QMATMUL_TILE(128, 32, 32)
  REPRO_QMATMUL_TILE(128, 32, 64)
  REPRO_QMATMUL_TILE(128, 32, 128)
  REPRO_QMATMUL_TILE(64, 64, 32)
  REPRO_QMATMUL_TILE(64, 64, 64)
  REPRO_QMATMUL_TILE(64, 64, 128)
  REPRO_QMATMUL_TILE(128, 64, 32)
  REPRO_QMATMUL_TILE(128, 64, 64)
  REPRO_QMATMUL_TILE(128, 64, 128)
#undef REPRO_QMATMUL_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

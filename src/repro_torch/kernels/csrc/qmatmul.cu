// Quantized int8 matmul with the folded requant epilogue (Eq. 3/4/7), on
// the int8 tensor cores.
//
// Replaces: src/repro/kernels/qmatmul.py::qmatmul (Pallas TPU kernel
// _qmatmul_kernel). qmatmul_kernel runs every FULLY_CONNECTED and every
// 1x1/s1 CONV_2D (a reshape) of the compiled engine's kernel route;
// qmatmul_kernel_conv, below, every multi-tap planned CONV_2D as an
// implicit GEMM (no im2col matrix in device memory).
//
// What bounds it on an H100: bytes. At the TPU's 128-lane quantum person
// conv0 at bucket 8 would be an 18432 x 1152 x 128 product (23.7 MB moved:
// 7.1 us at 3.35 TB/s, against 5.4 GOP / 1,979 TOPS = 2.7 us). Every other
// call of the person path is smaller, so a launch costs more than its work.
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
//
// The fused conv (qmatmul_kernel_conv; the name keeps "qmatmul_kernel", so
// a trace counts conv work against this kernel family):
// * Why: a planned conv's input is lane-padded (in_lanes = round_up(cin,
//   32)), so an im2col matrix of kh*kw*in_lanes columns is almost all
//   zeros for a one-channel input. Speech's 10x8/s2 conv at bucket 256
//   made a 128,000 x 2,560 matrix (327.7 MB written, then read) for 80 real
//   bytes a row; person's conv0 a 288-column one for 9. The kernel reads
//   the activation where it lies and contracts K packed instead: K = KP =
//   round_up(kh*kw*c_true, 32) (96 and 32), the weight packed to match once
//   at plan time (preprocess.pack_conv_taps).
// * A operand: a block of 128 threads takes 128 output positions (rows of
//   B*OH*OW) by 32 columns of N' and builds its A tile in shared memory
//   slab by slab (BK = 32, 64 or 128 bytes of KP, as qmatmul's stages): a
//   table of the slab's taps (offset, tap row, tap column) is built in
//   shared memory, then each thread gathers its row's real lanes, a byte a
//   tap and channel, through L1 (a row's taps overlap its neighbours'
//   pixels, so the band and its halo come from device memory about once).
//   Taps outside the image read z_X (the SAME border, as qdwconv fills
//   it), K past kh*kw*c_true and rows >= M read 0. So the A tile equals the
//   packed im2col rows, ΣX included, and the folded Eq. (7) result is
//   bit-identical to im2col + qmatmul_kernel.
// * The mma, ΣX and the epilogue are qmatmul_kernel's (mma_slab,
//   epilogue); the weight slab travels by cp.async while the A slab is
//   gathered. No ring: a block holds one slab (at most 25 KB), and the
//   blocks resident on an SM hide each other's gathers.
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

// The five per-column epilogue constants of the block's BN columns, to the
// start of shared memory (cp.async, committed with the first stage).
template <int BN, int THREADS>
__device__ __forceinline__ void load_consts(
    int8_t* smem, const float* bias, const float* resc, const int32_t* wsum,
    const int32_t* coff, const int32_t* zw, int n0, int tid) {
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
}

// One staged slab of BK bytes of K, one mma depth at a time: a warp's
// 32x32 tile accumulates x . w^T, and the ΣX of its rows from the same A
// fragments (rows g and g+8 of each 16-row tile).
template <int BK, int SK>
__device__ __forceinline__ void mma_slab(const int8_t (*xs)[SK],
                                         const int8_t (*ws)[SK], int wm,
                                         int wn, int g, int t4,
                                         int32_t (&acc)[2][4][4],
                                         int32_t (&sx)[2][2]) {
#pragma unroll
  for (int kb = 0; kb < BK; kb += 32) {
    uint32_t a[2][4];
    uint32_t b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r0 = &xs[wm + i * 16 + g][kb + t4 * 4];
      const int8_t* r8 = &xs[wm + i * 16 + g + 8][kb + t4 * 4];
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
      const int8_t* c = &ws[wn + j * 8 + g][kb + t4 * 4];
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

// The epilogue of a warp's 32x32 tile: ΣX summed over the four lanes of a
// row group (they hold disjoint K words), every result first (straight-line
// code, so the 32 independent requant chains of a lane interleave), then
// the stores of the rows < M. Columns >= n_true are written as zero.
template <int BN>
__device__ __forceinline__ void epilogue(const int8_t* smem,
                                         int32_t (&acc)[2][4][4],
                                         int32_t (&sx)[2][2],
                                         int8_t* __restrict__ out, int M,
                                         int N, int m0, int n0, int wm,
                                         int wn, int g, int t4, float lo,
                                         float hi, int n_true) {
  const float* c_bias = reinterpret_cast<const float*>(smem);
  const float* c_resc = c_bias + BN;
  const int32_t* c_wsum = reinterpret_cast<const int32_t*>(c_resc + BN);
  const int32_t* c_coff = c_wsum + BN;
  const int32_t* c_zw = c_coff + BN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sx[i][h] += __shfl_xor_sync(0xffffffffu, sx[i][h], 1);
      sx[i][h] += __shfl_xor_sync(0xffffffffu, sx[i][h], 2);
    }
  }
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
  load_consts<BN, THREADS>(smem, bias, resc, wsum, coff, zw, n0, tid);

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
    mma_slab<BK, L::SK>(xs[st], ws[st], wm, wn, g, t4, acc, sx);
  }

  // the next kernel on the stream may start its launch now; it reads
  // nothing of ours before this grid has finished
  asm volatile("griddepcontrol.launch_dependents;");
  epilogue<BN>(smem, acc, sx, out, M, N, m0, n0, wm, wn, g, t4, lo, hi,
               n_true);
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

// Geometry of a fused conv: the input (B, H, W, L) int8 NHWC, of whose L
// lanes the first c are real; output rows m = (b, oh, ow) of M = B*OH*OW;
// tap (i, j) of row m reads pixel (oh*sh - pt + i, ow*sw - pl + j), or the
// border value z_x outside the image; K = kh*kw*c packed taps.
struct ConvGeo {
  int H, W, L, OH, OW, kw, sh, sw, pt, pl, c, K, z_x;
};

// The fused conv's block: 128 output rows, the 32 columns of N' (every
// planned conv's N' is a multiple of 32), one thread a row.
constexpr int CONV_BM = 128;
constexpr int CONV_BN = 32;

// Shared memory of a fused conv block: the per-column constants, the tap
// table of one slab (BK entries), its A tile and its weight tile.
template <int BK>
struct ConvSmem {
  static constexpr int SK = BK + 16;
  static constexpr int TAB = 5 * CONV_BN * 4;
  static constexpr int X = TAB + BK * 8;
  static constexpr int W = X + CONV_BM * SK;
  static constexpr int BYTES = W + CONV_BN * SK;
};

template <int BK>
__global__ void __launch_bounds__(CONV_BM, 16384 / (CONV_BM * CONV_BN))
qmatmul_kernel_conv(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ resc,
                    const int32_t* __restrict__ wsum,
                    const int32_t* __restrict__ coff,
                    const int32_t* __restrict__ zw, int8_t* __restrict__ out,
                    ConvGeo geo, int M, int N, int KP, float lo, float hi,
                    int n_true) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  using L = ConvSmem<BK>;
  constexpr int THREADS = CONV_BM;  // 4 warps of 32 rows x 32 columns
  constexpr int CH = BK / 16;
  extern __shared__ __align__(16) int8_t smem[];
  int2* tab = reinterpret_cast<int2*>(smem + L::TAB);
  auto xs = reinterpret_cast<int8_t(*)[L::SK]>(smem + L::X);
  auto ws = reinterpret_cast<int8_t(*)[L::SK]>(smem + L::W);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wm = (tid / 32) * 32;
  const int m0 = blockIdx.y * CONV_BM;
  const int n0 = blockIdx.x * CONV_BN;

  load_consts<CONV_BN, THREADS>(smem, bias, resc, wsum, coff, zw, n0, tid);

  // this thread's A row: its output position, and the offset of the pixel
  // under tap (0, 0) (outside the image at a border; only read in bounds)
  const bool row_ok = m0 + tid < M;
  int ih0 = 0, iw0 = 0;
  long long base = 0;
  if (row_ok) {
    const int m = m0 + tid;
    const int ow = m % geo.OW;
    const int oh = (m / geo.OW) % geo.OH;
    const int b = m / geo.OW / geo.OH;
    ih0 = oh * geo.sh - geo.pt;
    iw0 = ow * geo.sw - geo.pl;
    base = ((static_cast<long long>(b) * geo.H + ih0) * geo.W + iw0) * geo.L;
  }
  const uint32_t zx = static_cast<uint8_t>(geo.z_x);

  int32_t acc[2][4][4];
  int32_t sx[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sx[i][0] = sx[i][1] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

  for (int k0 = 0; k0 < KP; k0 += BK) {
    __syncthreads();  // the previous slab is consumed
    // the slab's taps: (offset from tap (0, 0), i << 16 | j), or y = -1
    // for the zeros past K
    for (int kk = tid; kk < BK; kk += THREADS) {
      const int k = k0 + kk;
      int2 e = make_int2(0, -1);
      if (k < geo.K) {
        const int tap = k / geo.c;
        const int ch = k - tap * geo.c;
        const int i = tap / geo.kw;
        const int j = tap - i * geo.kw;
        e = make_int2((i * geo.W + j) * geo.L + ch, (i << 16) | j);
      }
      tab[kk] = e;
    }
#pragma unroll
    for (int c = tid; c < CONV_BN * CH; c += THREADS) {
      const int r = c / CH;
      const int kc = (c % CH) * 16;
      const bool ok = k0 + kc < KP;
      cp_async16(&ws[r][kc],
                 ok ? w + static_cast<size_t>(n0 + r) * KP + k0 + kc : w, ok);
    }
    cp_async_commit();
    __syncthreads();  // the tap table is in place

    // gather this thread's row of the A slab, four bytes to a word: real
    // lanes of each tap, z_x at the border, zeros past K and in rows >= M
#pragma unroll
    for (int wd = 0; wd < BK / 4; ++wd) {
      uint32_t v = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int2 e = tab[wd * 4 + u];
        if (row_ok && e.y >= 0) {
          const int ih = ih0 + (e.y >> 16);
          const int iw = iw0 + (e.y & 0xffff);
          const uint32_t byte =
              static_cast<unsigned>(ih) < static_cast<unsigned>(geo.H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(geo.W)
                  ? static_cast<uint8_t>(x[base + e.x])
                  : zx;
          v |= byte << (8 * u);
        }
      }
      *reinterpret_cast<uint32_t*>(&xs[tid][wd * 4]) = v;
    }
    cp_async_wait<0>();
    __syncthreads();  // the A slab and the weight slab are in place
    mma_slab<BK, L::SK>(xs, ws, wm, 0, g, t4, acc, sx);
  }

  asm volatile("griddepcontrol.launch_dependents;");
  epilogue<CONV_BN>(smem, acc, sx, out, M, N, m0, n0, wm, 0, g, t4, lo, hi,
                    n_true);
}

template <int BK>
int launch_conv(const void* x, const void* w, const void* bias,
                const void* resc, const void* wsum, const void* coff,
                const void* zw, void* out, const ConvGeo& geo, int M, int N,
                int KP, float lo, float hi, int n_true, cudaStream_t stream) {
  constexpr int bytes = ConvSmem<BK>::BYTES;
  static_assert(bytes <= 48 * 1024, "a conv tile fits the default 48 KB");
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / CONV_BN, (M + CONV_BM - 1) / CONV_BM);
  cfg.blockDim = dim3(CONV_BM);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, qmatmul_kernel_conv<BK>,
                     static_cast<const int8_t*>(x),
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(resc),
                     static_cast<const int32_t*>(wsum),
                     static_cast<const int32_t*>(coff),
                     static_cast<const int32_t*>(zw), static_cast<int8_t*>(out),
                     geo, M, N, KP, lo, hi, n_true);
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

// x (B, H, W, L) int8 NHWC (lanes >= c zero), w (N, KP) int8: the packed
// taps of the filter (KP = round_up(kh*kw*c, 32), tap-major, channel-minor,
// K contiguous), five (N,) consts, out (B, OH, OW, N) int8 with M =
// B*OH*OW; w, consts and out 16-byte aligned; N a multiple of 32; bk one of
// the K slabs built below (the Python wrapper checks and chooses). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a slab
// that is not built).
extern "C" int repro_qconv(const void* x, const void* w, const void* bias,
                           const void* resc, const void* wsum,
                           const void* coff, const void* zw, void* out,
                           int M, int N, int KP, int H, int W, int L, int OH,
                           int OW, int kw, int sh, int sw, int pt, int pl,
                           int c, int K, int z_x, float lo, float hi,
                           int n_true, int bk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvGeo geo = {H, W, L, OH, OW, kw, sh, sw, pt, pl, c, K, z_x};
  if (bk == 32)
    return launch_conv<32>(x, w, bias, resc, wsum, coff, zw, out, geo, M, N,
                           KP, lo, hi, n_true, s);
  if (bk == 64)
    return launch_conv<64>(x, w, bias, resc, wsum, coff, zw, out, geo, M, N,
                           KP, lo, hi, n_true, s);
  if (bk == 128)
    return launch_conv<128>(x, w, bias, resc, wsum, coff, zw, out, geo, M,
                            N, KP, lo, hi, n_true, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

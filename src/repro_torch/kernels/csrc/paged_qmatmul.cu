// Paged quantized int8 FullyConnected with the folded requant epilogue
// (Sec. 4.3 / Fig. 6; Eqs. 3/4).
//
// Replaces: src/repro/kernels/paged_matmul.py::paged_qmatmul (Pallas TPU
// kernel _paged_kernel). It runs every paged FULLY_CONNECTED layer of the
// compiled engine's kernel route (CompiledModel(paged={op: n_pages})).
//
// A page is all connections into page = N / n_pages output units: a
// (K, page) slice of W. The TPU kernel kept x (M, K) resident in VMEM and
// walked a sequential grid over pages, staging one page per step.
//
// What bounds it on an H100: the launch and the chain of dependent loads.
// The paged layers of the paper models have M <= 8 and K x N <= 65,536, so
// bytes and operations come to well under a microsecond; a call costs what
// one block's staging round trips, reductions and epilogue cost in series.
//
// Design:
// * Pages split across blocks. The grid is (pages x column slices of at
//   most SC units, row tiles of 8): a block stages only its slice of one
//   page (one page resident per block, as in Fig. 6; on the card all
//   blocks run at once, so paging here is a bit-exact route, not a memory
//   saving). The wrapper's rule (kernels/paged_matmul.py::paged_split) picks
//   SC so that the 256 x 256 FC at pages of 128 runs 16 blocks.
// * Coalesced staging with cp.async. x rows arrive as 16-byte copies where
//   K % 16 == 0 (else as words built from bytes: K = 1 on the sine model).
//   W arrives as whole 16-byte segments of its K rows, n fastest: the
//   segments covering each row's slice (rows wider than a few segments),
//   or the contiguous range of the chunk's rows (narrow W, such as
//   speech's 4000 x 4, where a segment holds several rows). The block keeps
//   only its columns: it transposes them in shared memory so that four
//   consecutive k of one unit pack into one 32-bit word. All copies of a
//   stage are issued before one wait; K longer than the shared-memory
//   budget is staged in chunks.
// * Dot products: each output is one warp's, its lanes over K in words of
//   four int8 (__dp4a), ΣX from the same words (__dp4a against
//   0x01010101), a shuffle tree at the end. Where a block has fewer
//   outputs than warps (speech: one unit, 8 rows, K = 4000), the warps
//   split K as well: each writes its partial sums to shared memory and
//   one thread per output adds them in warp order. Integer sums wrap
//   identically in any order, and the order is fixed besides: no atomics,
//   the same bits every call.
// * Epilogue: requant.cuh, shared with qmatmul, one thread per output; the
//   constants are loaded before the staging wait.
// * Launch: a programmatic dependent launch (griddepcontrol); launch bounds
//   name a block count as well as the thread count.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 8;  // rows of x per block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Shared memory of one block: raw W segments (16-byte aligned, first), x
// words, W transposed, then the sums. flat: the contiguous range of the
// chunk's rows; else rowb bytes of segments per row.
struct Layout {
  int kcw, rowb, wraw, xs, wt, acc, sx, part, psx, bytes;
  __host__ __device__ Layout(int N, int sc, int kc, int flat)
      : kcw(kc / 4),
        rowb(16 * ((sc + 15) / 16 + 1)),
        wraw(0),
        xs(round16(flat ? kc * N + 32 : kc * rowb)),
        wt(xs + BM * kcw * 4),
        acc(wt + sc * (kcw + 1) * 4),
        sx(acc + BM * sc * 4),
        part(sx + BM * 4),
        psx(part + WARPS * 4),
        bytes(psx + WARPS * BM * 4) {}
};

__global__ void __launch_bounds__(THREADS, 2)
paged_qmatmul_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ resc,
                     const int32_t* __restrict__ wsum,
                     const int32_t* __restrict__ coff,
                     const int32_t* __restrict__ zw, int8_t* __restrict__ out,
                     int M, int N, int K, int page, int sc, int kc, int flat,
                     int x_vec, float lo, float hi) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const Layout L(N, sc, kc, flat);
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* wraw = smem + L.wraw;
  int32_t* xs = reinterpret_cast<int32_t*>(smem + L.xs);
  int32_t* wt = reinterpret_cast<int32_t*>(smem + L.wt);
  int32_t* acc_s = reinterpret_cast<int32_t*>(smem + L.acc);
  int32_t* sx_s = reinterpret_cast<int32_t*>(smem + L.sx);
  int32_t* part = reinterpret_cast<int32_t*>(smem + L.part);
  int32_t* psx = reinterpret_cast<int32_t*>(smem + L.psx);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int slices = (page + sc - 1) / sc;
  const int n0 = (blockIdx.x / slices) * page + (blockIdx.x % slices) * sc;
  const int cols = min(sc, page - (blockIdx.x % slices) * sc);
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int outs = rows * cols;
  // K groups: with fewer outputs than warps, the warps split K too
  int kg = 1;
  while (kg * 2 * outs <= WARPS) kg *= 2;
  const int wpg = WARPS / kg;  // warps per K group
  const int grp = warp / wpg;

  // the epilogue's constants, in flight with the first stage
  float e_bias = 0.f, e_resc = 0.f;
  int32_t e_wsum = 0, e_coff = 0, e_zw = 0;
  if (tid < outs) {
    const int n = n0 + tid % cols;
    e_bias = bias[n];
    e_resc = resc[n];
    e_wsum = wsum[n];
    e_coff = coff[n];
    e_zw = zw[n];
  }
  for (int o = tid; o < BM * sc; o += THREADS) acc_s[o] = 0;
  if (tid < BM) sx_s[tid] = 0;
  const uintptr_t wbase = reinterpret_cast<uintptr_t>(w);

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);  // bytes of K in this chunk
    const int nw = (kn + 3) / 4;
    // -- stage x ----------------------------------------------------------
    if (x_vec) {
      const int segs = kn / 16;
      for (int i = tid; i < rows * segs; i += THREADS) {
        const int r = i / segs;
        const int s = i % segs;
        cp_async16(xs + r * L.kcw + s * 4,
                   x + static_cast<size_t>(m0 + r) * K + k0 + s * 16);
      }
    } else {
      for (int i = tid; i < rows * nw; i += THREADS) {
        const int r = i / nw;
        const int q = i % nw;
        const int8_t* src = x + static_cast<size_t>(m0 + r) * K + k0 + 4 * q;
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (4 * q + b < kn) {
            word |= static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                    << (8 * b);
          }
        }
        xs[r * L.kcw + q] = static_cast<int32_t>(word);
      }
    }
    // -- stage W: whole 16-byte segments --------------------------------
    uintptr_t seg0 = 0;
    if (flat) {
      seg0 = (wbase + static_cast<size_t>(k0) * N + n0) & ~uintptr_t(15);
      const uintptr_t end = wbase + static_cast<size_t>(k0 + kn - 1) * N +
                            n0 + cols;
      const int segs = static_cast<int>((end - seg0 + 15) / 16);
      for (int s = tid; s < segs; s += THREADS) {
        cp_async16(wraw + 16 * s, reinterpret_cast<const void*>(seg0 + 16 * s));
      }
    } else {
      const int per_row = L.rowb / 16;
      for (int i = tid; i < kn * per_row; i += THREADS) {
        const int kr = i / per_row;
        const int s = i % per_row;
        const uintptr_t a = wbase + static_cast<size_t>(k0 + kr) * N + n0;
        const uintptr_t first = a & ~uintptr_t(15);
        if (first + 16 * s < a + cols) {
          cp_async16(wraw + kr * L.rowb + 16 * s,
                     reinterpret_cast<const void*>(first + 16 * s));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // -- keep the block's columns, transposed: wt[c][q] ---------------------
    for (int i = tid; i < cols * nw; i += THREADS) {
      const int c = i / nw;
      const int q = i % nw;
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kr = 4 * q + b;
        if (kr < kn) {
          const uintptr_t a = wbase + static_cast<size_t>(k0 + kr) * N + n0;
          const int off = flat ? static_cast<int>(a - seg0)
                               : kr * L.rowb + static_cast<int>(a & 15);
          word |= static_cast<uint32_t>(static_cast<uint8_t>(wraw[off + c]))
                  << (8 * b);
        }
      }
      wt[c * (L.kcw + 1) + q] = static_cast<int32_t>(word);
    }
    __syncthreads();

    // -- dot products: a warp per output (and per K group) --------------
    const int q_lo = grp * nw / kg;
    const int q_hi = (grp + 1) * nw / kg;
    for (int o = warp % wpg; o < outs; o += wpg) {
      const int r = o / cols;
      const int c = o % cols;
      const int32_t* xr = xs + r * L.kcw;
      const int32_t* wc = wt + c * (L.kcw + 1);
      int32_t a = 0;
      int32_t s = 0;
      for (int q = q_lo + lane; q < q_hi; q += 32) {
        const int32_t xv = xr[q];
        a = __dp4a(xv, wc[q], a);
        s = __dp4a(xv, 0x01010101, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
      }
      if (c == 0) {  // warp-uniform: the row sum, once per row
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
      }
      if (lane == 0) {
        if (kg == 1) {
          acc_s[o] += a;
          if (c == 0) sx_s[r] += s;
        } else {
          part[grp * outs + o] = a;
          if (c == 0) psx[grp * BM + r] = s;
        }
      }
    }
    __syncthreads();
    if (kg > 1) {  // the K groups' partial sums, in group order
      if (tid < outs) {
        int32_t a = acc_s[tid];
        for (int g = 0; g < kg; ++g) a += part[g * outs + tid];
        acc_s[tid] = a;
      } else if (tid >= 128 && tid - 128 < rows) {
        int32_t s = sx_s[tid - 128];
        for (int g = 0; g < kg; ++g) s += psx[g * BM + tid - 128];
        sx_s[tid - 128] = s;
      }
      __syncthreads();
    }
  }

  if (tid < outs) {
    const int r = tid / cols;
    const int c = tid % cols;
    out[static_cast<size_t>(m0 + r) * N + n0 + c] = requant_i8(
        acc_s[tid], sx_s[r], e_bias, e_resc, e_wsum, e_coff, e_zw, lo, hi);
  }
}

}  // namespace

// x (M, K) int8, w (K, N) int8, five (N,) consts, out (M, N) int8; all
// row-major and contiguous; page > 0 divides N, M > 0, K > 0; (sc, kc,
// flat) from kernels/paged_matmul.py::paged_split (sc <= 32, kc a multiple
// of 16); x_vec: K % 16 == 0 and x 16-byte aligned. W is read in whole
// 16-byte aligned segments, which may reach up to 15 bytes past either end
// of it (never past a 16-byte boundary). Returns cudaGetLastError() after
// the launch.
extern "C" int repro_paged_qmatmul(const void* x, const void* w,
                                   const void* bias, const void* resc,
                                   const void* wsum, const void* coff,
                                   const void* zw, void* out, int M, int N,
                                   int K, int page, int sc, int kc, int flat,
                                   int x_vec, float lo, float hi,
                                   void* stream) {
  const Layout L(N, sc, kc, flat);
  if (sc < 1 || sc * BM > THREADS / 2 || kc % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L.bytes > 48 * 1024) {
    static int granted = 48 * 1024;  // once per size: above the default 48 KB
    if (L.bytes > granted) {
      const cudaError_t set = cudaFuncSetAttribute(
          paged_qmatmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          L.bytes);
      if (set != cudaSuccess) return static_cast<int>(set);
      granted = L.bytes;
    }
  }
  const int slices = (N / page) * ((page + sc - 1) / sc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, paged_qmatmul_kernel,
                     static_cast<const int8_t*>(x),
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(resc),
                     static_cast<const int32_t*>(wsum),
                     static_cast<const int32_t*>(coff),
                     static_cast<const int32_t*>(zw), static_cast<int8_t*>(out),
                     M, N, K, page, sc, kc, flat, x_vec, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

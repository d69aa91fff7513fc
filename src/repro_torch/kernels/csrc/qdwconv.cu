// Quantized depthwise conv with the SAME border fused in and the folded
// requant epilogue (Eq. 9/10).
//
// Replaces: src/repro/kernels/qdwconv.py::qdwconv (Pallas TPU kernel
// _qdwconv_kernel). It runs every DEPTHWISE_CONV_2D of the compiled engine's
// kernel route (13 per person-detector forward).
//
// What bounds it on an H100: bytes, then the launch. A depthwise conv does
// 2 * kh * kw operations per output and has no reduction across channels
// for a tensor core to take, so the floor is the bytes: each input read once
// and each output written once at 3.35 TB/s, well under a microsecond at
// every person-detector layer. What sets a call's time is the chain of
// dependent steps one block walks: launch, loads, tap loop, epilogue, store.
// Taps read from device memory in a loop over runtime kh, kw go out one or
// two loads at a time (tools/sass_loads.py), a round trip each.
//
// Design (one round trip to device memory, short chains):
// * The SAME border is fused in. The caller passes the unpadded activation
//   and the pads (top, bottom, left, right); a tap that falls outside x
//   reads the input zero point z_x, on every lane (the padding lanes'
//   outputs are zeroed by c_true). No pad pass runs before the kernel.
//   Pads of zero are the VALID contract on a pre-padded input.
// * A block owns one image, a band of TH output rows, TPG output columns
//   and CG groups of 4 channels. It stages the band's input rows with their
//   halo ((TH - 1) * sh + kh rows, (TPG - 1) * sw + kw columns), its
//   weights and its five per-channel constants into shared memory once,
//   with cp.async in pieces of 16 bytes (8 or 4 where the block's channels
//   or the operands' alignment allow no more), neighbouring threads on
//   neighbouring addresses, all issued before one wait. Halo cells outside
//   x are stored as z_x. The wrapper's rule (kernels/qdwconv.py::dw_tile)
//   keeps a block's channels to a whole 32-byte sector at least and aims at
//   one block per SM: a thinner band first, then fewer channels a block.
// * A thread owns 4 channels of one output pixel. At these sizes the
//   shortest chain a thread walks is what counts: in a sweep of tiles on the
//   H100, 16 or 32 outputs a thread (the inputs of neighbouring pixels
//   reused from registers) were slower per person forward.
// * ΣXW and ΣX in one sum: acc = Σ x * (w - z_w) equals ΣXW - z_w ΣX modulo
//   2^32, which is all the epilogue's wrapping int32 arithmetic keeps, so
//   requant.cuh runs with sum_x = 0 and z_w = 0 and the result is
//   bit-exact. Channel groups at or above c_true skip the taps and store
//   zeros.
// * Geometry at compile time: (kh, kw, sh, sw) = (3, 3, 1, 1) and
//   (3, 3, 2, 2) are template instantiations whose tap loops unroll fully;
//   a generic instantiation with runtime geometry serves every other kernel
//   size and stride.
// * Launch: a programmatic dependent launch (griddepcontrol), as qmatmul.
//   Launch bounds name a block count as well as the thread count, so ptxas
//   need not trade registers for occupancy.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int V = 4;  // channels a thread owns

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES));
  }
}

// signed byte e of a word, as unsigned int32 (for wrapping products)
__device__ __forceinline__ uint32_t sbyte(uint32_t a, int e) {
  return static_cast<uint32_t>(
      static_cast<int32_t>(static_cast<int8_t>(a >> (8 * e))));
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Shared memory of one block: input cells (rows_in x cols_in x CG*4 bytes),
// weights (kh*kw x CG*4 bytes), then the five constants (5 x CG*4 words).
struct Layout {
  int rows_in, cols_in, cgv, xs_bytes, ws_bytes, bytes;
  __host__ __device__ Layout(int th, int tpg, int cg, int kh, int kw, int sh,
                             int sw)
      : rows_in((th - 1) * sh + kh),
        cols_in((tpg - 1) * sw + kw),
        cgv(cg * V),
        xs_bytes(round16(rows_in * cols_in * cgv)),
        ws_bytes(round16(kh * kw * cgv)),
        bytes(xs_bytes + ws_bytes + 5 * cgv * 4) {}
};

// Copy the block's input band with its halo (z_x where it falls outside x)
// and its weights into shared memory in U-byte pieces, neighbouring
// threads on neighbouring addresses.
template <int U>
__device__ __forceinline__ void stage(const int8_t* __restrict__ x,
                                      const int8_t* __restrict__ w,
                                      int8_t* xs, int8_t* wsm, const Layout& L,
                                      int b, int H, int W, int C, int c_base,
                                      int iy0, int ix0, int taps,
                                      uint32_t zb) {
  const int per = L.cgv / U;  // pieces of one cell (pixel)
  const int n = L.rows_in * L.cols_in * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int cell = i / per;
    const int iy = iy0 + cell / L.cols_in;
    const int ix = ix0 + cell % L.cols_in;
    int8_t* dst = xs + static_cast<size_t>(i) * U;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      cp_async<U>(dst, x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C +
                           c_base + (i % per) * U);
    } else {
#pragma unroll
      for (int q = 0; q < U / 4; ++q) reinterpret_cast<uint32_t*>(dst)[q] = zb;
    }
  }
  for (int i = threadIdx.x; i < taps * per; i += blockDim.x) {
    cp_async<U>(wsm + static_cast<size_t>(i) * U,
                w + static_cast<size_t>(i / per) * C + c_base + (i % per) * U);
  }
}

// KH == 0: runtime geometry (kh_, kw_, sh_, sw_); else those are ignored.
template <int KH, int KW, int SH, int SW>
__global__ void __launch_bounds__(MAX_THREADS, 4)
qdwconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ resc,
               const int32_t* __restrict__ wsum,
               const int32_t* __restrict__ coff,
               const int32_t* __restrict__ zw, int8_t* __restrict__ out,
               int H, int W, int C, int OH, int OW, int kh_, int kw_,
               int sh_, int sw_, int pt, int pl, int z_x, int cg, int th,
               int tpg, float lo, float hi, int c_true) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int kh = KH ? KH : kh_;
  const int kw = KH ? KW : kw_;
  const int sh = KH ? SH : sh_;
  const int sw = KH ? SW : sw_;
  const Layout L(th, tpg, cg, kh, kw, sh, sw);
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;
  int8_t* wsm = smem + L.xs_bytes;
  int32_t* cs = reinterpret_cast<int32_t*>(wsm + L.ws_bytes);

  const int ctiles = C / L.cgv;
  const int c_base = (blockIdx.x % ctiles) * L.cgv;
  const int ox0 = (blockIdx.x / ctiles) * tpg;
  const int oy0 = blockIdx.y * th;
  const int b = blockIdx.z;

  // -- stage: input band + halo, weights, constants; one wait -------------
  const int iy0 = oy0 * sh - pt;
  const int ix0 = ox0 * sw - pl;
  const uint32_t zb = static_cast<uint32_t>(static_cast<uint8_t>(z_x)) *
                      0x01010101u;
  // the widest piece that the block's channel bytes and the operands'
  // alignment allow
  const int align = L.cgv | C | static_cast<int>(
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15);
  if (align % 16 == 0) {
    stage<16>(x, w, xs, wsm, L, b, H, W, C, c_base, iy0, ix0, kh * kw, zb);
  } else if (align % 8 == 0) {
    stage<8>(x, w, xs, wsm, L, b, H, W, C, c_base, iy0, ix0, kh * kw, zb);
  } else {
    stage<4>(x, w, xs, wsm, L, b, H, W, C, c_base, iy0, ix0, kh * kw, zb);
  }
  const int chunks = L.cgv / 4;  // 16-byte chunks of one constant
  for (int i = threadIdx.x; i < 5 * chunks; i += blockDim.x) {
    const int arr = i / chunks;
    const int off = c_base + (i % chunks) * 4;
    const void* src = arr == 0   ? static_cast<const void*>(bias + off)
                      : arr == 1 ? static_cast<const void*>(resc + off)
                      : arr == 2 ? static_cast<const void*>(wsum + off)
                      : arr == 3 ? static_cast<const void*>(coff + off)
                                 : static_cast<const void*>(zw + off);
    cp_async<16>(cs + arr * L.cgv + (i % chunks) * 4, src);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // -- compute: 4 channels of one pixel a thread --------------------------
  const int tid = threadIdx.x;
  if (tid >= th * tpg * cg) return;
  const int g = tid % cg;
  const int oxl = (tid / cg) % tpg;
  const int r = tid / (cg * tpg);
  const int oy = oy0 + r;
  const int ox = ox0 + oxl;
  if (oy >= OH || ox >= OW) return;
  const int c0 = c_base + g * V;
  uint32_t* dst = reinterpret_cast<uint32_t*>(
      out + ((static_cast<size_t>(b) * OH + oy) * OW + ox) * C + c0);
  if (c0 >= c_true) {
    *dst = 0u;
    return;
  }

  const int cl = g * V;  // the thread's channels within the block
  uint32_t zwv[V];
  uint32_t acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    zwv[e] = static_cast<uint32_t>(cs[4 * L.cgv + cl + e]);
    acc[e] = 0u;
  }
  const int row_bytes = L.cols_in * L.cgv;
  const int8_t* xcell = xs + r * sh * row_bytes + oxl * sw * L.cgv + cl;
  auto tap = [&](int i, int j) {
    const uint32_t xv = *reinterpret_cast<const uint32_t*>(
        xcell + i * row_bytes + j * L.cgv);
    const uint32_t wv = *reinterpret_cast<const uint32_t*>(
        wsm + (i * kw + j) * L.cgv + cl);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += sbyte(xv, e) * (sbyte(wv, e) - zwv[e]);
  };
  if constexpr (KH > 0) {
#pragma unroll
    for (int i = 0; i < KH; ++i) {
#pragma unroll
      for (int j = 0; j < KW; ++j) tap(i, j);
    }
  } else {
    for (int i = 0; i < kh; ++i) {
      for (int j = 0; j < kw; ++j) tap(i, j);
    }
  }

  // -- epilogue: the 4 results, then one store ----------------------------
  const float* c_bias = reinterpret_cast<const float*>(cs) + cl;
  const float* c_resc = reinterpret_cast<const float*>(cs + L.cgv) + cl;
  const int32_t* c_wsum = cs + 2 * L.cgv + cl;
  const int32_t* c_coff = cs + 3 * L.cgv + cl;
  uint32_t packed = 0u;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int8_t q = requant_i8(static_cast<int32_t>(acc[e]), 0, c_bias[e],
                                c_resc[e], c_wsum[e], c_coff[e], 0, lo, hi);
    const uint32_t byte = c0 + e < c_true ? static_cast<uint8_t>(q) : 0u;
    packed |= byte << (8 * e);
  }
  *dst = packed;
}

template <int KH, int KW, int SH, int SW>
int launch(const void* x, const void* w, const void* bias, const void* resc,
           const void* wsum, const void* coff, const void* zw, void* out,
           int B, int H, int W, int C, int kh, int kw, int sh, int sw, int pt,
           int pl, int OH, int OW, int z_x, int cg, int th, int tpg, float lo,
           float hi, int c_true, cudaStream_t stream) {
  const Layout L(th, tpg, cg, kh, kw, sh, sw);
  const int compute = th * tpg * cg;
  if (compute > MAX_THREADS || L.bytes > 48 * 1024 || C % L.cgv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((OW + tpg - 1) / tpg * (C / L.cgv), (OH + th - 1) / th, B);
  cfg.blockDim = dim3((compute + 31) / 32 * 32);  // whole warps stage
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, qdwconv_kernel<KH, KW, SH, SW>,
                     static_cast<const int8_t*>(x),
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(resc),
                     static_cast<const int32_t*>(wsum),
                     static_cast<const int32_t*>(coff),
                     static_cast<const int32_t*>(zw), static_cast<int8_t*>(out),
                     H, W, C, OH, OW, kh, kw, sh, sw, pt, pl, z_x, cg, th, tpg,
                     lo, hi, c_true);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, C) int8 unpadded, w (kh, kw, C) int8, five (C,) consts, out
// (B, OH, OW, C) int8; contiguous; x, w and out 4-byte aligned, the consts
// 16-byte aligned; C a multiple of 4. The border (pt top, pl left; the
// bottom and right pads are implied by OH, OW) reads z_x. (cg, th, tpg) is
// the tile of kernels/qdwconv.py::dw_tile. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a tile over 256 threads or 48 KB of
// shared memory, or whose channel groups do not divide C).
extern "C" int repro_qdwconv(const void* x, const void* w, const void* bias,
                             const void* resc, const void* wsum,
                             const void* coff, const void* zw, void* out,
                             int B, int H, int W, int C, int kh, int kw,
                             int sh, int sw, int pt, int pl, int OH, int OW,
                             int z_x, int cg, int th, int tpg, float lo,
                             float hi, int c_true, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_QDWCONV_ARGS                                                    \
  x, w, bias, resc, wsum, coff, zw, out, B, H, W, C, kh, kw, sh, sw, pt, pl, \
      OH, OW, z_x, cg, th, tpg, lo, hi, c_true, s
  if (kh == 3 && kw == 3 && sh == 1 && sw == 1) {
    return launch<3, 3, 1, 1>(REPRO_QDWCONV_ARGS);
  }
  if (kh == 3 && kw == 3 && sh == 2 && sw == 2) {
    return launch<3, 3, 2, 2>(REPRO_QDWCONV_ARGS);
  }
  return launch<0, 0, 0, 0>(REPRO_QDWCONV_ARGS);
#undef REPRO_QDWCONV_ARGS
}

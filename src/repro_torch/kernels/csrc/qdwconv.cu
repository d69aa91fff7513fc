// Quantized depthwise VALID conv with the folded requant epilogue (Eq. 9/10).
//
// Replaces: src/repro/kernels/qdwconv.py::qdwconv (Pallas TPU kernel
// _qdwconv_kernel). It runs every DEPTHWISE_CONV_2D of the compiled engine's
// kernel route (13 per person-detector forward).
//
// What bounds it on an H100: memory. A depthwise conv does 2 * kh * kw
// operations per output (ΣXW and ΣX) and has no reduction across channels
// for a tensor core to take, so the floor is the bytes: each input read once
// and each output written once at 3.35 TB/s. At the person detector's shapes
// that is well under a microsecond per layer, so a launch sets the pace.
//
// Design: the TPU kernel kept a whole (H, W, 128-lane) block resident in
// VMEM and swept a static tap loop over it. Here each thread owns four
// consecutive channels of one output pixel: it reads the kh*kw taps as
// 4-byte char4 loads (neighbouring threads read neighbouring channels, so a
// warp's loads coalesce), accumulates ΣXW and ΣX per channel in int32
// registers, and runs the shared requant.cuh epilogue; channels >= c_true
// are written as zero (the padded-layout contract). The input is pre-padded
// by the caller, exactly as for the TPU kernel.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qdwconv_kernel(const char4* __restrict__ x, const char4* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ resc,
               const int32_t* __restrict__ wsum,
               const int32_t* __restrict__ coff,
               const int32_t* __restrict__ zw, char4* __restrict__ out,
               int B, int H, int W, int C4, int kh, int kw, int sh, int sw,
               int OH, int OW, float lo, float hi, int c_true) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(B) * OH * OW * C4;
  if (idx >= total) return;
  const int c4 = static_cast<int>(idx % C4);
  const size_t pix = idx / C4;              // (b * OH + oy) * OW + ox
  const int ox = static_cast<int>(pix % OW);
  const int oy = static_cast<int>((pix / OW) % OH);
  const int b = static_cast<int>(pix / (static_cast<size_t>(OW) * OH));

  int32_t acc[4] = {0, 0, 0, 0};
  int32_t sx[4] = {0, 0, 0, 0};
  for (int i = 0; i < kh; ++i) {
    const size_t row = (static_cast<size_t>(b) * H + oy * sh + i) * W;
    for (int j = 0; j < kw; ++j) {
      const char4 xv = x[(row + ox * sw + j) * C4 + c4];
      const char4 wv = w[(i * kw + j) * C4 + c4];
      acc[0] += xv.x * wv.x;
      acc[1] += xv.y * wv.y;
      acc[2] += xv.z * wv.z;
      acc[3] += xv.w * wv.w;
      sx[0] += xv.x;
      sx[1] += xv.y;
      sx[2] += xv.z;
      sx[3] += xv.w;
    }
  }

  int8_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = c4 * 4 + k;
    q[k] = c < c_true ? requant_i8(acc[k], sx[k], bias[c], resc[c], wsum[c],
                                   coff[c], zw[c], lo, hi)
                      : static_cast<int8_t>(0);
  }
  out[idx] = make_char4(q[0], q[1], q[2], q[3]);
}

}  // namespace

// x (B, H, W, C) int8 pre-padded, w (kh, kw, C) int8, five (C,) consts,
// out (B, OH, OW, C) int8; contiguous, 4-byte aligned, C a multiple of 4
// (the Python wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int repro_qdwconv(const void* x, const void* w, const void* bias,
                             const void* resc, const void* wsum,
                             const void* coff, const void* zw, void* out,
                             int B, int H, int W, int C, int kh, int kw,
                             int sh, int sw, int OH, int OW, float lo,
                             float hi, int c_true, void* stream) {
  const size_t total = static_cast<size_t>(B) * OH * OW * (C / 4);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  qdwconv_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(x), static_cast<const char4*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(resc),
      static_cast<const int32_t*>(wsum), static_cast<const int32_t*>(coff),
      static_cast<const int32_t*>(zw), static_cast<char4*>(out), B, H, W,
      C / 4, kh, kw, sh, sw, OH, OW, lo, hi, c_true);
  return static_cast<int>(cudaGetLastError());
}

// Shared requantization epilogue of the folded Eqs. (4)/(7)/(10), in the
// order of the reference (src/repro/kernels/qmatmul.py::_qmatmul_kernel,
// src/repro/kernels/qdwconv.py::_qdwconv_kernel):
//
//   inner = acc - z_w * sum_x - w_sum_zx + const_off      (int32, wrapping)
//   y     = bias + rescale * float(inner)                 (ONE rounding)
//   y     = min(max(y, lo), hi)                           (fused activation)
//   q     = saturate_int8(round_half_to_even(y))
//
// The multiply-add is fused on purpose: XLA contracts the reference's
// `bias + rescale * f32(inner)` into one FMA, and the plain PyTorch version
// uses torch.addcmul, which rounds once too. rintf rounds half to even like
// jnp.round; roundf would round half away from zero.
#pragma once

#include <cstdint>

__device__ __forceinline__ int8_t requant_i8(int32_t acc, int32_t sum_x,
                                             float bias, float rescale,
                                             int32_t w_sum_zx,
                                             int32_t const_off, int32_t z_w,
                                             float lo, float hi) {
  // unsigned arithmetic: int32 wrap-around, as in the reference, without
  // signed-overflow undefined behaviour
  const uint32_t u = static_cast<uint32_t>(acc)
                     - static_cast<uint32_t>(z_w) * static_cast<uint32_t>(sum_x)
                     - static_cast<uint32_t>(w_sum_zx)
                     + static_cast<uint32_t>(const_off);
  const float f = __int2float_rn(static_cast<int32_t>(u));
  float y = __fmaf_rn(rescale, f, bias);
  y = fminf(fmaxf(y, lo), hi);
  float r = rintf(y);
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

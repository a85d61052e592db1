// Device functions of FIXAR's affine site quantizer shared by kernel 6
// (fxp_monitor_quant.cu) and kernel 7 (fxp_qat_sites.cu): NaN-propagating
// min / max and core/fixedpoint.affine_params for one range, in float32.

#pragma once

#include <cuda_runtime.h>

namespace {

// min / max that propagate a NaN from either side
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

struct Affine {
  float delta, z, q_max;
};

// core/fixedpoint.affine_params for one range, as float32: the range
// widened to hold 0, delta = span / (2^n − 1) (1 for an empty span), the IEEE
// division; z = rint(−a_min / delta), left in float (a NaN range gives a NaN z).
__device__ __forceinline__ Affine affine(float a_min, float a_max, int n_bits) {
  const float lo = nan_min(a_min, 0.0f);
  const float hi = nan_max(a_max, 0.0f);
  const float span = __fadd_rn(fabsf(lo), fabsf(hi));
  const float q_max = (float)((1 << n_bits) - 1);
  Affine p;
  p.delta = span > 0.0f ? __fdiv_rn(span, q_max) : 1.0f;
  p.z = rintf(__fdiv_rn(-lo, p.delta));
  p.q_max = q_max;
  return p;
}

}  // namespace

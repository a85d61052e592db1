// Device functions shared by the fused MLP kernels (fxp_mlp_fwd.cu,
// fxp_mlp_bwd.cu, fxp_ddpg_step.cu): the dual-precision limb split, the
// activations, the QAT site projection and its straight-through mask.
// Each is the elementwise arithmetic of the reference kernels
// (src/repro/kernels/fxp_mlp/kernel.py `_site_project`, `_ste_site_mask`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fxp {

// The hi limb: bf16 round to nearest even, back in float32.
__device__ __forceinline__ float bf16_hi(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 0 none, 1 relu, 2 tanh (the precise tanhf: no fast-math).
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return tanhf(v);
  return v;
}

// `_site_project` of the reference kernel, for one element.
__device__ __forceinline__ float site_project(float v, int quant, float delta, float z,
                                              float q_max, int fxp32_phase1) {
  if (quant) {
    const float q = fminf(fmaxf(rintf(v / delta) + z, 0.0f), q_max);
    return (q - z) * delta;
  }
  if (fxp32_phase1) {
    // Q15.16: clip to the int32 raw range (as float32), round, rescale
    return rintf(fminf(fmaxf(v * 65536.0f, -2147483648.0f), 2147483647.0f)) / 65536.0f;
  }
  return v;
}

// Does the site's straight-through gradient pass at input value x?
__device__ __forceinline__ bool ste_pass(float x, int quant, float lo, float hi, int fxp32_phase1) {
  if (quant) return x >= lo && x <= hi;
  if (fxp32_phase1) {
    const float xs = x * 65536.0f;
    return xs >= -2147483648.0f && xs <= 2147483648.0f;  // float32(int32 min / max)
  }
  return true;
}

}  // namespace fxp

// Kernel 6: the fused activation monitor + quantizer of FIXAR's Algorithm 1,
// for sm_90a.
//
// Replaces the TPU kernel `monitor_quant_pallas` → `_mq_kernel` in
// src/repro/kernels/quantize/kernel.py.
//
// What it computes, in one sweep over the N elements of x (ref_monitor_quant):
//   monitor phase: new_min = min(a_min, min x), new_max = max(a_max, max x);
//   quant phase:   new_min = a_min, new_max = a_max (the ranges freeze);
//   y = the phase-selected projection of x:
//     monitor phase: rint(clip(x·2^16, -2^31, 2^31 as f32)) / 2^16 (Q15.16);
//     quant phase:   affine Q_n with the *incoming* range — the range widened
//                    to hold 0, delta = span / (2^n − 1) (1 for an empty span),
//                    z = rint(−a_min / delta),
//                    y = (clip(rint(x / delta) + z, 0, 2^n − 1) − z) · delta.
// The min and max propagate NaN, as jnp.min / jnp.minimum do (CUDA's
// fminf / fmaxf would drop it); the clips keep a NaN too.  rintf rounds half
// to even as jnp.round does; products, sums and quotients are the IEEE
// __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc contracts nothing into an FMA.
//
// What bounds it on the H100: 4 bytes read and 4 written per element against
// ≈ 8 f32 operations, so device-memory bandwidth (3.35 TB/s) bounds it:
// 8·N bytes.  At the per-layer site shapes (B ≤ 512 rows of ≤ 400) the
// tensor is at most 0.8 MB and launch latency dominates.
//
// Design.  The TPU kernel walks (8, 128) row blocks in order and revisits one
// (1, 1) min/max output; CUDA blocks are unordered.  Pass 1 is a grid-stride
// loop over the flat tensor with an explicit i < n bound (no padding, no
// mask): each thread writes y and keeps its own min/max, and each block
// writes its partial min/max after a fixed-order shared-memory tree.  Pass 2,
// one block, folds the partials in a fixed order and then into the incoming
// range under the phase.  Min/max are order-free, so two calls are bitwise
// equal.  The projection reads only the incoming range, so y never waits for
// the reduction.  The ranges and the phase are read from device memory:
// nothing in a call needs the host, and a captured CUDA graph replays it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 8 blocks per SM of the H100

// min / max that propagate a NaN from either side
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// clip that keeps a NaN (fminf / fmaxf would replace it by a bound)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Affine {
  float delta, z, q_max;
};

// core/fixedpoint.affine_params for the incoming range, as float32
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

__device__ __forceinline__ float project(float v, bool quant, const Affine& p) {
  if (quant) {
    const float q = clip(__fadd_rn(rintf(__fdiv_rn(v, p.delta)), p.z), 0.0f, p.q_max);
    return __fmul_rn(__fsub_rn(q, p.z), p.delta);
  }
  return __fdiv_rn(rintf(clip(__fmul_rn(v, 65536.0f), -2147483648.0f, 2147483648.0f)), 65536.0f);
}

// fixed-order tree over the block's threads; the result is in mn[0], mx[0]
__device__ __forceinline__ void block_minmax(float* mn, float* mx) {
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) {
      mn[threadIdx.x] = nan_min(mn[threadIdx.x], mn[threadIdx.x + s]);
      mx[threadIdx.x] = nan_max(mx[threadIdx.x], mx[threadIdx.x + s]);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
mq_sweep_kernel(const float* __restrict__ x, float* __restrict__ y, long long n,
                const float* __restrict__ a_min, const float* __restrict__ a_max,
                const int* __restrict__ phase, float* __restrict__ partials, int n_bits) {
  __shared__ float mn[THREADS];
  __shared__ float mx[THREADS];
  const bool quant = phase[0] > 0;
  const Affine p = affine(a_min[0], a_max[0], n_bits);
  float lo = __int_as_float(0x7f800000);   // +inf
  float hi = __int_as_float(0xff800000);   // -inf
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const float v = x[i];
    lo = nan_min(lo, v);
    hi = nan_max(hi, v);
    y[i] = project(v, quant, p);
  }
  mn[threadIdx.x] = lo;
  mx[threadIdx.x] = hi;
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mn[0];
    partials[gridDim.x + blockIdx.x] = mx[0];
  }
}

__global__ void __launch_bounds__(THREADS)
mq_fold_kernel(const float* __restrict__ partials, int n_partials, const float* __restrict__ a_min,
               const float* __restrict__ a_max, const int* __restrict__ phase,
               float* __restrict__ new_min, float* __restrict__ new_max) {
  __shared__ float mn[THREADS];
  __shared__ float mx[THREADS];
  float lo = __int_as_float(0x7f800000);
  float hi = __int_as_float(0xff800000);
  for (int i = threadIdx.x; i < n_partials; i += THREADS) {
    lo = nan_min(lo, partials[i]);
    hi = nan_max(hi, partials[n_partials + i]);
  }
  mn[threadIdx.x] = lo;
  mx[threadIdx.x] = hi;
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    const bool quant = phase[0] > 0;
    new_min[0] = quant ? a_min[0] : nan_min(a_min[0], mn[0]);
    new_max[0] = quant ? a_max[0] : nan_max(a_max[0], mx[0]);
  }
}

}  // namespace

// Blocks pass 1 launches for n elements; `partials` holds 2 floats per block.
extern "C" int fxp_monitor_quant_blocks(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return (int)(blocks < MAX_BLOCKS ? (blocks > 0 ? blocks : 1) : MAX_BLOCKS);
}

// C interface, loaded with ctypes.  x, y: n float32; a_min, a_max: one
// float32 each; phase: one int32 (> 0: the quant phase); partials:
// 2 · fxp_monitor_quant_blocks(n) float32 of scratch; new_min, new_max: one
// float32 each.  All device memory on the current device.  Launches the two
// passes on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int fxp_monitor_quant_launch(const float* x, float* y, long long n, const float* a_min,
                                        const float* a_max, const int* phase, float* partials,
                                        float* new_min, float* new_max, int n_bits, void* stream) {
  if (n <= 0 || n_bits < 1 || n_bits > 24) return (int)cudaErrorInvalidValue;
  const int blocks = fxp_monitor_quant_blocks(n);
  const cudaStream_t s = (cudaStream_t)stream;
  mq_sweep_kernel<<<blocks, THREADS, 0, s>>>(x, y, n, a_min, a_max, phase, partials, n_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mq_fold_kernel<<<1, THREADS, 0, s>>>(partials, blocks, a_min, a_max, phase, new_min, new_max);
  return (int)cudaGetLastError();
}

extern "C" const char* fxp_monitor_quant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

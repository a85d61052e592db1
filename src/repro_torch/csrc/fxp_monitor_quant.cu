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
// (1, 1) min/max output; CUDA blocks are unordered.  One launch: a
// grid-stride loop over the flat tensor with an explicit i < n bound (no
// padding, no mask) — float4 loads and stores where x and y are 16-byte
// aligned, scalar ones for the tail and for an unaligned view — in which
// each thread writes y and keeps its own min/max; each block writes its
// partial min/max after a fixed-order shared-memory tree.  Then the last
// block to finish folds the partials in block order, and folds them into
// the incoming range under the phase.  An arrival ticket picks that block:
// each block's thread 0 makes its partials visible (__threadfence) and
// takes a ticket (atomicAdd) — the only atomic; it decides no value, since
// the fold reads the partials in block order whatever the arrival order.
// The last block resets the ticket, so the next call on the stream, and a
// captured CUDA graph's replays, find it at 0.  The partials and the ticket
// are a workspace the wrapper keeps per device and stream (made by an eager
// call, never by a captured one).  Min/max are order-free, so two calls
// are bitwise equal.  The projection reads only the incoming range, so y
// never waits for the reduction.  The ranges and the phase are read from
// device memory: nothing in a call needs the host.
// What limits it (measured on an H100, PERF.md §6): at the per-layer site
// shapes (≤ 0.8 MB) one launch's latency; at 2^24 elements device memory.

#include <cuda_runtime.h>

#include "fxp_affine.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 8 blocks per SM of the H100

// clip that keeps a NaN (fminf / fmaxf would replace it by a bound)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
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
mq_kernel(const float* __restrict__ x, float* __restrict__ y, long long n, const float* __restrict__ a_min,
          const float* __restrict__ a_max, const int* __restrict__ phase, float* __restrict__ partials,
          unsigned int* __restrict__ ticket, float* __restrict__ new_min, float* __restrict__ new_max, int n_bits,
          int vec) {
  __shared__ float mn[THREADS];
  __shared__ float mx[THREADS];
  __shared__ bool last;
  const bool quant = phase[0] > 0;
  const Affine p = affine(a_min[0], a_max[0], n_bits);
  float lo = __int_as_float(0x7f800000);   // +inf
  float hi = __int_as_float(0xff800000);   // -inf
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long head = 0;  // elements before the scalar loop: the float4 body
  if (vec) {
    const long long n4 = n / 4;
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
    for (long long i = t0; i < n4; i += stride) {
      const float4 v = x4[i];
      lo = nan_min(nan_min(nan_min(nan_min(lo, v.x), v.y), v.z), v.w);
      hi = nan_max(nan_max(nan_max(nan_max(hi, v.x), v.y), v.z), v.w);
      y4[i] = make_float4(project(v.x, quant, p), project(v.y, quant, p), project(v.z, quant, p),
                          project(v.w, quant, p));
    }
    head = 4 * n4;
  }
  for (long long i = head + t0; i < n; i += stride) {
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
    __threadfence();  // the partials are visible before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // ---- the last block: every partial in block order, then the range ----
  lo = __int_as_float(0x7f800000);
  hi = __int_as_float(0xff800000);
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) {
    lo = nan_min(lo, __ldcg(partials + i));
    hi = nan_max(hi, __ldcg(partials + gridDim.x + i));
  }
  mn[threadIdx.x] = lo;
  mx[threadIdx.x] = hi;
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    new_min[0] = quant ? a_min[0] : nan_min(a_min[0], mn[0]);
    new_max[0] = quant ? a_max[0] : nan_max(a_max[0], mx[0]);
    *ticket = 0u;  // for the next call on the stream, and a graph's next replay
  }
}

}  // namespace

// Floats of the workspace a call needs: the partials (two per block), then
// one 32-bit ticket, which must be 0 before the first call.
extern "C" long long fxp_monitor_quant_workspace() { return 2LL * MAX_BLOCKS + 1; }

// C interface, loaded with ctypes.  x, y: n float32; a_min, a_max: one
// float32 each; phase: one int32 (> 0: the quant phase); workspace:
// fxp_monitor_quant_workspace() floats, its ticket 0, kept for the stream;
// new_min, new_max: one float32 each.  All device memory on the current
// device.  Launches the kernel on `stream` and returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int fxp_monitor_quant_launch(const float* x, float* y, long long n, const float* a_min,
                                        const float* a_max, const int* phase, float* workspace,
                                        float* new_min, float* new_max, int n_bits, void* stream) {
  if (n <= 0 || n_bits < 1 || n_bits > 24 || workspace == nullptr) return (int)cudaErrorInvalidValue;
  const int vec = (((size_t)x | (size_t)y) & 15) == 0;
  const long long items = vec ? (n / 4 > 0 ? n / 4 : n) : n;
  const long long want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(workspace + 2 * MAX_BLOCKS);
  mq_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, y, n, a_min, a_max, phase, workspace, ticket,
                                                          new_min, new_max, n_bits, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* fxp_monitor_quant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

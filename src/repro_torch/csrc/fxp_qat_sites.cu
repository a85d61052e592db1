// Kernel 7: the QAT site bookkeeping of a training step, for sm_90a.
//
// No Pallas counterpart: in the reference this is scalar glue around the
// fused kernels (src/repro/core/qat.py `site_quant_params`, `observe`,
// `QATState.tick`; core/ranges.py `finalized`; core/fixedpoint.py
// `affine_params`) that XLA fuses into its neighbours.  Run as PyTorch ops
// on 0-d tensors it is ≈ 20 one-element kernels a site and a fold.  Here it
// is two entry points, each one launch of one warp, a thread per site:
//
//   qat_site_params: per site the finalized range (never updated → [−1, 1];
//     a span of at most 1e-6 widened by ±0.5) and its affine operands:
//     delta = span / (2^n − 1) of the range widened to hold 0 (1 for an
//     empty span), z = rint(−a_min / delta) through int32 (out[0][i] = delta,
//     out[1][i] = z as float32);
//   qat_fold: the extrema of each fold, in order, into its site's running
//     range (a_min = min(a_min, mn), a_max = max(a_max, mx), count + 1),
//     unless the step is past the quantization delay (step ≥ delay, read on
//     the device), then the step plus `tick` (out: the L minima, the L
//     maxima, the L counts and the step, the last L + 1 as int32).
//
// Bit for bit what those PyTorch ops compute on the card: IEEE sums,
// differences and quotients (__fadd_rn, __fsub_rn, __fdiv_rn), rintf rounds
// half to even as torch.round does, `(int)` converts as PyTorch's CUDA cast
// to int32 does (cvt.rzi: saturating, NaN to 0), and the fold's min / max
// are torch.minimum / torch.maximum's CUDA functors (a NaN from either side,
// else fminf / fmaxf), signed zeros included.  The counts and the step wrap
// as int32 adds do.
//
// Design.  The sites' leaves stay separate 0-d tensors (a checkpoint and
// the benchmark's snapshot read them), so each launch takes their addresses
// as a struct of pointers passed by value: inside a captured CUDA graph the
// addresses are fixed and the values are read at replay.  The phase and the
// ranges are read on the device, so a call needs nothing from the host.  Each
// thread folds its own site's extrema in fold order, so the result does not
// depend on scheduling.  Bound: a few dependent loads of one warp, ≈ the
// launch latency; there is no bandwidth or arithmetic to speak of.

#include <cuda_runtime.h>

#include "fxp_affine.cuh"

namespace {

constexpr int MAX_SITES = 32;  // one warp
constexpr int MAX_FOLDS = 64;

struct Sites {
  const float* a_min[MAX_SITES];
  const float* a_max[MAX_SITES];
  const int* count[MAX_SITES];
};

struct Folds {
  const float* mn[MAX_FOLDS];
  const float* mx[MAX_FOLDS];
  int site[MAX_FOLDS];
};

// torch.minimum / torch.maximum on the card: a NaN from either side, else
// ::min / ::max (fminf / fmaxf)
__device__ __forceinline__ float torch_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float torch_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void __launch_bounds__(MAX_SITES)
qat_site_params_kernel(const Sites sites, int n_sites, int n_bits, float* __restrict__ out) {
  const int i = threadIdx.x;
  if (i >= n_sites) return;
  float lo = *sites.a_min[i];
  float hi = *sites.a_max[i];
  if (*sites.count[i] == 0) {  // never updated
    lo = -1.0f;
    hi = 1.0f;
  }
  if (!(__fsub_rn(hi, lo) > 1e-6f)) {  // a constant site (or a NaN range)
    lo = __fsub_rn(lo, 0.5f);
    hi = __fadd_rn(hi, 0.5f);
  }
  const Affine p = affine(lo, hi, n_bits);
  out[i] = p.delta;
  out[n_sites + i] = (float)(int)p.z;
}

__global__ void __launch_bounds__(MAX_SITES)
qat_fold_kernel(const Sites sites, int n_sites, const Folds folds, int n_folds, const int* __restrict__ step,
                long long delay, int tick, float* __restrict__ out) {
  const int i = threadIdx.x;
  const int s = *step;
  int* out_i = reinterpret_cast<int*>(out);
  if (i < n_sites) {
    float lo = *sites.a_min[i];
    float hi = *sites.a_max[i];
    int count = *sites.count[i];
    if ((long long)s < delay) {  // the monitor phase: the ranges move
      for (int f = 0; f < n_folds; ++f) {
        if (folds.site[f] != i) continue;
        lo = torch_min(lo, *folds.mn[f]);
        hi = torch_max(hi, *folds.mx[f]);
        count = wrap_add(count, 1);
      }
    }
    out[i] = lo;
    out[n_sites + i] = hi;
    out_i[2 * n_sites + i] = count;
  }
  if (i == 0) out_i[3 * n_sites] = wrap_add(s, tick);
}

bool fill_sites(Sites& s, const void* const* a_min, const void* const* a_max, const void* const* count, int n) {
  if (n < 1 || n > MAX_SITES || a_min == nullptr || a_max == nullptr || count == nullptr) return false;
  for (int i = 0; i < n; ++i) {
    if (a_min[i] == nullptr || a_max[i] == nullptr || count[i] == nullptr) return false;
    s.a_min[i] = static_cast<const float*>(a_min[i]);
    s.a_max[i] = static_cast<const float*>(a_max[i]);
    s.count[i] = static_cast<const int*>(count[i]);
  }
  return true;
}

}  // namespace

// C interface, loaded with ctypes.  a_min, a_max, count: host arrays of
// n_sites device addresses (one float32, float32, int32 each); out: 2·n_sites
// float32 (deltas, then zs).  Launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int fxp_qat_site_params_launch(const void* const* a_min, const void* const* a_max,
                                          const void* const* count, int n_sites, int n_bits, float* out,
                                          void* stream) {
  Sites sites;
  if (!fill_sites(sites, a_min, a_max, count, n_sites) || n_bits < 1 || n_bits > 24 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  qat_site_params_kernel<<<1, MAX_SITES, 0, (cudaStream_t)stream>>>(sites, n_sites, n_bits, out);
  return (int)cudaGetLastError();
}

// a_min, a_max, count as above; mn, mx: host arrays of n_folds device
// addresses (one float32 each), fold f into site site[f] (a host array);
// step: one int32; out: 3·n_sites + 1 words (minima, maxima, then the counts
// and the step as int32).
extern "C" int fxp_qat_fold_launch(const void* const* a_min, const void* const* a_max, const void* const* count,
                                   int n_sites, const void* const* mn, const void* const* mx, const int* site,
                                   int n_folds, const int* step, long long delay, int tick, float* out,
                                   void* stream) {
  Sites sites;
  if (!fill_sites(sites, a_min, a_max, count, n_sites) || n_folds < 0 || n_folds > MAX_FOLDS || step == nullptr ||
      out == nullptr || (tick != 0 && tick != 1))
    return (int)cudaErrorInvalidValue;
  Folds folds;
  for (int f = 0; f < n_folds; ++f) {
    if (mn[f] == nullptr || mx[f] == nullptr || site[f] < 0 || site[f] >= n_sites) return (int)cudaErrorInvalidValue;
    folds.mn[f] = static_cast<const float*>(mn[f]);
    folds.mx[f] = static_cast<const float*>(mx[f]);
    folds.site[f] = site[f];
  }
  qat_fold_kernel<<<1, MAX_SITES, 0, (cudaStream_t)stream>>>(sites, n_sites, folds, n_folds, step, delay, tick,
                                                             out);
  return (int)cudaGetLastError();
}

extern "C" const char* fxp_qat_sites_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

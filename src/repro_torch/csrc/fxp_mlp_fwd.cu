// Kernel B: the whole L-layer MLP forward in one launch, QAT sites fused,
// for sm_90a.
//
// Replaces the TPU kernel `fxp_mlp_pallas` → `_mlp_kernel` in
// src/repro/kernels/fxp_mlp/kernel.py, with and without the training
// residuals.  Per layer l, on the layer's input x:
//   1. range monitor: min/max of x over the valid rows and the in_dims[l]
//      real columns, one (min, max) per block and layer;
//   2. site projection (when qat): quant phase (clip(rint(x/δ)+z, 0,
//      2ⁿ−1) − z)·δ, monitor phase rint(clip(x·2¹⁶))/2¹⁶ (or identity);
//   3. hi = bf16(x) (round to nearest even), acc = Σ hi·W; in the monitor
//      phase also Σ (x − hi)·W, added to it — the lo pass is a runtime
//      branch, as `pl.when` is in the reference, so one compiled kernel
//      serves both phases;
//   4. y = act(acc + b) becomes the next layer's input.
//   With save_residuals (training), the block also stores what the
//   backward kernel (fxp_mlp_bwd.cu) reads: qs[l] (M, K_l), the input the
//   products consumed (hi in the quant phase, the projected x before it),
//   written in step 3 from the values it computes anyway, and hs[l]
//   (M, N_l) for l < L−1, the layer output written in step 4.  The mode
//   is a template instance (SAVE), so the serving instance has none of
//   its code, and it only adds stores: y is bitwise the same in both.
//   The phase can also be a device int32 read in-kernel (the DEV_PHASE
//   instances, for acting inside a captured CUDA graph, where a host read
//   of the phase would stop the capture); the host-phase instances keep
//   the serving code.
//
// What bounds it on the H100: the paper's actor (17-400-300-6, 128,600
// MACs a row) at B = 512 in full precision is 2 passes × 2·512·128,600 ≈
// 263 MFLOP of f32 FMA against ≈ 0.56 MB of operands, so f32-compute-bound
// at large B (non-tensor f32 peak); at B = 1 it is byte- and launch-bound.
//
// Design:
//  * One block per row block of BM rows (BM = 8, or 1 for a single row);
//    the layer chain is unrolled inside the block.  Inter-layer
//    activations stay in shared memory (three BM × max-dim buffers: the
//    site input, its hi limb, its lo limb) and never touch device memory.
//  * The weights do not fit in shared memory (≈ 514 KB of f32 for the
//    actor, against a block's 227 KB), so the reference's VMEM-resident
//    weights become W streamed from global memory: after the first block
//    they sit in the 50 MB L2.  Each thread owns output columns
//    n = tid, tid + 256, … and walks k, so one warp's W load is one
//    coalesced 128-byte line, and the limbs are shared-memory broadcasts.
//  * Blocks run unordered: each writes its own row of mins/maxs
//    (n_blocks, L) and the wrapper reduces them — the only cross-block
//    output, so the TPU's "parallel" grid needs no in-kernel reduction.
//  * Plain CUDA-core f32 FMA: W is f32 and not bf16-exact, so neither a
//    bf16 nor a TF32 tensor-core MMA reproduces dot(hi, W).  rintf rounds
//    half to even like jnp.round; no fast-math, so x/δ is an IEEE divide
//    and tanhf the precise one.

#include "fxp_common.cuh"

namespace {

using fxp::activate;
using fxp::bf16_hi;
using fxp::site_project;

constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // a block's shared-memory limit on sm_90

struct MlpArgs {
  const float* w[MAX_LAYERS];  // (dims[l], dims[l+1]) row-major
  const float* b[MAX_LAYERS];  // (dims[l+1],)
  int dims[MAX_LAYERS + 1];
  int acts[MAX_LAYERS];  // 0 none, 1 relu, 2 tanh
  int n_layers;
  int stride;  // row stride of the shared buffers: max over dims
};

struct ResArgs {           // the residual outputs, read by SAVE instances only
  float* q[MAX_LAYERS];  // (M, dims[l])
  float* h[MAX_LAYERS];  // (M, dims[l+1]) for l < n_layers-1
};

template <int BM, bool SAVE, bool DEV_PHASE>
__global__ void __launch_bounds__(THREADS)
fxp_mlp_fwd_kernel(const float* __restrict__ x, const MlpArgs args, const ResArgs res,
                   const float* __restrict__ deltas, const float* __restrict__ zs,
                   float* __restrict__ y, float* __restrict__ mins, float* __restrict__ maxs,
                   int M, int quant, int qat, int fxp32_phase1, float q_max,
                   const int* __restrict__ phase) {
  if (DEV_PHASE) quant = __ldg(phase) > 0;
  extern __shared__ float smem[];
  __shared__ float red_min[THREADS / 32];
  __shared__ float red_max[THREADS / 32];
  const int S = args.stride;
  float* act_s = smem;             // site input of the current layer
  float* hi_s = smem + BM * S;     // hi limb of the projected input
  float* lo_s = hi_s + BM * S;     // lo limb (monitor phase only)

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);  // valid rows of this block
  const int L = args.n_layers;
  const float inf = __int_as_float(0x7f800000);

  const int K0 = args.dims[0];
  for (int e = tid; e < BM * K0; e += THREADS) {
    const int r = e / K0, c = e % K0;
    act_s[r * S + c] = r < rows ? x[(size_t)(row0 + r) * K0 + c] : 0.0f;
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int K = args.dims[l], N = args.dims[l + 1];

    // ---- range monitor: valid rows, real columns only ------------------
    float mn = inf, mx = -inf;
    for (int e = tid; e < rows * K; e += THREADS) {
      const float v = act_s[(e / K) * S + e % K];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      red_min[warp] = mn;
      red_max[warp] = mx;
    }

    // ---- site projection + limb split ------------------------------------
    const float delta = qat ? deltas[l] : 1.0f;
    const float z = qat ? zs[l] : 0.0f;
    for (int e = tid; e < BM * K; e += THREADS) {
      const int r = e / K, c = e % K;
      const int idx = r * S + c;
      float v = act_s[idx];
      if (qat) v = site_project(v, quant, delta, z, q_max, fxp32_phase1);
      const float h = bf16_hi(v);
      hi_s[idx] = h;
      lo_s[idx] = v - h;
      if (SAVE && r < rows) res.q[l][(size_t)(row0 + r) * K + c] = quant ? h : v;
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < THREADS / 32; ++i) {
        mn = fminf(mn, red_min[i]);
        mx = fmaxf(mx, red_max[i]);
      }
      mins[(size_t)blockIdx.x * L + l] = mn;
      maxs[(size_t)blockIdx.x * L + l] = mx;
    }

    // ---- dense: hi pass always, lo pass in the monitor phase ----------
    const float* __restrict__ W = args.w[l];
    const float* __restrict__ B = args.b[l];
    const int act = args.acts[l];
    const bool last = l == L - 1;
    for (int n = tid; n < N; n += THREADS) {
      float ah[BM], al[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) ah[r] = al[r] = 0.0f;
      if (quant) {
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float wv = __ldg(W + (size_t)k * N + n);
#pragma unroll
          for (int r = 0; r < BM; ++r) ah[r] = fmaf(hi_s[r * S + k], wv, ah[r]);
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float wv = __ldg(W + (size_t)k * N + n);
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            ah[r] = fmaf(hi_s[r * S + k], wv, ah[r]);
            al[r] = fmaf(lo_s[r * S + k], wv, al[r]);
          }
        }
      }
      const float bias = __ldg(B + n);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float acc = quant ? ah[r] : ah[r] + al[r];
        const float v = activate(acc + bias, act);
        if (!last) {
          act_s[r * S + n] = v;
          if (SAVE && r < rows) res.h[l][(size_t)(row0 + r) * N + n] = v;
        } else if (r < rows) {
          y[(size_t)(row0 + r) * N + n] = v;
        }
      }
    }
    __syncthreads();
  }
}

template <int BM, bool SAVE, bool DEV_PHASE>
int launch(const float* x, const MlpArgs& args, const ResArgs& res, const float* deltas,
           const float* zs, float* y, float* mins, float* maxs, int M, int quant, int qat,
           int fxp32_phase1, float q_max, const int* phase, cudaStream_t stream) {
  const size_t smem = (size_t)3 * BM * args.stride * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fxp_mlp_fwd_kernel<BM, SAVE, DEV_PHASE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (M + BM - 1) / BM;
  fxp_mlp_fwd_kernel<BM, SAVE, DEV_PHASE><<<grid, THREADS, smem, stream>>>(
      x, args, res, deltas, zs, y, mins, maxs, M, quant, qat, fxp32_phase1, q_max, phase);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  x (M, dims[0]); weights[l] (dims[l],
// dims[l+1]); biases[l] (dims[l+1],); deltas/zs (n_layers,) or null when
// qat == 0; y (M, dims[n_layers]); mins/maxs (ceil(M/bm), n_layers); with
// save_residuals, qs[l] (M, dims[l]) for every layer and hs[l]
// (M, dims[l+1]) for l < n_layers-1 (both arrays null otherwise); phase,
// when not null, a device int32 read in-kernel in place of `quant` (> 0:
// the quant phase), so a captured graph sees the phase of each replay —
// not with save_residuals.  All
// float32, contiguous, on the current device.  bm is 8 or 1.  Launches on
// `stream` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int fxp_mlp_fwd_launch(const float* x, const void* const* weights,
                                  const void* const* biases, const int* dims, const int* acts,
                                  int n_layers, const float* deltas, const float* zs, float* y,
                                  float* mins, float* maxs, int M, int bm, int quant, int qat,
                                  int fxp32_phase1, int n_bits, int save_residuals,
                                  void* const* qs, void* const* hs, const int* phase,
                                  void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24)
    return (int)cudaErrorInvalidValue;
  if (qat && (deltas == nullptr || zs == nullptr)) return (int)cudaErrorInvalidValue;
  if (save_residuals && (qs == nullptr || (n_layers > 1 && hs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (save_residuals && phase != nullptr) return (int)cudaErrorInvalidValue;
  MlpArgs args = {};
  ResArgs res = {};
  args.n_layers = n_layers;
  args.stride = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    args.dims[l] = dims[l];
    args.stride = dims[l] > args.stride ? dims[l] : args.stride;
  }
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < 0 || acts[l] > 2) return (int)cudaErrorInvalidValue;
    args.w[l] = static_cast<const float*>(weights[l]);
    args.b[l] = static_cast<const float*>(biases[l]);
    args.acts[l] = acts[l];
    if (save_residuals) {
      res.q[l] = static_cast<float*>(qs[l]);
      res.h[l] = l < n_layers - 1 ? static_cast<float*>(hs[l]) : nullptr;
      if (res.q[l] == nullptr || (l < n_layers - 1 && res.h[l] == nullptr))
        return (int)cudaErrorInvalidValue;
    }
  }
  const float q_max = (float)((1 << n_bits) - 1);
  const cudaStream_t s = (cudaStream_t)stream;
#define FXP_MLP_FWD_LAUNCH(BM, SAVE, DEV_PHASE)                                                  \
  launch<BM, SAVE, DEV_PHASE>(x, args, res, deltas, zs, y, mins, maxs, M, quant, qat, fxp32_phase1, \
                              q_max, phase, s)
#define FXP_MLP_FWD_PICK(BM)                                                  \
  (save_residuals ? FXP_MLP_FWD_LAUNCH(BM, true, false)                       \
                  : phase != nullptr ? FXP_MLP_FWD_LAUNCH(BM, false, true)    \
                                     : FXP_MLP_FWD_LAUNCH(BM, false, false))
  if (bm == 8) return FXP_MLP_FWD_PICK(8);
  if (bm == 1) return FXP_MLP_FWD_PICK(1);
#undef FXP_MLP_FWD_PICK
#undef FXP_MLP_FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fxp_mlp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Kernel A: the dual-precision dense layer, y = act(x·W + b), for sm_90a.
//
// Replaces the TPU kernel `fxp_dense_pallas` → `_dense_kernel_full` /
// `_dense_kernel_half` in src/repro/kernels/fxp_matmul/kernel.py.
//
// What it computes (the value-space model of FIXAR's PE, ref_fxp_dense):
//   hi = bf16(x) rounded to nearest even, lo = x − hi   (exact split)
//   full precision: acc = Σ_k hi·w + Σ_k lo·w   (two MAC passes)
//   half precision: acc = Σ_k hi·w              (one pass)
//   y = act(acc + b), act ∈ {none, relu, tanh}
// The limb split happens here, on the shared-memory load of x; the JAX
// wrapper split outside its kernel.  The function is the same.
//
// What bounds it on the H100: at the serving shapes — (B,17)×(17,400),
// (B,400)×(400,300), (B,300)×(300,6) with B ≤ 512 — the work is at most
// 2 passes × 2·512·400·300 ≈ 0.25 GFLOP of f32 FMA against ≈ 1.5 MB of
// operands: f32-compute-bound at large B (against the non-tensor f32
// peak), and byte- or launch-bound at B = 1.
//
// Design: plain CUDA-core f32 FMA, no tensor-core MMA.  W is f32 and not
// bf16-exact, so neither a bf16 nor a TF32 MMA reproduces dot(hi, W).
// A block computes a 16×64 output tile from 16×32 (x) and 32×64 (W)
// shared-memory tiles; each of 256 threads owns one row and four columns
// (tx + 16·j, so W reads from shared memory are conflict-free) and keeps
// one accumulator per limb, summed in the epilogue as the reference sums
// its two dots.  Ragged M, K and N are masked here; nothing is padded.
// Tensor cores, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int TN = BN / 16;  // output columns per thread

__device__ __forceinline__ float bf16_hi(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return tanhf(v);
  return v;
}

__global__ void __launch_bounds__(THREADS)
fxp_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y, int M, int K,
                 int N, int full, int act) {
  __shared__ float xs_hi[BM][BK];
  __shared__ float xs_lo[BM][BK];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // row of the tile
  const int tx = tid % 16;  // columns tx + 16·j
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc_hi[TN] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_lo[TN] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      const float v = (gr < M && gc < K) ? x[(size_t)gr * K + gc] : 0.0f;
      const float h = bf16_hi(v);
      xs_hi[r][c] = h;
      xs_lo[r][c] = v - h;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < K && gc < N) ? w[(size_t)gr * N + gc] : 0.0f;
    }
    __syncthreads();
    const int kk_end = min(BK, K - k0);
    if (full) {
      for (int kk = 0; kk < kk_end; ++kk) {
        const float h = xs_hi[ty][kk];
        const float l = xs_lo[ty][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float wv = ws[kk][tx + 16 * j];
          acc_hi[j] = fmaf(h, wv, acc_hi[j]);
          acc_lo[j] = fmaf(l, wv, acc_lo[j]);
        }
      }
    } else {
      for (int kk = 0; kk < kk_end; ++kk) {
        const float h = xs_hi[ty][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_hi[j] = fmaf(h, ws[kk][tx + 16 * j], acc_hi[j]);
        }
      }
    }
    __syncthreads();
  }

  const int gr = row0 + ty;
  if (gr >= M) return;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = col0 + tx + 16 * j;
    if (gc < N) {
      float v = full ? acc_hi[j] + acc_lo[j] : acc_hi[j];
      if (b != nullptr) v = v + b[gc];
      y[(size_t)gr * N + gc] = activate(v, act);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  x (M, K), w (K, N), b (N,) or null,
// y (M, N): float32, contiguous, on the current device.  act: 0 none,
// 1 relu, 2 tanh.  Launches on `stream` and returns cudaGetLastError().
extern "C" int fxp_dense_launch(const float* x, const float* w, const float* b, float* y,
                                int M, int K, int N, int full, int act, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fxp_dense_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, w, b, y, M, K, N, full, act);
  return (int)cudaGetLastError();
}

extern "C" const char* fxp_dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

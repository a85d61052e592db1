// Kernel 3: the whole L-layer MLP backward, QAT sites' straight-through
// masks included, for sm_90a.
//
// Replaces the TPU kernel `fxp_mlp_bwd_pallas` → `_mlp_bwd_kernel` in
// src/repro/kernels/fxp_mlp/kernel.py (:223).  From the cotangent g of y
// and the forward's residuals (qs[l], the input layer l's products
// consumed; hs[l], its output after the activation, hs[L-1] = y), walking
// the layers from last to first:
//   1. activation backward from the saved output: ReLU g·[h > 0], tanh
//      g·(1 − h²);
//   2. db_l = Σ_rows g, dW_l = q_lᵀ g;
//   3. g ← g W_lᵀ;
//   4. the site's straight-through mask on its pre-projection input (x0
//      for layer 0, hs[l-1] after): inside [−zδ, (2ⁿ−1−z)δ] in the quant
//      phase, inside the Q15.16 raw range before it; g = 0 outside;
// and dx = g after layer 0.
//
// What bounds it on the H100: 2 products per layer (dW and g Wᵀ), 4·B·MACs
// FLOPs.  The paper's critic (23-400-300-1, 129,500 MACs a row) at B = 128
// is 4·128·129,500 ≈ 66 MFLOP of f32 FMA, ≈ 1.0 µs at the 67 TFLOP/s
// non-tensor peak, against ≈ 1.8 MB of W, dW and residuals (≈ 0.54 µs at
// 3.35 TB/s); the actor (17-400-300-6, 128,600 MACs) is the same to 1 %.
// So it is f32-compute-bound at B = 128, and far from that bound in
// practice: the work is small and split over few blocks (latency-bound).
//
// Design: two launches on the caller's stream, both deterministic.
//  * The TPU grid was sequential ("arbitrary"): dW/db accumulated across
//    row blocks in order.  CUDA blocks are unordered, and atomics would
//    make the sum order, and so two training runs from one seed, differ.
//    So the chain and the reduction over rows are split.
//  * Pass 1 (`bwd_chain_kernel`), one block per row block of BM = 8 rows:
//    steps 1, 3 and 4 layer by layer, the cotangent of the layer output
//    and of its input in two shared-memory buffers.  It stores each
//    layer's cotangent after step 1 to a scratch buffer G_l (M, N_l) that
//    the wrapper allocates, and dx at the end.  For g Wᵀ, W (K, N) is
//    row-major, so one warp takes one input column k: its lanes walk n
//    (coalesced reads of row k of W), each keeping BM partial sums, then
//    a butterfly shuffle reduces them.
//  * Pass 2 (`bwd_dw_kernel`): dW_l = q_lᵀ G_l, tiled 32 × 32 over
//    (K_l, N_l) for every layer in one grid, each tile summing all M rows
//    in a fixed order through 32-row shared-memory tiles of q and G; the
//    tiles at k = 0 also sum db_l.
//  * Plain CUDA-core f32 FMA: q and g are not bf16-exact, so no bf16 or
//    TF32 MMA reproduces the f32 products.  No fast-math.

#include "fxp_common.cuh"

namespace {

using fxp::ste_pass;

constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 8;     // rows per block in pass 1
constexpr int TILE = 32;  // pass 2 tile: 32 (k) × 32 (n) outputs, 32-row steps
constexpr int MAX_SMEM = 232448;  // a block's shared-memory limit on sm_90

struct BwdArgs {
  const float* w[MAX_LAYERS];  // (dims[l], dims[l+1]) row-major
  const float* q[MAX_LAYERS];  // (M, dims[l]) effective dense inputs
  const float* h[MAX_LAYERS];  // (M, dims[l+1]) layer outputs; h[L-1] = y
  float* g[MAX_LAYERS];        // scratch (M, dims[l+1]): cotangent after step 1
  float* dw[MAX_LAYERS];       // (dims[l], dims[l+1])
  float* db[MAX_LAYERS];       // (dims[l+1],)
  int dims[MAX_LAYERS + 1];
  int acts[MAX_LAYERS];        // 0 none, 1 relu, 2 tanh
  int n_layers;
  int stride;                  // row stride of pass 1's shared buffers
  int tile0[MAX_LAYERS + 1];   // pass 2: first tile of layer l; tile0[L] = total
  int tiles_n[MAX_LAYERS];     // pass 2: tiles across dims[l+1]
};

__global__ void __launch_bounds__(THREADS)
bwd_chain_kernel(const float* __restrict__ gy, const float* __restrict__ x0, const BwdArgs args,
                 const float* __restrict__ deltas, const float* __restrict__ zs,
                 float* __restrict__ dx, int M, int quant, int qat, int fxp32_phase1, float q_max) {
  extern __shared__ float smem[];
  const int S = args.stride;
  float* g_s = smem;           // cotangent of the current layer's output
  float* n_s = smem + BM * S;  // cotangent of its input

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int L = args.n_layers;

  const int NL = args.dims[L];
  for (int e = tid; e < BM * NL; e += THREADS) {
    const int r = e / NL, c = e % NL;
    g_s[r * S + c] = r < rows ? gy[(size_t)(row0 + r) * NL + c] : 0.0f;
  }
  __syncthreads();

  for (int l = L - 1; l >= 0; --l) {
    const int K = args.dims[l], N = args.dims[l + 1];

    // ---- 1. activation backward; the layer's cotangent out for pass 2 --
    const float* __restrict__ H = args.h[l];
    float* __restrict__ G = args.g[l];
    const int act = args.acts[l];
    for (int e = tid; e < rows * N; e += THREADS) {
      const int r = e / N, c = e % N;
      const size_t off = (size_t)(row0 + r) * N + c;
      float v = g_s[r * S + c];
      if (act == 1) {
        v = H[off] > 0.0f ? v : 0.0f;
      } else if (act == 2) {
        const float hv = H[off];
        v = v * (1.0f - hv * hv);
      }
      g_s[r * S + c] = v;
      G[off] = v;
    }
    __syncthreads();

    // ---- 3 + 4. g Wᵀ, one warp per input column k; STE mask ------------
    const float* __restrict__ W = args.w[l];
    const float* __restrict__ X = l == 0 ? x0 : args.h[l - 1];
    const float delta = qat ? deltas[l] : 1.0f;
    const float z = qat ? zs[l] : 0.0f;
    const float lo = -z * delta;
    const float hi = (q_max - z) * delta;
    for (int k = warp; k < K; k += WARPS) {
      float acc[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = 0.0f;
      for (int n = lane; n < N; n += 32) {
        const float wv = __ldg(W + (size_t)k * N + n);
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = fmaf(g_s[r * S + n], wv, acc[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      // every lane now holds all BM sums; lane r keeps row r's
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < BM; ++r) v = lane == r ? acc[r] : v;
      if (lane < BM) {
        if (lane < rows) {
          const size_t off = (size_t)(row0 + lane) * K + k;
          if (qat && !ste_pass(X[off], quant, lo, hi, fxp32_phase1)) v = 0.0f;
          if (l == 0) dx[off] = v;
        } else {
          v = 0.0f;
        }
        n_s[lane * S + k] = v;
      }
    }
    __syncthreads();
    float* t = g_s;
    g_s = n_s;
    n_s = t;
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_dw_kernel(const BwdArgs args, int M) {
  __shared__ float q_t[TILE][TILE + 1];  // [row][k]
  __shared__ float g_t[TILE][TILE + 1];  // [row][n]

  int l = 0;
  while (blockIdx.x >= args.tile0[l + 1]) ++l;
  const int tile = blockIdx.x - args.tile0[l];
  const int kt = tile / args.tiles_n[l], nt = tile % args.tiles_n[l];
  const int K = args.dims[l], N = args.dims[l + 1];
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tx = threadIdx.x % TILE;  // n within the tile
  const int ty = threadIdx.x / TILE;  // k = ty, ty + 8, ty + 16, ty + 24
  const float* __restrict__ Q = args.q[l];
  const float* __restrict__ G = args.g[l];

  float acc[TILE / 8];
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) acc[i] = 0.0f;
  float bias = 0.0f;
  const bool does_db = kt == 0 && ty == 0;

  for (int m0 = 0; m0 < M; m0 += TILE) {
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE;
      const int m = m0 + r;
      q_t[r][c] = (m < M && k0 + c < K) ? Q[(size_t)m * K + k0 + c] : 0.0f;
      g_t[r][c] = (m < M && n0 + c < N) ? G[(size_t)m * N + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < TILE; ++r) {
      const float gv = g_t[r][tx];
#pragma unroll
      for (int i = 0; i < TILE / 8; ++i) acc[i] = fmaf(q_t[r][ty + 8 * i], gv, acc[i]);
      if (does_db) bias += gv;
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < TILE / 8; ++i) {
      const int k = k0 + ty + 8 * i;
      if (k < K) args.dw[l][(size_t)k * N + n] = acc[i];
    }
    if (does_db) args.db[l][n] = bias;
  }
}

}  // namespace

// C interface, loaded with ctypes.  gy (M, dims[L]); x0 (M, dims[0]);
// weights[l] (dims[l], dims[l+1]); qs[l] (M, dims[l]); hs[l]
// (M, dims[l+1]) with hs[L-1] = y; gs[l] (M, dims[l+1]) scratch; dws[l]
// (dims[l], dims[l+1]) and dbs[l] (dims[l+1],) outputs; deltas/zs
// (n_layers,) or null when qat == 0; dx (M, dims[0]).  All float32,
// contiguous, on the current device.  Launches pass 1 and pass 2 on
// `stream` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernels do not take).
extern "C" int fxp_mlp_bwd_launch(const float* gy, const float* x0, const void* const* weights,
                                  const void* const* qs, const void* const* hs, void* const* gs,
                                  void* const* dws, void* const* dbs, const int* dims,
                                  const int* acts, int n_layers, const float* deltas,
                                  const float* zs, float* dx, int M, int quant, int qat,
                                  int fxp32_phase1, int n_bits, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24)
    return (int)cudaErrorInvalidValue;
  if (qat && (deltas == nullptr || zs == nullptr)) return (int)cudaErrorInvalidValue;
  BwdArgs args = {};
  args.n_layers = n_layers;
  args.stride = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    args.dims[l] = dims[l];
    args.stride = dims[l] > args.stride ? dims[l] : args.stride;
  }
  args.tile0[0] = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < 0 || acts[l] > 2) return (int)cudaErrorInvalidValue;
    args.w[l] = static_cast<const float*>(weights[l]);
    args.q[l] = static_cast<const float*>(qs[l]);
    args.h[l] = static_cast<const float*>(hs[l]);
    args.g[l] = static_cast<float*>(gs[l]);
    args.dw[l] = static_cast<float*>(dws[l]);
    args.db[l] = static_cast<float*>(dbs[l]);
    if (!args.w[l] || !args.q[l] || !args.h[l] || !args.g[l] || !args.dw[l] || !args.db[l])
      return (int)cudaErrorInvalidValue;
    args.acts[l] = acts[l];
    const int tk = (dims[l] + TILE - 1) / TILE, tn = (dims[l + 1] + TILE - 1) / TILE;
    args.tiles_n[l] = tn;
    args.tile0[l + 1] = args.tile0[l] + tk * tn;
  }
  const size_t smem = (size_t)2 * BM * args.stride * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const float q_max = (float)((1 << n_bits) - 1);
  bwd_chain_kernel<<<(M + BM - 1) / BM, THREADS, smem, s>>>(gy, x0, args, deltas, zs, dx, M, quant,
                                                            qat, fxp32_phase1, q_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dw_kernel<<<args.tile0[n_layers], THREADS, 0, s>>>(args, M);
  return (int)cudaGetLastError();
}

extern "C" const char* fxp_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

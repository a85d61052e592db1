// Kernels 4 and 5: one whole DDPG update — critic BP/WU, then actor BP/WU
// through the updated critic — in four launches, for sm_90a.
//
// Replaces the TPU kernels `ddpg_critic_step_pallas` →
// `_ddpg_critic_step_kernel` (kernel 4) and `ddpg_actor_step_pallas` →
// `_ddpg_actor_step_kernel` (kernel 5) in src/repro/kernels/fxp_mlp/
// kernel.py (:481, :632).
//
// Kernel 4, per batch row: the target actor on next_obs (no monitors);
// the target critic on (next_obs, next_a); the TD target
// y = r + γ(1 − done)·q_next; the online critic on (obs, action) with the
// site monitors, storing the products' inputs; the loss partials
// Σ w(q − y)² and Σ w·y; the weighted-MSE cotangent (w/Σw)·2(q − y) down
// the critic, dW = qᵀG and db = ΣG; then Adam (Q15.16 grads and params
// when fxp_weights) and the Polyak update of the target critic.
// Kernel 5: the actor forward with monitors; the updated critic on
// (obs, a) with the critic sites' monitors (layer 0's over obs and a
// together); the partial Σ w·q; the policy-gradient cotangent −w/Σw down
// the critic, dx only, the straight-through mask on the action segment;
// the actor's chain, dW/db, Adam and the target actor's Polyak update.
// Every layer is kernel B's datapath (site projection, bf16 hi limb, the
// lo limb in the monitor phase, bias, activation) and every backward
// step kernel 3's (activation backward, g Wᵀ, the site's STE mask).
//
// What bounds it on the H100, at the paper's shapes (actor 17-400-300-6,
// 128,600 MACs a row; critic 23-400-300-1, 129,500) and B = 128: kernel 4
// runs three forwards (two passes each in the monitor phase, one in the
// quant phase) and the critic's two backward products: ≈ 265 MFLOP of f32
// FMA in the monitor phase (≈ 4.0 µs at the 67 TFLOP/s non-tensor peak),
// ≈ 166 MFLOP in the quant phase (≈ 2.5 µs), against ≈ 4.7 MB of
// parameter, moment and target trees read and written (≈ 1.4 µs at
// 3.35 TB/s); kernel 5 ≈ 231 / 165 MFLOP and ≈ 4.6 MB.  So
// f32-compute-bound on paper, and latency-bound in practice: the chain
// pass has 16 blocks at B = 128, each walking the layers in order.
//
// Design:
//  * The TPU grid ran row blocks in order ("arbitrary"), accumulated dW/db
//    in VMEM and ran Adam on the last block.  CUDA blocks are unordered,
//    so each kernel is two launches, as kernel 3 is (fxp_mlp_bwd.cu):
//    pass 1 (`critic_chain_kernel`, `actor_chain_kernel`), one block per 8
//    rows, runs the forwards and the cotangent chain in shared memory and
//    stores what the products need: each trained layer's input q_l
//    (M, K_l) and post-activation cotangent G_l (M, N_l), plus per-block
//    monitor rows and loss partials.  Pass 2 (`reduce_update_kernel`) sums
//    dW = qᵀG and db = ΣG over all rows in a fixed order, 32 × 32 output
//    tiles of every layer in one grid, and each tile then applies Adam and
//    the Polyak update to the parameters it owns: it holds their whole
//    gradient, so there is no last block and no grid-wide barrier.  No
//    atomics: two calls are bitwise equal.
//  * The phase is a device int32 and the 12 step scalars (1/max(Σw, 1), γ,
//    τ, 1 − τ and Adam's constants with the bias corrections of this step,
//    the reference's hyper vector) a device float array, both read
//    in-kernel, so a captured CUDA graph replays with each step's values.
//  * The epilogue is `optim/fxp_adam.leaf_update` and (1 − τ)·t + τ·p bit
//    for bit: every product and sum is __fmul_rn/__fadd_rn, so nvcc cannot
//    contract it into an FMA that PyTorch's separate ops do not do; IEEE
//    division and square root; no fast-math.  The tanh backward is written
//    the same way.
//  * The critic's first layer reads its (obs, action) concat from one
//    shared-memory row; the reference split that weight by rows for the
//    TPU's lanes, which changes its sum order at ulp level only.
//  * Weights are streamed from L2, one thread per output column walking k
//    (kernel B), and g Wᵀ is one warp per input column with a butterfly
//    reduce (kernel 3).  Rows with w = 0 carry an exactly zero cotangent,
//    so they add exactly zero to dW and db.

#include "fxp_common.cuh"

namespace {

using fxp::activate;
using fxp::bf16_hi;
using fxp::site_project;
using fxp::ste_pass;

constexpr int MAX_LAYERS = 4;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 8;     // rows per block in pass 1
constexpr int TILE = 32;  // pass 2 tile: 32 (k) × 32 (n) outputs, 32-row steps
constexpr int MAX_SMEM = 232448;  // a block's shared-memory limit on sm_90

// the hyper vector (src/repro/kernels/fxp_mlp/kernel.py:42-54)
constexpr int H_INVW = 0, H_GAMMA = 1, H_TAU = 2, H_OMTAU = 3, H_LR = 4, H_B1 = 5, H_OMB1 = 6,
              H_B2 = 7, H_OMB2 = 8, H_EPS = 9, H_BC1 = 10, H_BC2 = 11;

struct Net {
  const float* w[MAX_LAYERS];  // (dims[l], dims[l+1]) row-major
  const float* b[MAX_LAYERS];  // (dims[l+1],)
  int dims[MAX_LAYERS + 1];
  int acts[MAX_LAYERS];  // 0 none, 1 relu, 2 tanh
};

struct Sites {  // 2L sites: the actor's 0..L-1, the critic's L..2L-1
  const float* deltas;
  const float* zs;
  int qat;
  int fxp32_phase1;
  float q_max;
};

struct CriticArgs {
  Net actor_t, critic_t, critic;
  const float* obs;  // (M, O)
  const float* action;  // (M, A)
  const float* reward;  // (M,)
  const float* done;  // (M,) 0/1
  const float* w;  // (M,) row weights
  const float* next_obs;  // (M, O)
  float* q[MAX_LAYERS];  // (M, K_l) the online critic's product inputs
  float* g[MAX_LAYERS];  // (M, N_l) its post-activation cotangents
  float* mins;  // (n_blocks, L)
  float* maxs;
  float* part;  // (n_blocks, 2)
  int n_layers, obs_dim, act_dim, M, maxw;
};

struct ActorArgs {
  Net actor, critic;
  const float* obs;  // (M, O)
  const float* w;  // (M,)
  float* q[MAX_LAYERS];  // (M, K_l) the actor's product inputs
  float* g[MAX_LAYERS];  // (M, N_l) its post-activation cotangents
  float* mins;  // (n_blocks, 2L): actor sites, then critic sites
  float* maxs;
  float* part;  // (n_blocks, 1)
  int n_layers, obs_dim, act_dim, M, maxw;
};

// One leaf set of pass 2: inputs and outputs may alias (elementwise).
struct UpdateArgs {
  const float* q[MAX_LAYERS];
  const float* g[MAX_LAYERS];
  const float* p[2 * MAX_LAYERS];  // interleaved w0, b0, w1, b1, ...
  const float* m[2 * MAX_LAYERS];
  const float* v[2 * MAX_LAYERS];
  const float* t[2 * MAX_LAYERS];
  float* po[2 * MAX_LAYERS];
  float* mo[2 * MAX_LAYERS];
  float* vo[2 * MAX_LAYERS];
  float* to[2 * MAX_LAYERS];
  int dims[MAX_LAYERS + 1];
  int n_layers;
  int tile0[MAX_LAYERS + 1];  // first tile of layer l; tile0[L] = total
  int tiles_n[MAX_LAYERS];
};

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// Min/max of the block's valid rows of x (BM, K at stride ldx), written by
// thread 0; `red` is 2·WARPS floats of shared memory.
__device__ void monitor(const float* x, int ldx, int K, int rows, float* out_min, float* out_max,
                        float* red) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float mn = f32_inf(), mx = -f32_inf();
  for (int e = tid; e < rows * K; e += THREADS) {
    const float v = x[(e / K) * ldx + e % K];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) {
    red[warp] = mn;
    red[WARPS + warp] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < WARPS; ++i) {
      mn = fminf(mn, red[i]);
      mx = fmaxf(mx, red[WARPS + i]);
    }
    *out_min = mn;
    *out_max = mx;
  }
  __syncthreads();
}

// One dense layer of kernel B for the block's BM rows: x (BM, K at stride
// ldx) → out (BM, N at stride ldo) = act(x̂·W + b), x̂ the site projection
// of x (site >= 0) split into hi and lo limbs.  With q_out, the valid
// rows' product inputs (hi in the quant phase, x̂ before it) go to
// q_out (M, K).
__device__ void dense(const float* x, int ldx, int K, const float* __restrict__ W,
                      const float* __restrict__ B, int N, int act, float* out, int ldo,
                      float* hi_s, float* lo_s, int quant, const Sites& st, int site,
                      float* __restrict__ q_out, int row0, int rows) {
  const int tid = threadIdx.x;
  const bool project = st.qat && site >= 0;
  const float delta = project ? st.deltas[site] : 1.0f;
  const float z = project ? st.zs[site] : 0.0f;
  for (int e = tid; e < BM * K; e += THREADS) {
    const int r = e / K, c = e % K;
    float v = x[r * ldx + c];
    if (project) v = site_project(v, quant, delta, z, st.q_max, st.fxp32_phase1);
    const float h = bf16_hi(v);
    hi_s[e] = h;
    lo_s[e] = v - h;
    if (q_out != nullptr && r < rows) q_out[(size_t)(row0 + r) * K + c] = quant ? h : v;
  }
  __syncthreads();
  for (int n = tid; n < N; n += THREADS) {
    float ah[BM], al[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) ah[r] = al[r] = 0.0f;
    if (quant) {
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(W + (size_t)k * N + n);
#pragma unroll
        for (int r = 0; r < BM; ++r) ah[r] = fmaf(hi_s[r * K + k], wv, ah[r]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(W + (size_t)k * N + n);
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          ah[r] = fmaf(hi_s[r * K + k], wv, ah[r]);
          al[r] = fmaf(lo_s[r * K + k], wv, al[r]);
        }
      }
    }
    const float bias = __ldg(B + n);
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float acc = quant ? ah[r] : ah[r] + al[r];
      out[r * ldo + n] = activate(acc + bias, act);
    }
  }
  __syncthreads();
}

// Activation backward in place on g (BM, N) from the layer's output h (BM,
// N at stride ldh); rows past `rows` become 0.  With G, the valid rows go
// to G (M, N) for pass 2.
__device__ void act_bwd(float* g, int N, const float* h, int ldh, int act, int rows,
                        float* __restrict__ G, int row0) {
  for (int e = threadIdx.x; e < BM * N; e += THREADS) {
    const int r = e / N, c = e % N;
    float v = g[e];
    if (r >= rows) {
      v = 0.0f;
    } else if (act == 1) {
      v = h[r * ldh + c] > 0.0f ? v : 0.0f;
    } else if (act == 2) {
      const float hv = h[r * ldh + c];
      v = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(hv, hv)));
    }
    g[e] = v;
    if (G != nullptr && r < rows) G[(size_t)(row0 + r) * N + c] = v;
  }
  __syncthreads();
}

// out (BM, k1 − k0) = g (BM, N) · W[k0:k1, :]ᵀ (W (K, N) row-major), one
// warp per input column k; then the straight-through mask of `site` on the
// layer's pre-projection input x_in (BM rows at stride ldx, column k).
__device__ void grad_input(const float* g, int N, const float* __restrict__ W, int k0, int k1,
                           float* out, const float* x_in, int ldx, int quant, const Sites& st,
                           int site, int rows) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool mask = st.qat && site >= 0;
  const float delta = mask ? st.deltas[site] : 1.0f;
  const float z = mask ? st.zs[site] : 0.0f;
  const float lo = -z * delta;
  const float hi = (st.q_max - z) * delta;
  const int width = k1 - k0;
  for (int k = k0 + warp; k < k1; k += WARPS) {
    float acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.0f;
    for (int n = lane; n < N; n += 32) {
      const float wv = __ldg(W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = fmaf(g[r * N + n], wv, acc[r]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    float v = 0.0f;  // every lane holds all BM sums; lane r keeps row r's
#pragma unroll
    for (int r = 0; r < BM; ++r) v = lane == r ? acc[r] : v;
    if (lane < BM) {
      if (lane >= rows || (mask && !ste_pass(x_in[lane * ldx + k], quant, lo, hi, st.fxp32_phase1)))
        v = 0.0f;
      out[lane * width + (k - k0)] = v;
    }
  }
  __syncthreads();
}

// Load the block's rows of src (M, K) into dst (BM, K at stride ldd);
// rows past the batch are 0.
__device__ void load_rows(const float* __restrict__ src, int K, float* dst, int ldd, int row0, int rows) {
  for (int e = threadIdx.x; e < BM * K; e += THREADS) {
    const int r = e / K, c = e % K;
    dst[r * ldd + c] = r < rows ? src[(size_t)(row0 + r) * K + c] : 0.0f;
  }
}

// Pass 1 of kernel 4 (the module comment).  Shared memory: tc (target
// critic input), xc (online critic input), the online critic's layer
// outputs, two ping-pong buffers and the two limbs.
__global__ void __launch_bounds__(THREADS)
critic_chain_kernel(const CriticArgs a, const Sites st, const float* __restrict__ hyper,
                    const int* __restrict__ phase) {
  extern __shared__ float smem[];
  __shared__ float red[2 * WARPS];
  __shared__ float y_s[BM], d_s[BM], w_s[BM];
  const int L = a.n_layers, O = a.obs_dim, A = a.act_dim, C = O + A, MW = a.maxw;
  const int quant = __ldg(phase) > 0;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, a.M - row0);
  const Net& at = a.actor_t;
  const Net& ct = a.critic_t;
  const Net& cn = a.critic;

  float* tc = smem;
  float* xc = tc + BM * C;
  float* hc[MAX_LAYERS];
  float* p = xc + BM * C;
  for (int l = 0; l < L; ++l) {
    hc[l] = p;
    p += BM * cn.dims[l + 1];
  }
  float* pp[2] = {p, p + BM * MW};
  float* hi_s = pp[1] + BM * MW;
  float* lo_s = hi_s + BM * MW;

  load_rows(a.next_obs, O, tc, C, row0, rows);
  load_rows(a.obs, O, xc, C, row0, rows);
  load_rows(a.action, A, xc + O, C, row0, rows);
  if (tid < BM) w_s[tid] = tid < rows ? a.w[row0 + tid] : 0.0f;
  __syncthreads();

  // ---- target actor on next_obs, its action into tc[:, O:] ---------------
  const float* x = tc;
  int ldx = C;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    float* out = last ? tc + O : pp[l % 2];
    const int ldo = last ? C : at.dims[l + 1];
    dense(x, ldx, at.dims[l], at.w[l], at.b[l], at.dims[l + 1], at.acts[l], out, ldo, hi_s, lo_s,
          quant, st, l, nullptr, row0, rows);
    x = out;
    ldx = ldo;
  }
  // ---- target critic on (next_obs, next_a) --------------------------------
  x = tc;
  ldx = C;
  for (int l = 0; l < L; ++l) {
    float* out = pp[l % 2];
    dense(x, ldx, ct.dims[l], ct.w[l], ct.b[l], ct.dims[l + 1], ct.acts[l], out, ct.dims[l + 1],
          hi_s, lo_s, quant, st, L + l, nullptr, row0, rows);
    x = out;
    ldx = ct.dims[l + 1];
  }
  // ---- TD target ------------------------------------------------------------
  if (tid < rows) {
    const float gamma = hyper[H_GAMMA];
    const float not_done = __fsub_rn(1.0f, a.done[row0 + tid]);
    y_s[tid] = __fadd_rn(a.reward[row0 + tid], __fmul_rn(__fmul_rn(gamma, not_done), x[tid * ldx]));
  }
  // ---- online critic: monitors and the product inputs -----------------------
  x = xc;
  ldx = C;
  for (int l = 0; l < L; ++l) {
    monitor(x, ldx, cn.dims[l], rows, a.mins + (size_t)blockIdx.x * L + l,
            a.maxs + (size_t)blockIdx.x * L + l, red);
    dense(x, ldx, cn.dims[l], cn.w[l], cn.b[l], cn.dims[l + 1], cn.acts[l], hc[l],
          cn.dims[l + 1], hi_s, lo_s, quant, st, L + l, a.q[l], row0, rows);
    x = hc[l];
    ldx = cn.dims[l + 1];
  }
  // ---- loss partials, then the weighted-MSE cotangent of q ----------------
  const int NL = cn.dims[L];
  if (tid < rows) d_s[tid] = __fsub_rn(hc[L - 1][tid * NL], y_s[tid]);
  __syncthreads();
  if (tid == 0) {
    float s_loss = 0.0f, s_y = 0.0f;
    for (int r = 0; r < rows; ++r) {
      s_loss = __fadd_rn(s_loss, __fmul_rn(w_s[r], __fmul_rn(d_s[r], d_s[r])));
      s_y = __fadd_rn(s_y, __fmul_rn(w_s[r], y_s[r]));
    }
    a.part[(size_t)blockIdx.x * 2] = s_loss;
    a.part[(size_t)blockIdx.x * 2 + 1] = s_y;
  }
  float* g_s = pp[0];
  float* n_s = pp[1];
  const float inv_w = hyper[H_INVW];
  for (int e = tid; e < BM * NL; e += THREADS) {
    const int r = e / NL, c = e % NL;
    g_s[e] = (c == 0 && r < rows) ? __fmul_rn(__fmul_rn(inv_w, w_s[r]), __fmul_rn(2.0f, d_s[r])) : 0.0f;
  }
  __syncthreads();
  // ---- the chain: G_l for pass 2, g Wᵀ and the STE mask below ----------------
  for (int l = L - 1; l >= 0; --l) {
    const int N = cn.dims[l + 1];
    act_bwd(g_s, N, hc[l], N, cn.acts[l], rows, a.g[l], row0);
    if (l > 0) {
      grad_input(g_s, N, cn.w[l], 0, cn.dims[l], n_s, hc[l - 1], cn.dims[l], quant, st, L + l, rows);
      float* t = g_s;
      g_s = n_s;
      n_s = t;
    }
  }
}

// Pass 1 of kernel 5.  Shared memory: xa = (obs, a), the actor's hidden
// outputs, the critic's layer outputs, and the two limbs (which hold the
// cotangents once the forwards are done).
__global__ void __launch_bounds__(THREADS)
actor_chain_kernel(const ActorArgs a, const Sites st, const float* __restrict__ hyper,
                   const int* __restrict__ phase) {
  extern __shared__ float smem[];
  __shared__ float red[2 * WARPS];
  __shared__ float w_s[BM];
  const int L = a.n_layers, O = a.obs_dim, A = a.act_dim, C = O + A, MW = a.maxw;
  const int quant = __ldg(phase) > 0;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, a.M - row0);
  const Net& an = a.actor;
  const Net& cn = a.critic;
  float* mins = a.mins + (size_t)blockIdx.x * 2 * L;
  float* maxs = a.maxs + (size_t)blockIdx.x * 2 * L;

  float* xa = smem;
  float* ha[MAX_LAYERS];  // the actor's outputs; the last is xa[:, O:]
  float* hc[MAX_LAYERS];
  float* p = xa + BM * C;
  for (int l = 0; l < L - 1; ++l) {
    ha[l] = p;
    p += BM * an.dims[l + 1];
  }
  ha[L - 1] = xa + O;
  for (int l = 0; l < L; ++l) {
    hc[l] = p;
    p += BM * cn.dims[l + 1];
  }
  float* hi_s = p;
  float* lo_s = hi_s + BM * MW;

  load_rows(a.obs, O, xa, C, row0, rows);
  if (tid < BM) w_s[tid] = tid < rows ? a.w[row0 + tid] : 0.0f;
  __syncthreads();

  // ---- actor forward: monitors and the product inputs ----------------------
  const float* x = xa;
  int ldx = C;
  for (int l = 0; l < L; ++l) {
    const int ldo = l == L - 1 ? C : an.dims[l + 1];
    monitor(x, ldx, an.dims[l], rows, mins + l, maxs + l, red);
    dense(x, ldx, an.dims[l], an.w[l], an.b[l], an.dims[l + 1], an.acts[l], ha[l], ldo, hi_s, lo_s,
          quant, st, l, a.q[l], row0, rows);
    x = ha[l];
    ldx = ldo;
  }
  // ---- updated critic on (obs, a): layer 0's monitor sees both segments ---
  x = xa;
  ldx = C;
  for (int l = 0; l < L; ++l) {
    monitor(x, ldx, cn.dims[l], rows, mins + L + l, maxs + L + l, red);
    dense(x, ldx, cn.dims[l], cn.w[l], cn.b[l], cn.dims[l + 1], cn.acts[l], hc[l], cn.dims[l + 1],
          hi_s, lo_s, quant, st, L + l, nullptr, row0, rows);
    x = hc[l];
    ldx = cn.dims[l + 1];
  }
  const int NL = cn.dims[L];
  if (tid == 0) {
    float s_q = 0.0f;
    for (int r = 0; r < rows; ++r) s_q = __fadd_rn(s_q, __fmul_rn(w_s[r], hc[L - 1][r * NL]));
    a.part[blockIdx.x] = s_q;
  }
  // ---- policy-gradient cotangent, dx only through the critic -------------
  float* g_s = hi_s;
  float* n_s = lo_s;
  const float neg_inv_w = -hyper[H_INVW];
  for (int e = tid; e < BM * NL; e += THREADS) {
    const int r = e / NL, c = e % NL;
    g_s[e] = (c == 0 && r < rows) ? __fmul_rn(neg_inv_w, w_s[r]) : 0.0f;
  }
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int N = cn.dims[l + 1];
    act_bwd(g_s, N, hc[l], N, cn.acts[l], rows, nullptr, row0);
    if (l > 0) {
      grad_input(g_s, N, cn.w[l], 0, cn.dims[l], n_s, hc[l - 1], cn.dims[l], quant, st, L + l, rows);
    } else {  // the action columns of the concat: da, masked at the critic's l0 site
      grad_input(g_s, N, cn.w[0], O, C, n_s, xa, C, quant, st, L, rows);
    }
    float* t = g_s;
    g_s = n_s;
    n_s = t;
  }
  // ---- the actor's chain: G_l for pass 2 --------------------------------------
  for (int l = L - 1; l >= 0; --l) {
    const int N = an.dims[l + 1];
    act_bwd(g_s, N, ha[l], l == L - 1 ? C : N, an.acts[l], rows, a.g[l], row0);
    if (l > 0) {
      grad_input(g_s, N, an.w[l], 0, an.dims[l], n_s, ha[l - 1], an.dims[l], quant, st, l, rows);
      float* t = g_s;
      g_s = n_s;
      n_s = t;
    }
  }
}

// `optim/fxp_adam.leaf_update` (or `adam.leaf_update`) and the Polyak
// update for one parameter, each operation rounded on its own.
__device__ __forceinline__ float q1516(float v) {
  return rintf(fminf(fmaxf(__fmul_rn(v, 65536.0f), -2147483648.0f), 2147483647.0f)) * (1.0f / 65536.0f);
}

__device__ __forceinline__ void adam_soft(const float* __restrict__ hyper, int fxp_weights, float p,
                                          float g, float m, float v, float t, float* po, float* mo,
                                          float* vo, float* to) {
  if (fxp_weights) g = q1516(g);
  const float m2 = __fadd_rn(__fmul_rn(hyper[H_B1], m), __fmul_rn(hyper[H_OMB1], g));
  const float v2 = __fadd_rn(__fmul_rn(hyper[H_B2], v), __fmul_rn(hyper[H_OMB2], __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m2, hyper[H_BC1]);
  const float vhat = __fdiv_rn(v2, hyper[H_BC2]);
  const float delta = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), hyper[H_EPS]));
  float p2 = __fsub_rn(p, __fmul_rn(hyper[H_LR], delta));
  if (fxp_weights) p2 = q1516(p2);
  *po = p2;
  *mo = m2;
  *vo = v2;
  *to = __fadd_rn(__fmul_rn(hyper[H_OMTAU], t), __fmul_rn(hyper[H_TAU], p2));
}

// Pass 2 of both kernels: dW = qᵀG and db = ΣG over all M rows in a fixed
// order, tile by tile, then Adam and the Polyak update of the tile's own
// parameters.
__global__ void __launch_bounds__(THREADS)
reduce_update_kernel(const UpdateArgs u, const float* __restrict__ hyper, int fxp_weights, int M) {
  __shared__ float q_t[TILE][TILE + 1];  // [row][k]
  __shared__ float g_t[TILE][TILE + 1];  // [row][n]

  int l = 0;
  while (blockIdx.x >= u.tile0[l + 1]) ++l;
  const int tile = blockIdx.x - u.tile0[l];
  const int kt = tile / u.tiles_n[l], nt = tile % u.tiles_n[l];
  const int K = u.dims[l], N = u.dims[l + 1];
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tx = threadIdx.x % TILE;  // n within the tile
  const int ty = threadIdx.x / TILE;  // k = ty, ty + 8, ty + 16, ty + 24
  const float* __restrict__ Q = u.q[l];
  const float* __restrict__ G = u.g[l];

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
  if (n >= N) return;
  const int wl = 2 * l, bl = 2 * l + 1;
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const int k = k0 + ty + 8 * i;
    if (k < K) {
      const size_t e = (size_t)k * N + n;
      adam_soft(hyper, fxp_weights, u.p[wl][e], acc[i], u.m[wl][e], u.v[wl][e], u.t[wl][e],
                u.po[wl] + e, u.mo[wl] + e, u.vo[wl] + e, u.to[wl] + e);
    }
  }
  if (does_db)
    adam_soft(hyper, fxp_weights, u.p[bl][n], bias, u.m[bl][n], u.v[bl][n], u.t[bl][n],
              u.po[bl] + n, u.mo[bl] + n, u.vo[bl] + n, u.to[bl] + n);
}

// ---- host side ---------------------------------------------------------------

bool fill_net(Net& net, const void* const* wb, const int* dims, const int* acts, int L) {
  for (int l = 0; l <= L; ++l) {
    if (dims[l] <= 0) return false;
    net.dims[l] = dims[l];
  }
  for (int l = 0; l < L; ++l) {
    if (acts[l] < 0 || acts[l] > 2 || wb[2 * l] == nullptr || wb[2 * l + 1] == nullptr) return false;
    net.w[l] = static_cast<const float*>(wb[2 * l]);
    net.b[l] = static_cast<const float*>(wb[2 * l + 1]);
    net.acts[l] = acts[l];
  }
  return true;
}

int max_width(const int* dims, int L) {
  int w = 0;
  for (int l = 0; l <= L; ++l) w = dims[l] > w ? dims[l] : w;
  return w;
}

bool fill_update(UpdateArgs& u, void* const* qs, void* const* gs, const void* const* p,
                 const void* const* m, const void* const* v, const void* const* t, void* const* po,
                 void* const* mo, void* const* vo, void* const* to, const int* dims, int L) {
  u.n_layers = L;
  u.tile0[0] = 0;
  for (int l = 0; l <= L; ++l) u.dims[l] = dims[l];
  for (int l = 0; l < L; ++l) {
    u.q[l] = static_cast<const float*>(qs[l]);
    u.g[l] = static_cast<const float*>(gs[l]);
    if (!u.q[l] || !u.g[l]) return false;
    const int tk = (dims[l] + TILE - 1) / TILE, tn = (dims[l + 1] + TILE - 1) / TILE;
    u.tiles_n[l] = tn;
    u.tile0[l + 1] = u.tile0[l] + tk * tn;
  }
  for (int i = 0; i < 2 * L; ++i) {
    u.p[i] = static_cast<const float*>(p[i]);
    u.m[i] = static_cast<const float*>(m[i]);
    u.v[i] = static_cast<const float*>(v[i]);
    u.t[i] = static_cast<const float*>(t[i]);
    u.po[i] = static_cast<float*>(po[i]);
    u.mo[i] = static_cast<float*>(mo[i]);
    u.vo[i] = static_cast<float*>(vo[i]);
    u.to[i] = static_cast<float*>(to[i]);
    if (!u.p[i] || !u.m[i] || !u.v[i] || !u.t[i] || !u.po[i] || !u.mo[i] || !u.vo[i] || !u.to[i])
      return false;
  }
  return true;
}

// A kernel's dynamic shared-memory limit is raised only when a launch
// needs more than it was granted before, so a launch inside a CUDA-graph
// capture, after an eager one at the same shapes, makes no attribute call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

size_t critic_smem_granted = 48 * 1024;
size_t actor_smem_granted = 48 * 1024;

}  // namespace

// C interfaces, loaded with ctypes.  Trees are arrays of 2L pointers,
// interleaved (w0, b0, w1, b1, ...); the output trees may be the input
// trees (the update is elementwise per parameter).  dims/acts are L + 1
// and L ints.  deltas/zs (2L,) (actor sites, then critic sites) or null
// when qat == 0; hyper (12,) float32 and phase (1,) int32 on the device.
// qs[l] (M, K_l) and gs[l] (M, N_l) are scratch for the trained net.
// Every array float32, contiguous, on the current device.  Each launches
// its two passes on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernels do not take).

// Kernel 4: mins/maxs (ceil(M/8), L), part (ceil(M/8), 2).
extern "C" int fxp_ddpg_step_critic_launch(
    const float* obs, const float* action, const float* reward, const float* done,
    const float* w, const float* next_obs, int M, int obs_dim, int act_dim,
    const void* const* actor_t, const void* const* critic, const void* const* critic_m,
    const void* const* critic_v, const void* const* critic_t, void* const* out_p,
    void* const* out_m, void* const* out_v, void* const* out_t, const int* actor_dims,
    const int* actor_acts, const int* critic_dims, const int* critic_acts, int n_layers,
    const float* deltas, const float* zs, const float* hyper, const int* phase, void* const* qs,
    void* const* gs, float* mins, float* maxs, float* part, int qat, int fxp32_phase1,
    int fxp_weights, int n_bits, void* stream) {
  const int L = n_layers;
  if (L < 1 || L > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24) return (int)cudaErrorInvalidValue;
  if ((qat && (!deltas || !zs)) || !hyper || !phase) return (int)cudaErrorInvalidValue;
  if (actor_dims[0] != obs_dim || actor_dims[L] != act_dim || critic_dims[0] != obs_dim + act_dim)
    return (int)cudaErrorInvalidValue;
  CriticArgs a = {};
  if (!fill_net(a.actor_t, actor_t, actor_dims, actor_acts, L) ||
      !fill_net(a.critic_t, critic_t, critic_dims, critic_acts, L) ||
      !fill_net(a.critic, critic, critic_dims, critic_acts, L))
    return (int)cudaErrorInvalidValue;
  a.obs = obs;
  a.action = action;
  a.reward = reward;
  a.done = done;
  a.w = w;
  a.next_obs = next_obs;
  for (int l = 0; l < L; ++l) {
    a.q[l] = static_cast<float*>(qs[l]);
    a.g[l] = static_cast<float*>(gs[l]);
  }
  a.mins = mins;
  a.maxs = maxs;
  a.part = part;
  a.n_layers = L;
  a.obs_dim = obs_dim;
  a.act_dim = act_dim;
  a.M = M;
  const int aw = max_width(actor_dims, L), cw = max_width(critic_dims, L);
  a.maxw = aw > cw ? aw : cw;
  int floats = 2 * (obs_dim + act_dim) + 4 * a.maxw;
  for (int l = 1; l <= L; ++l) floats += critic_dims[l];
  const size_t smem = (size_t)BM * floats * sizeof(float);
  UpdateArgs u = {};
  if (!fill_update(u, qs, gs, critic, critic_m, critic_v, critic_t, out_p, out_m, out_v, out_t,
                   critic_dims, L))
    return (int)cudaErrorInvalidValue;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(critic_chain_kernel, smem, critic_smem_granted);
  if (err != cudaSuccess) return (int)err;
  const Sites st = {deltas, zs, qat, fxp32_phase1, (float)((1 << n_bits) - 1)};
  const cudaStream_t s = (cudaStream_t)stream;
  critic_chain_kernel<<<(M + BM - 1) / BM, THREADS, smem, s>>>(a, st, hyper, phase);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_update_kernel<<<u.tile0[L], THREADS, 0, s>>>(u, hyper, fxp_weights, M);
  return (int)cudaGetLastError();
}

// Kernel 5: critic is the updated critic; mins/maxs (ceil(M/8), 2L),
// part (ceil(M/8), 1).
extern "C" int fxp_ddpg_step_actor_launch(
    const float* obs, const float* w, int M, int obs_dim, int act_dim, const void* const* actor,
    const void* const* actor_m, const void* const* actor_v, const void* const* actor_t,
    void* const* out_p, void* const* out_m, void* const* out_v, void* const* out_t,
    const void* const* critic, const int* actor_dims, const int* actor_acts,
    const int* critic_dims, const int* critic_acts, int n_layers, const float* deltas,
    const float* zs, const float* hyper, const int* phase, void* const* qs, void* const* gs,
    float* mins, float* maxs, float* part, int qat, int fxp32_phase1, int fxp_weights, int n_bits,
    void* stream) {
  const int L = n_layers;
  if (L < 1 || L > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24) return (int)cudaErrorInvalidValue;
  if ((qat && (!deltas || !zs)) || !hyper || !phase) return (int)cudaErrorInvalidValue;
  if (actor_dims[0] != obs_dim || actor_dims[L] != act_dim || critic_dims[0] != obs_dim + act_dim)
    return (int)cudaErrorInvalidValue;
  ActorArgs a = {};
  if (!fill_net(a.actor, actor, actor_dims, actor_acts, L) ||
      !fill_net(a.critic, critic, critic_dims, critic_acts, L))
    return (int)cudaErrorInvalidValue;
  a.obs = obs;
  a.w = w;
  for (int l = 0; l < L; ++l) {
    a.q[l] = static_cast<float*>(qs[l]);
    a.g[l] = static_cast<float*>(gs[l]);
  }
  a.mins = mins;
  a.maxs = maxs;
  a.part = part;
  a.n_layers = L;
  a.obs_dim = obs_dim;
  a.act_dim = act_dim;
  a.M = M;
  const int aw = max_width(actor_dims, L), cw = max_width(critic_dims, L);
  a.maxw = aw > cw ? aw : cw;
  int floats = (obs_dim + act_dim) + 2 * a.maxw;
  for (int l = 1; l < L; ++l) floats += actor_dims[l];
  for (int l = 1; l <= L; ++l) floats += critic_dims[l];
  const size_t smem = (size_t)BM * floats * sizeof(float);
  UpdateArgs u = {};
  if (!fill_update(u, qs, gs, actor, actor_m, actor_v, actor_t, out_p, out_m, out_v, out_t,
                   actor_dims, L))
    return (int)cudaErrorInvalidValue;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(actor_chain_kernel, smem, actor_smem_granted);
  if (err != cudaSuccess) return (int)err;
  const Sites st = {deltas, zs, qat, fxp32_phase1, (float)((1 << n_bits) - 1)};
  const cudaStream_t s = (cudaStream_t)stream;
  actor_chain_kernel<<<(M + BM - 1) / BM, THREADS, smem, s>>>(a, st, hyper, phase);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_update_kernel<<<u.tile0[L], THREADS, 0, s>>>(u, hyper, fxp_weights, M);
  return (int)cudaGetLastError();
}

extern "C" const char* fxp_ddpg_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Kernels 4 and 5: one whole DDPG update — critic BP/WU, then actor BP/WU
// through the updated critic — on thread-block clusters, for sm_90a.
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
// runs three forwards (two limbs each in the monitor phase, one in the
// quant phase) and the critic's two backward products: ≈ 265 MFLOP of f32
// FMA in the monitor phase (≈ 4.0 µs at the 67 TFLOP/s non-tensor peak),
// ≈ 166 MFLOP in the quant phase (≈ 2.5 µs), against ≈ 4.7 MB of
// parameter, moment and target trees read and written (≈ 1.4 µs at
// 3.35 TB/s); kernel 5 ≈ 231 / 165 MFLOP and ≈ 4.6 MB.  So
// f32-compute-bound on paper, and latency-bound in practice: each row
// block walks a chain of a dozen dependent layer steps.
//
// Design — kernel B's weight-split clusters (csrc/fxp_mlp_fwd.cu), carried
// through the backward; the slice, TMA-load and column-MAC code is the one
// both include (csrc/fxp_slices.cuh):
//  * Passes.  The chain pass runs every row's forwards and cotangent chain
//    and stores what the products need: each trained layer's input q_l
//    (M, K_l) and post-activation cotangent G_l (M, N_l), plus one row of
//    monitors and loss partials per cluster.  Pass 2
//    (`reduce_update_kernel`) sums dW = qᵀG and db = ΣG over all rows in a
//    fixed order, 32 × 32 output tiles of every layer in one grid, and each
//    tile applies Adam and the Polyak update to the parameters it owns.
//    Kernel 5's chain is one launch (`ddpg_actor_kernel`: actor and critic
//    resident).  Kernel 4's three nets do not fit a block's shared memory at
//    8 blocks a cluster, so its chain is two launches: the target pass
//    (`ddpg_target_kernel`: target actor, target critic, y to a scratch row)
//    and the critic pass (`ddpg_critic_kernel`: the online critic forward,
//    loss, backward).  Kernel 4 is three CUDA launches, kernel 5 two.
//  * Clusters.  A cluster of C blocks runs the chain for one block of BM
//    rows (8 or 16); persistent clusters stride over the row blocks.  Every
//    width d is cut into C slices of sw(d) = ⌈⌈d/C⌉/4⌉·4 columns; block q
//    owns slice q of every layer's input and output.  A layer with N > 8
//    splits its columns (block q computes its N slice over all K, W[:, q]
//    resident), a narrower one (6, 1) splits K (block q sums its own input
//    slice for all N, W[q, :] resident; the partial sums are added over the
//    cluster in rank order, every block getting the whole output).
//  * Forward, per layer (kernel B's): a block monitors its own input slice,
//    projects it, splits it into limbs and stores them into every peer's
//    copy of the whole layer input through distributed shared memory
//    (DSMEM) before one cluster barrier; each output of a column-split
//    layer is one thread's fmaf chain in k order per limb, as in the kernel
//    this one replaces.  The weight slices load once per launch by TMA
//    (2-D tensor boxes) or bulk copies, completing on one mbarrier each.
//  * Backward, per layer, on the same slices.  A column-split layer holds
//    g for its own N slice: g·W[:, slice]ᵀ is a partial dx over all K
//    inputs; each block stores each partial's columns into their owner's
//    receive rows (DSMEM), one cluster barrier, and each owner adds the C
//    partials in rank order — a reduce-scatter without atomics, so two
//    calls are bitwise equal.  A K-split layer holds the whole g and its
//    own W rows: its dx slice is local.  Where the layer below is K-split
//    the dx goes to every block instead (all N ≤ 8 columns).  The
//    straight-through mask and the next activation backward then need only
//    the block's own slices.  Kernel 5's da is the action columns of the
//    critic's layer 0, reduced onto the actor's output slicing and masked
//    at the critic's first site.  Each block stores its slices of q_l and
//    G_l.  Rows with w = 0, and rows past the batch, carry an exactly zero
//    cotangent, so they add exactly zero to dW and db.
//  * The receive rows reuse the forward's limb buffers (double-buffered by
//    reduction parity); a cluster barrier separates the forward's last
//    reads from the backward's first writes, and each row block from the
//    next.
//  * The phase is a device int32 and the 12 step scalars (1/max(Σw, 1), γ,
//    τ, 1 − τ and Adam's constants with the bias corrections of this step,
//    the reference's hyper vector) a device float array, both read
//    in-kernel, so a captured CUDA graph replays with each step's values.
//  * The epilogue is `optim/fxp_adam.leaf_update` and (1 − τ)·t + τ·p bit
//    for bit: every product and sum is __fmul_rn/__fadd_rn, so nvcc cannot
//    contract it into an FMA that PyTorch's separate ops do not do; IEEE
//    division and square root; no fast-math.  The tanh backward is written
//    the same way.
//  * The critic's first layer reads its (obs, action) concat as one input;
//    the reference split that weight by rows for the TPU's lanes, which
//    changes its sum order at ulp level only.
// What limits it (measured on an H100 at B = 128, monitor phase): kernel 5
// ≈ 91 µs of chain and 13 µs of pass 2, kernel 4 ≈ 49 µs of target pass,
// 37 of critic pass and 13 of pass 2 — each row block a chain of a dozen
// dependent layer steps, each behind one or two cluster barriers; how a
// step splits between barrier, DSMEM stores and MACs is not measured.
// Launch plan: `repro_torch.kernels.fxp_mlp.kernel.step_plan(m, actor_dims,
// critic_dims, which)` computes BM, C, the cluster count, the instance
// (resident or streamed W) and the shared-memory layout; this file checks
// the layout's extents before it launches.

#include <cooperative_groups.h>
#include <cuda.h>

#include <mutex>

#include "fxp_bwd_slices.cuh"
#include "fxp_cluster.cuh"
#include "fxp_common.cuh"
#include "fxp_slices.cuh"

namespace cg = cooperative_groups;

namespace {

using fxp::act_bwd;
using fxp::activate;
using fxp::bf16_hi;
using fxp::bwd_dx;
using fxp::cluster_sync;
using fxp::col_mac;
using fxp::Ctx;
using fxp::load_slice_bulk;
using fxp::load_slice_plain;
using fxp::mbar_wait;
using fxp::peer;
using fxp::site_project;
using fxp::slice_width;
using fxp::smem_u32;
using fxp::ste_pass;
using fxp::tma_boxes;
using fxp::tma_rows;
using fxp::weight_map;

constexpr int MAX_LAYERS = 4;
constexpr int MAX_NETS = 2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;  // pass 2 tile: 32 (k) × 32 (n) outputs, 32-row steps
constexpr int STATIC_SMEM = 1024;  // bytes kept back for the chain kernels' static shared memory

enum Mode { TARGET = 0, CRITIC = 1, ACTOR = 2 };

// the hyper vector (src/repro/kernels/fxp_mlp/kernel.py:42-54)
constexpr int H_INVW = 0, H_GAMMA = 1, H_TAU = 2, H_OMTAU = 3, H_LR = 4, H_B1 = 5, H_OMB1 = 6,
              H_B2 = 7, H_OMB2 = 8, H_EPS = 9, H_BC1 = 10, H_BC2 = 11;

struct Net {
  const float* w[MAX_LAYERS];  // (dims[l], dims[l+1]) row-major
  const float* b[MAX_LAYERS];  // (dims[l+1],)
  int dims[MAX_LAYERS + 1];
  int acts[MAX_LAYERS];        // 0 none, 1 relu, 2 tanh
  int ksplit[MAX_LAYERS];      // 1: the layer sums K slices across the cluster
  int bulk[MAX_LAYERS];        // 1: its resident slice loads with bulk copies
  int w_off[MAX_LAYERS];       // float offsets of the resident W slices
  int x_off[MAX_LAYERS + 1];   // this block's slice of each layer's input; [L] of the last output
  int hf_off[MAX_LAYERS];      // a K-split layer's whole output (every block holds it)
  int site0;                   // the net's first site in deltas/zs
};

struct StepArgs {
  Net net[MAX_NETS];
  int n_nets, n_layers;
  int kmax, smax, pmax, rmax, gmax, nbuf;  // row strides (the plan's)
  int full_off, part_off, g_off[2];         // float offsets of the buffers
  const float* obs;       // (M, O)
  const float* action;    // (M, A)
  const float* reward;    // (M,)
  const float* done;      // (M,) 0/1
  const float* roww;      // (M,) row weights
  const float* next_obs;  // (M, O)
  float* y;               // (M,) the TD target: the target pass writes it, the critic pass reads it
  float* q[MAX_LAYERS];   // (M, K_l) the trained net's product inputs
  float* g[MAX_LAYERS];   // (M, N_l) its post-activation cotangents
  float* mins;            // (n_clusters, sites)
  float* maxs;
  float* part;            // (n_clusters, partials)
  int obs_dim, act_dim, M;
};

// The 2-D tensor maps of the column-split layers' W (bulk tensor copies).
struct alignas(64) WeightMaps {
  CUtensorMap m[MAX_NETS * MAX_LAYERS];
};

template <int BM, int TR, bool RESIDENT>
__device__ __forceinline__ void col_layer(const StepArgs& a, const Net& nt, int l, const float* fh, const float* fl,
                                          const float* wp, int w_stride, float* xout, int s_out, int nlo, int nq,
                                          int rows, bool quant) {
  const int K = nt.dims[l];
  const float* __restrict__ B = nt.b[l];
  const int act = nt.acts[l];
  for (int u = threadIdx.x; u < (BM / TR) * nq; u += THREADS) {
    const int c = u % nq, r0 = (u / nq) * TR;
    if (r0 >= rows) continue;  // every row of this group is past the batch
    float ah[TR], al[TR];
    col_mac<TR, RESIDENT>(fh + r0 * a.kmax, fl + r0 * a.kmax, a.kmax, K, wp, w_stride, c, quant, ah, al);
    const float bias = __ldg(B + nlo + c);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float acc = quant ? ah[i] : ah[i] + al[i];
      xout[(r0 + i) * s_out + c] = activate(acc + bias, act);
    }
  }
}

// Shared arrays every block keeps beside the dynamic layout.
struct Stat {
  float* red_min;  // [WARPS]
  float* red_max;
  float* run_min;  // [2 · MAX_LAYERS] running extrema per monitored site
  float* run_max;
  unsigned long long* bars;  // [MAX_NETS · MAX_LAYERS] one per resident slice
};

// One forward layer of net `ni` for the block's rows (module comment):
// xin is this block's slice of the layer input (pre-projection, stride
// sw(K)); the block's slice of the output goes to xout (stride sw(N)), a
// K-split layer's whole output also to its hf buffer (stride pmax).
// mon >= 0: fold the slice's extrema into run_min/max[mon].  q_out: store
// the product inputs of the valid rows.  `it` counts layers (the limb
// buffers' parity).
template <int BM, bool RESIDENT>
__device__ void fwd_layer(const StepArgs& a, const Ctx& x, const Stat& st, int ni, int l, const float* xin,
                          float* xout, int mon, float* q_out, int row0, int rows, int& it) {
  const Net& nt = a.net[ni];
  const int K = nt.dims[l], N = nt.dims[l + 1], C = x.C, q = x.q;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s_in = slice_width(K, C), klo = q * s_in, kn = max(0, min(s_in, K - klo));
  const int s_out = slice_width(N, C), nlo = q * s_out, nq = max(0, min(s_out, N - nlo));
  const bool ksplit = nt.ksplit[l];
  const int KM = a.kmax;
  float* fh = x.smem + a.full_off + (a.nbuf == 2 ? (it & 1) : 0) * 2 * BM * KM;
  float* fl = fh + BM * KM;
  const float inf = __int_as_float(0x7f800000);

  // ---- range monitor of this block's slice: valid rows only ---------------
  if (mon >= 0) {
    float mn = inf, mx = -inf;
    for (int e = tid; e < rows * kn; e += THREADS) {
      const float v = xin[(e / kn) * s_in + e % kn];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      st.red_min[warp] = mn;
      st.red_max[warp] = mx;
    }
  }

  // ---- site projection + limb split of the slice, four columns at a time,
  // stored into every block's copy of the whole input (a K-split layer keeps
  // its slice to itself).  Past kn the float4 runs into the padding up to
  // kmax, which no block owns and no MAC reads.
  const int site = nt.site0 + l;
  const float delta = x.qat ? x.deltas[site] : 1.0f;
  const float z = x.qat ? x.zs[site] : 0.0f;
  const int kn4 = (kn + 3) / 4;
  for (int e = tid; e < BM * kn4; e += THREADS) {
    const int r = e / kn4, c = (e % kn4) * 4;
    const float4 v4 = *reinterpret_cast<const float4*>(xin + r * s_in + c);
    float v[4] = {v4.x, v4.y, v4.z, v4.w}, h[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x.qat) v[j] = site_project(v[j], x.quant, delta, z, x.q_max, x.fxp32_phase1);
      h[j] = bf16_hi(v[j]);
      lo[j] = v[j] - h[j];
      if (q_out != nullptr && r < rows && c + j < kn) q_out[(size_t)(row0 + r) * K + klo + c + j] = x.quant ? h[j] : v[j];
    }
    const float4 h4 = make_float4(h[0], h[1], h[2], h[3]);
    const float4 l4 = make_float4(lo[0], lo[1], lo[2], lo[3]);
    const int o = r * KM + klo + c;
    if (!ksplit) {
      for (int p = 0; p < C; ++p) {
        *reinterpret_cast<float4*>(peer(fh, p) + o) = h4;
        if (!x.quant) *reinterpret_cast<float4*>(peer(fl, p) + o) = l4;
      }
      continue;
    }
    *reinterpret_cast<float4*>(fh + o) = h4;
    *reinterpret_cast<float4*>(fl + o) = l4;
  }
  if (RESIDENT && !nt.bulk[l]) asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's plain copies
  cluster_sync();  // every block's copy of this layer's input is complete (and its W slice)
  if (mon >= 0 && tid == 0) {
    for (int i = 0; i < WARPS; ++i) {
      st.run_min[mon] = fminf(st.run_min[mon], st.red_min[i]);
      st.run_max[mon] = fmaxf(st.run_max[mon], st.red_max[i]);
    }
  }
  const float* wl = RESIDENT ? x.smem + nt.w_off[l] : nt.w[l];
  if (RESIDENT && nt.bulk[l]) mbar_wait(&st.bars[ni * MAX_LAYERS + l], 0);
  const int act = nt.acts[l];

  if (!ksplit) {
    const float* wp = RESIDENT ? wl : wl + nlo;
    const int w_stride = RESIDENT ? s_out : N;
    int tr = BM;  // rows per thread: the fewest that keep one output column per thread
    while (tr > 1 && (BM / tr) * 2 * nq <= THREADS) tr /= 2;
    switch (tr) {
#define FXP_COL_LAYER(TR)                                                                                        \
  case TR:                                                                                                       \
    if constexpr (TR <= BM)                                                                                      \
      col_layer<BM, TR, RESIDENT>(a, nt, l, fh, fl, wp, w_stride, xout, s_out, nlo, nq, rows, x.quant);           \
    break;
      FXP_COL_LAYER(1)
      FXP_COL_LAYER(2)
      FXP_COL_LAYER(4)
      FXP_COL_LAYER(8)
      FXP_COL_LAYER(16)
#undef FXP_COL_LAYER
    }
  } else {
    // ---- K-split: partial sums of every output over this block's slice
    const int PM = a.pmax;
    float* part_hi = x.smem + a.part_off;
    float* part_lo = part_hi + BM * PM;
    for (int u = tid; u < BM * N; u += THREADS) {
      const int r = u / N, n = u % N;
      float ah = 0.0f, al = 0.0f;
      if (r < rows) {
        const float* hr = fh + r * KM + klo;
        const float* lr = fl + r * KM + klo;
        for (int k = 0; k < kn; ++k) {
          const float wv = RESIDENT ? wl[k * N + n] : __ldg(wl + (size_t)(klo + k) * N + n);
          ah = fmaf(hr[k], wv, ah);
          if (!x.quant) al = fmaf(lr[k], wv, al);
        }
      }
      part_hi[r * PM + n] = ah;
      part_lo[r * PM + n] = al;
    }
    cluster_sync();  // every block's partial sums are complete
    // every block adds all N outputs over the ranks in order: the same
    // whole output in each
    float* hf = x.smem + nt.hf_off[l];
    const float* __restrict__ B = nt.b[l];
    for (int u = tid; u < BM * N; u += THREADS) {
      const int r = u / N, n = u % N, o = r * PM + n;
      float v = 0.0f;
      if (r < rows) {
        float hv[16], lv[16];  // C ≤ 16: every load in flight before the ordered sum
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          if (p < C) {
            hv[p] = *peer(part_hi + o, p);
            lv[p] = *peer(part_lo + o, p);
          }
        }
        float hi = hv[0], lo = lv[0];
#pragma unroll
        for (int p = 1; p < 16; ++p) {
          if (p < C) {
            hi += hv[p];
            lo += lv[p];
          }
        }
        const float acc = x.quant ? hi : hi + lo;
        v = activate(acc + __ldg(B + n), act);
      }
      hf[o] = v;
    }
    __syncthreads();
    for (int e = tid; e < BM * nq; e += THREADS) {
      const int r = e / nq, c = e % nq;
      xout[r * s_out + c] = hf[r * PM + nlo + c];
    }
  }
  ++it;
  // xout holds the next layer's input slice; with one buffer no block may
  // fill the next layer's input before every peer is done with this one
  if (a.nbuf == 2) {
    __syncthreads();
  } else {
    cluster_sync();
  }
}

// Load this block's slice of the first layer's input, the concat of
// src1 (M, D1) and, past D1, src2 (M, K − D1) or the actor's output a
// (from `a_full`, stride pmax, or from its owners' output slices through
// DSMEM, `a_slice` at stride sa); rows past the batch are 0.
template <int BM>
__device__ void load_input(const Ctx& x, float* dst, int K, const float* __restrict__ src1, int D1,
                           const float* __restrict__ src2, const float* a_full, int pmax, const float* a_slice, int sa,
                           int row0, int rows) {
  const int s = slice_width(K, x.C), klo = x.q * s, kn = max(0, min(s, K - klo));
  for (int e = threadIdx.x; e < BM * kn; e += THREADS) {
    const int r = e / kn, c = klo + e % kn;
    float v = 0.0f;
    if (r < rows) {
      if (c < D1) {
        v = src1[(size_t)(row0 + r) * D1 + c];
      } else if (src2 != nullptr) {
        v = src2[(size_t)(row0 + r) * (K - D1) + c - D1];
      } else if (a_full != nullptr) {
        v = a_full[r * pmax + c - D1];
      } else {
        const int j = c - D1, p = j / sa;
        v = peer(a_slice, p)[r * sa + j - p * sa];
      }
    }
    dst[r * s + e % kn] = v;
  }
  __syncthreads();
}

// Column 0 of a net's last output for row r: the whole output of a K-split
// layer (every block), or block 0's output slice.
__device__ __forceinline__ float out0(const StepArgs& a, const Ctx& x, const Net& nt, int r) {
  const int L = a.n_layers;
  return nt.ksplit[L - 1] ? x.smem[nt.hf_off[L - 1] + r * a.pmax]
                          : x.smem[nt.x_off[L] + r * slice_width(nt.dims[L], x.C)];
}

// The chain pass of one mode for every row block the cluster walks.
template <int BM, bool RESIDENT, int MODE>
__device__ __forceinline__ void step_chain(const StepArgs& a, const WeightMaps& maps, const float* deltas,
                                           const float* zs, const float* __restrict__ hyper, const int* phase,
                                           int qat, int fxp32_phase1, float q_max) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float red_min[WARPS], red_max[WARPS];
  __shared__ float run_min[2 * MAX_LAYERS], run_max[2 * MAX_LAYERS];
  __shared__ float run_part[2];
  __shared__ float w_s[BM], d_s[BM];
  __shared__ __align__(8) unsigned long long bars[MAX_NETS * MAX_LAYERS];

  cg::cluster_group cluster = cg::this_cluster();
  Ctx x;
  x.smem = smem;
  x.deltas = deltas;
  x.zs = zs;
  x.q_max = q_max;
  x.C = (int)cluster.num_blocks();
  x.q = (int)cluster.block_rank();
  x.quant = __ldg(phase) > 0;
  x.qat = qat;
  x.fxp32_phase1 = fxp32_phase1;
  const Stat st = {red_min, red_max, run_min, run_max, bars};
  const int C = x.C, q = x.q;
  const int cid = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = a.n_layers, NN = a.n_nets;
  const float inf = __int_as_float(0x7f800000);

  if (RESIDENT) {
    if (tid == 0) {
      for (int i = 0; i < NN * MAX_LAYERS; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bars[i])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int ni = 0; ni < NN; ++ni)
      for (int l = 0; l < L; ++l) {
        const Net& nt = a.net[ni];
        if (!nt.bulk[l])
          load_slice_plain<THREADS>(nt, l, q, C, smem + nt.w_off[l]);
        else if (warp == 0)
          load_slice_bulk(nt, &maps.m[ni * MAX_LAYERS + l], l, q, C, smem + nt.w_off[l],
                          &bars[ni * MAX_LAYERS + l], lane);
      }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (tid < 2 * MAX_LAYERS) {
    run_min[tid] = inf;
    run_max[tid] = -inf;
  }
  if (tid < 2) run_part[tid] = 0.0f;

  const Net& n0 = a.net[0];
  const Net& n1 = a.net[MAX_NETS - 1];
  const Net& trained = n0;                      // CRITIC: the critic; ACTOR: the actor
  const Net& crit = MODE == CRITIC ? n0 : n1;   // the net whose output column 0 is q
  const int O = a.obs_dim, A = a.act_dim;
  const int n_rb = (a.M + BM - 1) / BM;
  int it = 0, rit = 0;
  for (int rb = cid; rb < n_rb; rb += n_clusters) {
    if (rb != cid) cluster_sync();  // every peer is done with this block's buffers
    const int row0 = rb * BM;
    const int rows = min(BM, a.M - row0);
    if (tid < BM) w_s[tid] = MODE != TARGET && tid < rows ? a.roww[row0 + tid] : 0.0f;

    // ---- forwards -------------------------------------------------------
    if (MODE == CRITIC) {
      load_input<BM>(x, smem + n0.x_off[0], n0.dims[0], a.obs, O, a.action, nullptr, a.pmax, nullptr, 1, row0, rows);
      for (int l = 0; l < L; ++l)
        fwd_layer<BM, RESIDENT>(a, x, st, 0, l, smem + n0.x_off[l], smem + n0.x_off[l + 1], l, a.q[l], row0, rows,
                                it);
    } else {
      // the actor (or target actor) on obs (next_obs), then the critic on
      // the concat of that input and the actor's output
      const float* src = MODE == TARGET ? a.next_obs : a.obs;
      load_input<BM>(x, smem + n0.x_off[0], n0.dims[0], src, O, nullptr, nullptr, a.pmax, nullptr, 1, row0, rows);
      for (int l = 0; l < L; ++l)
        fwd_layer<BM, RESIDENT>(a, x, st, 0, l, smem + n0.x_off[l], smem + n0.x_off[l + 1], MODE == ACTOR ? l : -1,
                                MODE == ACTOR ? a.q[l] : nullptr, row0, rows, it);
      const bool a_split = n0.ksplit[L - 1];
      if (!a_split) cluster_sync();  // every block's slice of the actor's output is complete
      load_input<BM>(x, smem + n1.x_off[0], n1.dims[0], src, O, nullptr, a_split ? smem + n0.hf_off[L - 1] : nullptr,
                     a.pmax, smem + n0.x_off[L], slice_width(A, C), row0, rows);
      for (int l = 0; l < L; ++l)
        fwd_layer<BM, RESIDENT>(a, x, st, 1, l, smem + n1.x_off[l], smem + n1.x_off[l + 1], MODE == ACTOR ? L + l : -1,
                                nullptr, row0, rows, it);
    }
    if (MODE == TARGET) {
      // ---- TD target, by the block that holds q_next's column 0
      if (q == 0 && tid < rows) {
        const float gamma = hyper[H_GAMMA];
        const float not_done = __fsub_rn(1.0f, a.done[row0 + tid]);
        a.y[row0 + tid] = __fadd_rn(a.reward[row0 + tid], __fmul_rn(__fmul_rn(gamma, not_done), out0(a, x, n1, tid)));
      }
      continue;
    }

    // ---- partials and the cotangent of q --------------------------------
    const int NL = crit.dims[L];
    const bool c_split = crit.ksplit[L - 1];
    const bool has0 = c_split || q == 0;  // this block holds q's column 0
    if (!c_split) cluster_sync();  // the forward's last limb reads are done before the receive rows fill
    if (MODE == CRITIC && has0 && tid < rows) d_s[tid] = __fsub_rn(out0(a, x, crit, tid), a.y[row0 + tid]);
    __syncthreads();
    if (q == 0 && tid == 0) {
      for (int r = 0; r < rows; ++r) {
        if (MODE == CRITIC) {
          run_part[0] = __fadd_rn(run_part[0], __fmul_rn(w_s[r], __fmul_rn(d_s[r], d_s[r])));
          run_part[1] = __fadd_rn(run_part[1], __fmul_rn(w_s[r], a.y[row0 + r]));
        } else {
          run_part[0] = __fadd_rn(run_part[0], __fmul_rn(w_s[r], out0(a, x, crit, r)));
        }
      }
    }
    float* gb = smem + a.g_off[0];
    float* gn = smem + a.g_off[1];
    {
      const float inv_w = hyper[H_INVW];
      const int width = c_split ? NL : slice_width(NL, C), stride = c_split ? a.pmax : width;
      for (int e = tid; e < BM * width; e += THREADS) {
        const int r = e / width, c = e % width;
        float v = 0.0f;
        if (r < rows && c == 0 && has0)
          v = MODE == CRITIC ? __fmul_rn(__fmul_rn(inv_w, w_s[r]), __fmul_rn(2.0f, d_s[r])) : __fmul_rn(-inv_w, w_s[r]);
        gb[r * stride + c] = v;
      }
      __syncthreads();
    }

    // ---- the critic's chain: G_l for pass 2 (kernel 4), dx below ----------
    const int cn = MODE == CRITIC ? 0 : 1;
    for (int l = L - 1; l >= 0; --l) {
      act_bwd<BM, THREADS>(a, x, crit, l, gb, crit.ksplit[l], MODE == CRITIC ? a.g[l] : nullptr, row0, rows);
      if (l > 0) {
        const bool below_full = crit.ksplit[l - 1];
        const float* x_in = smem + (below_full ? crit.hf_off[l - 1] : crit.x_off[l]);
        bwd_dx<BM, RESIDENT, THREADS>(a, x, cn, l, gb, 0, crit.dims[l], below_full, gn, x_in, rows, rit);
      } else if (MODE == ACTOR) {
        // da: the action columns of the critic's input, onto the actor's
        // output slicing (every block, where the actor's last layer splits K)
        const bool a_full = trained.ksplit[L - 1];
        const float* x_in = smem + (a_full ? trained.hf_off[L - 1] : trained.x_off[L]);
        bwd_dx<BM, RESIDENT, THREADS>(a, x, cn, 0, gb, O, A, a_full, gn, x_in, rows, rit);
      }
      float* t = gb;
      gb = gn;
      gn = t;
    }
    if (MODE == ACTOR) {
      // ---- the actor's chain: G_l for pass 2 -----------------------------
      for (int l = L - 1; l >= 0; --l) {
        act_bwd<BM, THREADS>(a, x, trained, l, gb, trained.ksplit[l], a.g[l], row0, rows);
        if (l > 0) {
          const bool below_full = trained.ksplit[l - 1];
          const float* x_in = smem + (below_full ? trained.hf_off[l - 1] : trained.x_off[l]);
          bwd_dx<BM, RESIDENT, THREADS>(a, x, 0, l, gb, 0, trained.dims[l], below_full, gn, x_in, rows, rit);
          float* t = gb;
          gb = gn;
          gn = t;
        }
      }
    }
  }

  cluster_sync();  // every block's running extrema are final
  const int n_mon = MODE == CRITIC ? L : MODE == ACTOR ? 2 * L : 0;
  if (q == 0 && tid < n_mon) {
    float mn = *peer(&run_min[tid], 0), mx = *peer(&run_max[tid], 0);
    for (int p = 1; p < C; ++p) {
      mn = fminf(mn, *peer(&run_min[tid], p));
      mx = fmaxf(mx, *peer(&run_max[tid], p));
    }
    a.mins[(size_t)cid * n_mon + tid] = mn;
    a.maxs[(size_t)cid * n_mon + tid] = mx;
  }
  const int n_part = MODE == CRITIC ? 2 : MODE == ACTOR ? 1 : 0;
  if (q == 0 && tid < n_part) a.part[(size_t)cid * n_part + tid] = run_part[tid];
  cluster_sync();  // peers may still read this block's shared memory
}

template <int BM, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
ddpg_target_kernel(const StepArgs a, const __grid_constant__ WeightMaps maps, const float* __restrict__ deltas,
                   const float* __restrict__ zs, const float* __restrict__ hyper, const int* __restrict__ phase,
                   int qat, int fxp32_phase1, float q_max) {
  step_chain<BM, RESIDENT, TARGET>(a, maps, deltas, zs, hyper, phase, qat, fxp32_phase1, q_max);
}

template <int BM, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
ddpg_critic_kernel(const StepArgs a, const __grid_constant__ WeightMaps maps, const float* __restrict__ deltas,
                   const float* __restrict__ zs, const float* __restrict__ hyper, const int* __restrict__ phase,
                   int qat, int fxp32_phase1, float q_max) {
  step_chain<BM, RESIDENT, CRITIC>(a, maps, deltas, zs, hyper, phase, qat, fxp32_phase1, q_max);
}

template <int BM, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
ddpg_actor_kernel(const StepArgs a, const __grid_constant__ WeightMaps maps, const float* __restrict__ deltas,
                  const float* __restrict__ zs, const float* __restrict__ hyper, const int* __restrict__ phase,
                  int qat, int fxp32_phase1, float q_max) {
  step_chain<BM, RESIDENT, ACTOR>(a, maps, deltas, zs, hyper, phase, qat, fxp32_phase1, q_max);
}

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

bool fill_net(Net& net, const void* const* wb, const int* dims, const int* acts, int L, int site0) {
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
  net.site0 = site0;
  return true;
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

// A plan as `kernel._c_step_plan` writes it: bm, cluster, n_clusters,
// resident, nbuf, kmax, smax, pmax, rmax, gmax, full_off, part_off, g_off[2],
// smem, n_nets, then per net (per layer ksplit, bulk, w_off; per layer and
// the last output x_off; per layer hf_off).
struct Launch {
  int bm, C, n_clusters, resident;
  size_t smem;
};

// Read a plan into `a` (whose nets are filled) and `maps`; check that every
// region of the layout lies inside the block's shared memory, apart from
// every other, 16-byte aligned (W slices 128-byte aligned), and wide enough
// for the shapes.  Returns 0 or a CUDA error code.
int read_plan(const int* plan, StepArgs& a, WeightMaps& maps, Launch& ln) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const int L = a.n_layers;
  ln.bm = plan[0];
  ln.C = plan[1];
  ln.n_clusters = plan[2];
  ln.resident = plan[3];
  a.nbuf = plan[4];
  a.kmax = plan[5];
  a.smax = plan[6];
  a.pmax = plan[7];
  a.rmax = plan[8];
  a.gmax = plan[9];
  a.full_off = plan[10];
  a.part_off = plan[11];
  a.g_off[0] = plan[12];
  a.g_off[1] = plan[13];
  const int smem = plan[14];
  const int C = ln.C, bm = ln.bm;
  if ((bm != 8 && bm != 16) || C < 1 || C > 16 || ln.n_clusters < 1 || plan[15] != a.n_nets ||
      (a.nbuf != 1 && a.nbuf != 2) || smem < 0 || smem > fxp::kMaxSmem - STATIC_SMEM)
    return (int)cudaErrorInvalidValue;
  ln.smem = (size_t)smem;
  const int strides[5] = {a.kmax, a.smax, a.pmax, a.rmax, a.gmax};
  for (int v : strides)
    if (v < 0 || v % 4 != 0) return (int)cudaErrorInvalidValue;
  if (a.rmax < a.smax || a.rmax < a.pmax || a.gmax < a.smax || a.gmax < a.pmax) return (int)cudaErrorInvalidValue;
  // regions: (offset, floats, alignment in floats)
  int off[64], len[64], n_reg = 0;
  auto region = [&](int o, int n, int align) {
    if (o < 0 || n < 0 || o % align != 0 || n_reg == 64) return false;
    off[n_reg] = o;
    len[n_reg++] = n;
    return true;
  };
  bool ok = region(a.full_off, a.nbuf * 2 * bm * a.kmax > 2 * C * bm * a.rmax ? a.nbuf * 2 * bm * a.kmax
                                                                                   : 2 * C * bm * a.rmax, 4) &&
            region(a.part_off, 2 * bm * a.pmax, 4) && region(a.g_off[0], bm * a.gmax, 4) &&
            region(a.g_off[1], bm * a.gmax, 4);
  const int* p = plan + 16;
  for (int ni = 0; ni < a.n_nets && ok; ++ni) {
    Net& nt = a.net[ni];
    for (int l = 0; l < L; ++l) {
      nt.ksplit[l] = p[l];
      nt.bulk[l] = p[L + l];
      nt.w_off[l] = p[2 * L + l];
      nt.hf_off[l] = p[4 * L + 1 + l];
    }
    for (int l = 0; l <= L; ++l) nt.x_off[l] = p[3 * L + l];
    p += 5 * L + 1;
    for (int l = 0; l <= L && ok; ++l) {
      const int d = nt.dims[l];
      if (slice_width(d, C) > a.smax || (l < L && (d + 3) / 4 * 4 > a.kmax)) ok = false;
      ok = ok && region(nt.x_off[l], bm * slice_width(d, C), 4);
    }
    for (int l = 0; l < L && ok; ++l) {
      const int K = nt.dims[l], N = nt.dims[l + 1];
      if (nt.ksplit[l] && (N > a.pmax || !region(nt.hf_off[l], bm * a.pmax, 4))) ok = false;
      if (!ok) break;
      if (ln.resident) {
        const int extent = nt.ksplit[l] ? slice_width(K, C) * N : tma_boxes(K) * tma_rows(K) * slice_width(N, C);
        ok = region(nt.w_off[l], extent, 32);
        if (nt.bulk[l] && (N % 4 != 0 || ((size_t)nt.w[l] & 15) != 0 || (!nt.ksplit[l] && slice_width(N, C) > 256)))
          ok = false;
        if (ok && nt.bulk[l] && !nt.ksplit[l]) {
          const int rc = weight_map(&maps.m[ni * MAX_LAYERS + l], nt.w[l], K, N, C);
          if (rc != 0) return rc;
        }
      } else if (nt.bulk[l]) {
        ok = false;
      }
    }
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_reg; ++i) {
    if (4 * (off[i] + len[i]) > smem) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < i; ++j)
      if (len[i] > 0 && len[j] > 0 && off[i] < off[j] + len[j] && off[j] < off[i] + len[i])
        return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The chain kernels by rows per block and resident W, launched as clusters.
template <int MODE>
int launch_chain(const StepArgs& a, const WeightMaps& maps, const Launch& ln, const float* deltas, const float* zs,
                 const float* hyper, const int* phase, int qat, int fxp32_phase1, float q_max, cudaStream_t s) {
  const dim3 grid(ln.n_clusters * ln.C), block(THREADS), cluster(ln.C, 1, 1);
#define FXP_STEP_LAUNCH(KERNEL, BM, RES)                                                                        \
  fxp::launch_cluster(KERNEL<BM, RES>, grid, block, ln.smem, cluster, s, a, maps, deltas, zs, hyper, phase, qat, \
                      fxp32_phase1, q_max)
#define FXP_STEP_PICK(KERNEL)                                                                               \
  (ln.bm == 16 ? (ln.resident ? FXP_STEP_LAUNCH(KERNEL, 16, true) : FXP_STEP_LAUNCH(KERNEL, 16, false)) \
               : (ln.resident ? FXP_STEP_LAUNCH(KERNEL, 8, true) : FXP_STEP_LAUNCH(KERNEL, 8, false)))
  if (MODE == TARGET) return FXP_STEP_PICK(ddpg_target_kernel);
  if (MODE == CRITIC) return FXP_STEP_PICK(ddpg_critic_kernel);
  return FXP_STEP_PICK(ddpg_actor_kernel);
#undef FXP_STEP_PICK
#undef FXP_STEP_LAUNCH
}

}  // namespace

// C interfaces, loaded with ctypes.  Trees are arrays of 2L pointers,
// interleaved (w0, b0, w1, b1, ...); the output trees may be the input
// trees (the update is elementwise per parameter).  dims/acts are L + 1
// and L ints.  deltas/zs (2L,) (actor sites, then critic sites) or null
// when qat == 0; hyper (12,) float32 and phase (1,) int32 on the device.
// qs[l] (M, K_l) and gs[l] (M, N_l) are scratch for the trained net.
// Every array float32, contiguous, on the current device.  Plans as
// `kernel.step_plan` computes them (`_c_step_plan`).  Each launches its
// passes on `stream` and returns 0 or a CUDA error code
// (cudaErrorInvalidValue for arguments the kernels do not take,
// fxp::kErrClusterUnschedulable for a cluster shape the card cannot run).

// Kernel 4: mins/maxs (n_clusters of plan_c, L), part (n_clusters, 2);
// y (M,) scratch for the TD target.
extern "C" int fxp_ddpg_step_critic_launch(
    const float* obs, const float* action, const float* reward, const float* done,
    const float* w, const float* next_obs, int M, int obs_dim, int act_dim,
    const void* const* actor_t, const void* const* critic, const void* const* critic_m,
    const void* const* critic_v, const void* const* critic_t, void* const* out_p,
    void* const* out_m, void* const* out_v, void* const* out_t, const int* actor_dims,
    const int* actor_acts, const int* critic_dims, const int* critic_acts, int n_layers,
    const float* deltas, const float* zs, const float* hyper, const int* phase, void* const* qs,
    void* const* gs, float* mins, float* maxs, float* part, float* y, const int* plan_t, const int* plan_c, int qat,
    int fxp32_phase1, int fxp_weights, int n_bits, void* stream) {
  const int L = n_layers;
  if (L < 1 || L > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24) return (int)cudaErrorInvalidValue;
  if ((qat && (!deltas || !zs)) || !hyper || !phase || !y) return (int)cudaErrorInvalidValue;
  if (actor_dims[0] != obs_dim || actor_dims[L] != act_dim || critic_dims[0] != obs_dim + act_dim)
    return (int)cudaErrorInvalidValue;
  StepArgs at = {}, ac = {};
  StepArgs* both[2] = {&at, &ac};
  for (StepArgs* s : both) {
    s->n_layers = L;
    s->obs = obs;
    s->action = action;
    s->reward = reward;
    s->done = done;
    s->roww = w;
    s->next_obs = next_obs;
    s->y = y;
    s->mins = mins;
    s->maxs = maxs;
    s->part = part;
    s->obs_dim = obs_dim;
    s->act_dim = act_dim;
    s->M = M;
  }
  at.n_nets = 2;
  ac.n_nets = 1;
  if (!fill_net(at.net[0], actor_t, actor_dims, actor_acts, L, 0) ||
      !fill_net(at.net[1], critic_t, critic_dims, critic_acts, L, L) ||
      !fill_net(ac.net[0], critic, critic_dims, critic_acts, L, L))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    ac.q[l] = static_cast<float*>(qs[l]);
    ac.g[l] = static_cast<float*>(gs[l]);
  }
  WeightMaps mt = {}, mc = {};
  Launch lt, lc;
  int rc = read_plan(plan_t, at, mt, lt);
  if (rc == 0) rc = read_plan(plan_c, ac, mc, lc);
  if (rc != 0) return rc;
  UpdateArgs u = {};
  if (!fill_update(u, qs, gs, critic, critic_m, critic_v, critic_t, out_p, out_m, out_v, out_t, critic_dims, L))
    return (int)cudaErrorInvalidValue;
  const float q_max = (float)((1 << n_bits) - 1);
  const cudaStream_t s = (cudaStream_t)stream;
  rc = launch_chain<TARGET>(at, mt, lt, deltas, zs, hyper, phase, qat, fxp32_phase1, q_max, s);
  if (rc == 0) rc = launch_chain<CRITIC>(ac, mc, lc, deltas, zs, hyper, phase, qat, fxp32_phase1, q_max, s);
  if (rc != 0) return rc;
  reduce_update_kernel<<<u.tile0[L], THREADS, 0, s>>>(u, hyper, fxp_weights, M);
  return (int)cudaGetLastError();
}

// Kernel 5: critic is the updated critic; mins/maxs (n_clusters, 2L),
// part (n_clusters, 1).
extern "C" int fxp_ddpg_step_actor_launch(
    const float* obs, const float* w, int M, int obs_dim, int act_dim, const void* const* actor,
    const void* const* actor_m, const void* const* actor_v, const void* const* actor_t,
    void* const* out_p, void* const* out_m, void* const* out_v, void* const* out_t,
    const void* const* critic, const int* actor_dims, const int* actor_acts,
    const int* critic_dims, const int* critic_acts, int n_layers, const float* deltas,
    const float* zs, const float* hyper, const int* phase, void* const* qs, void* const* gs,
    float* mins, float* maxs, float* part, const int* plan, int qat, int fxp32_phase1, int fxp_weights, int n_bits,
    void* stream) {
  const int L = n_layers;
  if (L < 1 || L > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24) return (int)cudaErrorInvalidValue;
  if ((qat && (!deltas || !zs)) || !hyper || !phase) return (int)cudaErrorInvalidValue;
  if (actor_dims[0] != obs_dim || actor_dims[L] != act_dim || critic_dims[0] != obs_dim + act_dim)
    return (int)cudaErrorInvalidValue;
  StepArgs a = {};
  a.n_nets = 2;
  a.n_layers = L;
  if (!fill_net(a.net[0], actor, actor_dims, actor_acts, L, 0) ||
      !fill_net(a.net[1], critic, critic_dims, critic_acts, L, L))
    return (int)cudaErrorInvalidValue;
  a.obs = obs;
  a.roww = w;
  for (int l = 0; l < L; ++l) {
    a.q[l] = static_cast<float*>(qs[l]);
    a.g[l] = static_cast<float*>(gs[l]);
  }
  a.mins = mins;
  a.maxs = maxs;
  a.part = part;
  a.obs_dim = obs_dim;
  a.act_dim = act_dim;
  a.M = M;
  WeightMaps maps = {};
  Launch ln;
  int rc = read_plan(plan, a, maps, ln);
  if (rc != 0) return rc;
  UpdateArgs u = {};
  if (!fill_update(u, qs, gs, actor, actor_m, actor_v, actor_t, out_p, out_m, out_v, out_t, actor_dims, L))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  rc = launch_chain<ACTOR>(a, maps, ln, deltas, zs, hyper, phase, qat, fxp32_phase1, (float)((1 << n_bits) - 1), s);
  if (rc != 0) return rc;
  reduce_update_kernel<<<u.tile0[L], THREADS, 0, s>>>(u, hyper, fxp_weights, M);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks with `smem` bytes of dynamic shared
// memory the card can hold at once (cudaOccupancyMaxActiveClusters) for the
// chain kernel of `mode` (0 target, 1 critic, 2 actor) with bm rows and
// resident weights or not; negative: a CUDA error code.  A diagnostic for
// the launch plan.
extern "C" int fxp_ddpg_step_max_clusters(int mode, int bm, int cluster, int smem, int resident) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto query = [&](auto kernel) -> int {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 fxp::kMaxSmem - (int)fa.sharedSizeBytes);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int n = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return -(int)err;
    }
    return n;
  };
#define FXP_STEP_QUERY(KERNEL)                                                                                  \
  (bm == 16 ? (resident ? query(KERNEL<16, true>) : query(KERNEL<16, false>))                                   \
            : (resident ? query(KERNEL<8, true>) : query(KERNEL<8, false>)))
  if (mode == TARGET) return FXP_STEP_QUERY(ddpg_target_kernel);
  if (mode == CRITIC) return FXP_STEP_QUERY(ddpg_critic_kernel);
  return FXP_STEP_QUERY(ddpg_actor_kernel);
#undef FXP_STEP_QUERY
}

extern "C" const char* fxp_ddpg_step_error_string(int code) { return fxp::error_string(code); }

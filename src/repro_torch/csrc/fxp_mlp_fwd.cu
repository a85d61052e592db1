// Kernel B: the whole L-layer MLP forward in one launch, QAT sites fused,
// for sm_90a.
//
// Replaces the TPU kernel `fxp_mlp_pallas` → `_mlp_kernel` in
// src/repro/kernels/fxp_mlp/kernel.py, with and without the training
// residuals.  Per layer l, on the layer's input x:
//   1. range monitor: min/max of x over the valid rows and the dims[l]
//      real columns;
//   2. site projection (when qat): quant phase (clip(rint(x/δ)+z, 0,
//      2ⁿ−1) − z)·δ, monitor phase rint(clip(x·2¹⁶))/2¹⁶ (or identity);
//   3. hi = bf16(x) (round to nearest even), acc = Σ hi·W; in the monitor
//      phase also Σ (x − hi)·W, added to it — the lo pass is a runtime
//      branch, as `pl.when` is in the reference, so one compiled kernel
//      serves both phases;
//   4. y = act(acc + b) becomes the next layer's input.
//   With save_residuals (training) it also stores what the backward
//   kernel (fxp_mlp_bwd.cu) reads: qs[l] (M, K_l), the input the products
//   consumed (hi in the quant phase, the projected x before it), and hs[l]
//   (M, N_l) for l < L−1, the layer output.  The mode is a template
//   instance (SAVE) that only adds stores: y is bitwise the same in both.
//   The phase can also be a device int32 read in-kernel (the DEV_PHASE
//   instances, for acting inside a captured CUDA graph).
//
// What bounds it on the H100: the paper's actor (17-400-300-6, 128,600
// MACs a row) at B = 512 in full precision is 2 limbs × 2·512·128,600 ≈
// 263 MFLOP of f32 FMA against ≈ 0.56 MB of operands: operations (the
// non-tensor f32 peak) at large B, bytes at B = 1 — and in practice the
// latency of one layer chain, since a bound of 0.2–4 µs is below a launch.
//
// Design — FIXAR's adaptive array on one card: a thread-block cluster of C
// blocks runs the layer chain for one block of BM rows (8, or 1 for a
// single row) — intra-layer parallelism — and the clusters split the rows
// — intra-batch parallelism.  The plan adapts C to the batch: 8 while the
// row blocks fit one wave of clusters of 8 (an H100 holds 15), else 4
// over up to 30 clusters.
//  * Slices.  Every width d is cut into C slices of sw(d) = ⌈⌈d/C⌉/4⌉·4
//    columns (the last ones shorter or empty); block q owns slice q of
//    every layer's input and output.  A layer is either column-split (its
//    N ≥ 9: block q computes its slice of the N outputs over the whole K)
//    or K-split (N ≤ 8, the narrow last layers 6 and 1: block q sums its
//    own K slice — its own slice of the input — for all N outputs, and the
//    partial sums are added over the cluster in rank order).
//  * Resident weights.  Each block holds its slice of every W in shared
//    memory, loaded once per launch with asynchronous copies that complete
//    on one mbarrier per layer and overlap the first row block's input and
//    earlier layers: a column-split slice (K × sw(N) columns of W) as
//    ⌈K/256⌉ 2-D tensor boxes (cp.async.bulk.tensor through a tensor map
//    encoded once per W), a K-split slice (contiguous rows) as one bulk
//    copy; a W whose width is not a multiple of 4 with 4-byte cp.async.
//    ≈ 69 KB a block for the actor at C = 8, ≈ 133 KB at C = 4 — the Hopper
//    form of the TPU kernel's VMEM-resident weights.  A net whose slices do
//    not fit runs the RESIDENT = false instance, with W read from L2 as
//    before (the plan picks it from the shape).
//  * Persistent clusters stride over the row blocks, so W leaves L2 once
//    per block per call.
//  * Per layer a block monitors its own input slice, projects it and
//    splits it into limbs, and stores the limbs (as float4) into every
//    block's copy of the whole layer input through distributed shared
//    memory; after one cluster barrier each block runs the MAC from its own
//    shared memory.  The copies are double-buffered by layer parity (one
//    copy, and a second barrier per layer, where two do not fit), so no
//    block overwrites an input a peer may still read; the K-split partial
//    sums are rewritten only after a later cluster barrier.
//  * Each output of a column-split layer is one thread's fmaf chain in k
//    order, per limb, as in the kernel this one replaces, so hidden layers
//    keep its rounding; a thread takes 1–8 rows of the block (the fewest
//    that keep every thread on one column) and reads the limbs four k at a
//    time.  Only the K-split layers sum in another order (slice by slice,
//    then over the ranks): within the 2e-5 contract.
//  * Extrema: each block folds its slices' min/max over its row blocks;
//    at the end rank 0 folds the cluster's blocks in rank order and writes
//    one row of mins/maxs (n_clusters, L), which the wrapper reduces — min
//    and max are order-free, so the result is exact.
//  * Every block of a cluster walks the same row blocks and meets every
//    cluster barrier, masked rows included; a final barrier keeps each
//    block alive until its peers have read its shared memory.  No atomics:
//    two calls are bitwise equal.
//  * CUDA-core f32 FMA: W is f32 and not bf16-exact, so neither a bf16 nor
//    a TF32 tensor-core MMA reproduces dot(hi, W).  rintf rounds half to
//    even like jnp.round; no fast-math, so x/δ is an IEEE divide and tanhf
//    the precise one.
// What limits it (measured on an H100): a row block's column-split MAC is
// bound by shared-memory wavefronts — each limb read is a warp-wide
// broadcast feeding one FMA per lane — and every layer pays a cluster
// barrier or two.
// Launch plan: `repro_torch.kernels.fxp_mlp.kernel.mlp_plan(m, dims)`
// computes BM, C, the cluster count, the instance and the shared-memory
// layout; this file checks the layout's extents before it launches.

#include <cooperative_groups.h>
#include <cuda.h>

#include <mutex>

#include "fxp_cluster.cuh"
#include "fxp_common.cuh"
#include "fxp_slices.cuh"

namespace cg = cooperative_groups;

namespace {

using fxp::activate;
using fxp::bf16_hi;
using fxp::col_mac;
using fxp::load_slice_bulk;
using fxp::load_slice_plain;
using fxp::mbar_wait;
using fxp::site_project;
using fxp::slice_width;
using fxp::smem_u32;
using fxp::tma_boxes;
using fxp::tma_rows;
using fxp::weight_map;

constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int STATIC_SMEM = 1024;  // bytes kept back for the kernel's static shared memory

struct MlpArgs {
  const float* w[MAX_LAYERS];  // (dims[l], dims[l+1]) row-major
  const float* b[MAX_LAYERS];  // (dims[l+1],)
  int dims[MAX_LAYERS + 1];
  int acts[MAX_LAYERS];  // 0 none, 1 relu, 2 tanh
  int ksplit[MAX_LAYERS];  // 1: the layer sums K slices across the cluster
  int bulk[MAX_LAYERS];    // 1: its resident slice loads with bulk async copies
  int w_off[MAX_LAYERS];   // float offsets of the resident W slices
  int n_layers;
  int kmax, smax, pmax;    // row strides: whole input, slices, K-split partials
  int nbuf;                // copies of the whole-input limb buffers (2: by layer parity)
  int full_off, act_off, part_off;  // float offsets of the buffers
};

// The 2-D tensor maps of the column-split layers' W (bulk tensor copies).
struct alignas(64) WeightMaps {
  CUtensorMap m[MAX_LAYERS];
};

struct ResArgs {         // the residual outputs, read by SAVE instances only
  float* q[MAX_LAYERS];  // (M, dims[l])
  float* h[MAX_LAYERS];  // (M, dims[l+1]) for l < n_layers-1
};

// Where a layer output goes: the next layer's input slice (and hs), or y.
template <bool SAVE>
__device__ __forceinline__ void put(const MlpArgs& a, const ResArgs& res, float* act_s, float* y, int l, int r,
                                   int c, int nlo, int row0, int rows, float v) {
  const int N = a.dims[l + 1];
  if (l < a.n_layers - 1) {
    act_s[r * a.smax + c] = v;
    if (SAVE && r < rows) res.h[l][(size_t)(row0 + r) * N + nlo + c] = v;
  } else if (r < rows) {
    y[(size_t)(row0 + r) * N + nlo + c] = v;
  }
}

template <int BM, int TR, bool SAVE, bool RESIDENT>
__device__ __forceinline__ void col_layer(const MlpArgs& a, const ResArgs& res, const float* full_hi,
                                          const float* full_lo, const float* wp, int w_stride, float* act_s,
                                          float* y, int l, int nlo, int nq, int row0, int rows, bool quant) {
  const int K = a.dims[l];
  const float* __restrict__ B = a.b[l];
  const int act = a.acts[l];
  for (int u = threadIdx.x; u < (BM / TR) * nq; u += THREADS) {
    const int c = u % nq, r0 = (u / nq) * TR;
    if (r0 >= rows) continue;  // every row of this group is masked
    float ah[TR], al[TR];
    col_mac<TR, RESIDENT>(full_hi + r0 * a.kmax, full_lo + r0 * a.kmax, a.kmax, K, wp, w_stride, c, quant, ah, al);
    const float bias = __ldg(B + nlo + c);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float acc = quant ? ah[i] : ah[i] + al[i];
      put<SAVE>(a, res, act_s, y, l, r0 + i, c, nlo, row0, rows, activate(acc + bias, act));
    }
  }
}

template <int BM, bool SAVE, bool DEV_PHASE, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
fxp_mlp_fwd_kernel(const float* __restrict__ x, const MlpArgs args, const __grid_constant__ WeightMaps maps,
                   const ResArgs res, const float* __restrict__ deltas, const float* __restrict__ zs, float* __restrict__ y,
                   float* __restrict__ mins, float* __restrict__ maxs, int M, int quant, int qat,
                   int fxp32_phase1, float q_max, const int* __restrict__ phase) {
  if (DEV_PHASE) quant = __ldg(phase) > 0;
  extern __shared__ __align__(128) float smem[];
  __shared__ float red_min[THREADS / 32], red_max[THREADS / 32];
  __shared__ float run_min[MAX_LAYERS], run_max[MAX_LAYERS];
  __shared__ __align__(8) unsigned long long bars[MAX_LAYERS];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int L = args.n_layers;
  const int S = args.smax, KM = args.kmax;
  const float inf = __int_as_float(0x7f800000);
  float* full = smem + args.full_off;    // [nbuf][2 limbs][BM][kmax] the whole input of a layer
  float* act_s = smem + args.act_off;    // [BM][smax] this block's slice of the current site input
  float* part_hi = smem + args.part_off;  // [BM][pmax] K-split partial sums
  float* part_lo = part_hi + BM * args.pmax;

  if (RESIDENT) {
    if (tid == 0) {
      for (int l = 0; l < L; ++l)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bars[l])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      if (!args.bulk[l])
        load_slice_plain<THREADS>(args, l, q, C, smem + args.w_off[l]);
      else if (warp == 0)
        load_slice_bulk(args, &maps.m[l], l, q, C, smem + args.w_off[l], &bars[l], lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (tid < L) {
    run_min[tid] = inf;
    run_max[tid] = -inf;
  }

  const int n_rb = (M + BM - 1) / BM;
  int it = 0;  // layers walked: with two buffers the parity picks the one a layer fills
  for (int rb = cid; rb < n_rb; rb += n_clusters) {
    const int row0 = rb * BM;
    const int rows = min(BM, M - row0);
    {
      const int K0 = args.dims[0], s = slice_width(K0, C), klo = q * s, kn = max(0, min(s, K0 - klo));
      for (int e = tid; e < BM * kn; e += THREADS) {
        const int r = e / kn, c = e % kn;
        act_s[r * S + c] = r < rows ? x[(size_t)(row0 + r) * K0 + klo + c] : 0.0f;
      }
    }
    __syncthreads();

    for (int l = 0; l < L; ++l, ++it) {
      const int K = args.dims[l], N = args.dims[l + 1];
      const int s_in = slice_width(K, C), klo = q * s_in, kn = max(0, min(s_in, K - klo));
      const int s_out = slice_width(N, C), nlo = q * s_out, nq = max(0, min(s_out, N - nlo));
      const bool ksplit = args.ksplit[l];
      float* fh = full + (args.nbuf == 2 ? (it & 1) : 0) * 2 * BM * KM;
      float* fl = fh + BM * KM;

      // ---- range monitor of this block's slice: valid rows only -------
      float mn = inf, mx = -inf;
      for (int e = tid; e < rows * kn; e += THREADS) {
        const float v = act_s[(e / kn) * S + e % kn];
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

      // ---- site projection + limb split of the slice, four columns at a
      // time, stored into every block's copy of the whole input (a K-split
      // layer keeps its slice to itself).  Past kn the float4 runs into the
      // padding up to kmax, which no block owns and no MAC reads.
      const float delta = qat ? deltas[l] : 1.0f;
      const float z = qat ? zs[l] : 0.0f;
      const int kn4 = (kn + 3) / 4;
      for (int e = tid; e < BM * kn4; e += THREADS) {
        const int r = e / kn4, c = (e % kn4) * 4;
        const float4 v4 = *reinterpret_cast<const float4*>(act_s + r * S + c);
        float v[4] = {v4.x, v4.y, v4.z, v4.w}, h[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (qat) v[j] = site_project(v[j], quant, delta, z, q_max, fxp32_phase1);
          h[j] = bf16_hi(v[j]);
          lo[j] = v[j] - h[j];
          if (SAVE && r < rows && c + j < kn) res.q[l][(size_t)(row0 + r) * K + klo + c + j] = quant ? h[j] : v[j];
        }
        const float4 h4 = make_float4(h[0], h[1], h[2], h[3]);
        const float4 l4 = make_float4(lo[0], lo[1], lo[2], lo[3]);
        const int o = r * KM + klo + c;
        if (!ksplit) {
          for (int p = 0; p < C; ++p) {
            *reinterpret_cast<float4*>(cluster.map_shared_rank(fh, p) + o) = h4;
            if (!quant) *reinterpret_cast<float4*>(cluster.map_shared_rank(fl, p) + o) = l4;
          }
          continue;
        }
        *reinterpret_cast<float4*>(fh + o) = h4;
        *reinterpret_cast<float4*>(fl + o) = l4;
      }
      if (RESIDENT && !args.bulk[l]) asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's plain copies
      cluster.sync();  // every block's copy of this layer's input is complete (and its W slice)
      if (tid == 0) {
        for (int i = 0; i < THREADS / 32; ++i) {
          run_min[l] = fminf(run_min[l], red_min[i]);
          run_max[l] = fmaxf(run_max[l], red_max[i]);
        }
      }
      const float* wl = RESIDENT ? smem + args.w_off[l] : args.w[l];
      if (RESIDENT && args.bulk[l]) mbar_wait(&bars[l], 0);
      const int act = args.acts[l];

      if (!ksplit) {
        const float* wp = RESIDENT ? wl : wl + nlo;
        const int w_stride = RESIDENT ? s_out : N;
        int tr = BM;  // rows per thread: the fewest that keep one output column per thread
        while (tr > 1 && (BM / tr) * 2 * nq <= THREADS) tr /= 2;
        switch (tr) {
#define FXP_COL_LAYER(TR)                                                                                     \
  case TR:                                                                                                    \
    if constexpr (TR <= BM)                                                                                   \
      col_layer<BM, TR, SAVE, RESIDENT>(args, res, fh, fl, wp, w_stride, act_s, y, l, nlo, nq, row0, rows, quant); \
    break;
          FXP_COL_LAYER(1)
          FXP_COL_LAYER(2)
          FXP_COL_LAYER(4)
          FXP_COL_LAYER(8)
#undef FXP_COL_LAYER
        }
      } else {
        // ---- K-split: partial sums of every output over this block's slice
        for (int u = tid; u < BM * N; u += THREADS) {
          const int r = u / N, n = u % N;
          float ah = 0.0f, al = 0.0f;
          if (r < rows) {
            const float* hr = fh + r * KM + klo;
            const float* lr = fl + r * KM + klo;
            for (int k = 0; k < kn; ++k) {
              const float wv = RESIDENT ? wl[k * N + n] : __ldg(wl + (size_t)(klo + k) * N + n);
              ah = fmaf(hr[k], wv, ah);
              if (!quant) al = fmaf(lr[k], wv, al);
            }
          }
          part_hi[r * args.pmax + n] = ah;
          part_lo[r * args.pmax + n] = al;
        }
        cluster.sync();  // every block's partial sums are complete
        const float* __restrict__ B = args.b[l];
        for (int u = tid; u < rows * nq; u += THREADS) {
          const int r = u / nq, c = u % nq, o = r * args.pmax + nlo + c;
          float hv[16], lv[16];  // C ≤ 16: every load in flight before the ordered sum
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            if (p < C) {
              hv[p] = *cluster.map_shared_rank(part_hi + o, p);
              lv[p] = *cluster.map_shared_rank(part_lo + o, p);
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
          const float acc = quant ? hi : hi + lo;
          put<SAVE>(args, res, act_s, y, l, r, c, nlo, row0, rows, activate(acc + __ldg(B + nlo + c), act));
        }
      }
      // act_s holds the next layer's input slice; with one buffer no block
      // may fill the next layer's input before every peer is done with this one
      if (args.nbuf == 2) {
        __syncthreads();
      } else {
        cluster.sync();
      }
    }
  }

  cluster.sync();  // every block's running extrema are final
  if (q == 0 && tid < L) {
    float mn = *cluster.map_shared_rank(&run_min[tid], 0), mx = *cluster.map_shared_rank(&run_max[tid], 0);
    for (int p = 1; p < C; ++p) {
      mn = fminf(mn, *cluster.map_shared_rank(&run_min[tid], p));
      mx = fmaxf(mx, *cluster.map_shared_rank(&run_max[tid], p));
    }
    mins[(size_t)cid * L + tid] = mn;
    maxs[(size_t)cid * L + tid] = mx;
  }
  cluster.sync();  // peers may still read this block's shared memory
}

template <int BM, bool SAVE, bool DEV_PHASE, bool RESIDENT>
int launch(const float* x, const MlpArgs& args, const WeightMaps& maps, const ResArgs& res, const float* deltas,
           const float* zs, float* y, float* mins, float* maxs, int M, int quant, int qat, int fxp32_phase1,
           float q_max, const int* phase, int cluster, int n_clusters, size_t smem, cudaStream_t stream) {
  return fxp::launch_cluster(fxp_mlp_fwd_kernel<BM, SAVE, DEV_PHASE, RESIDENT>, dim3(n_clusters * cluster),
                             dim3(THREADS), smem, dim3(cluster, 1, 1), stream, x, args, maps, res, deltas, zs, y,
                             mins, maxs, M, quant, qat, fxp32_phase1, q_max, phase);
}

}  // namespace

// C interface, loaded with ctypes.  x (M, dims[0]); weights[l] (dims[l],
// dims[l+1]); biases[l] (dims[l+1],); deltas/zs (n_layers,) or null when
// qat == 0; y (M, dims[n_layers]); mins/maxs (n_clusters, n_layers); with
// save_residuals, qs[l] (M, dims[l]) for every layer and hs[l]
// (M, dims[l+1]) for l < n_layers-1 (both arrays null otherwise); phase,
// when not null, a device int32 read in-kernel in place of `quant` (> 0:
// the quant phase), so a captured graph sees the phase of each replay —
// not with save_residuals.  All float32, contiguous, on the current device.
// plan: the launch plan of `mlp_plan` as ints — bm (8 or 1), cluster (C),
// n_clusters, resident, kmax, smax, pmax, nbuf, full_off, act_off,
// part_off, smem (bytes), then per layer ksplit, bulk and w_off.  Launches
// on `stream` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take, or fxp::kErrClusterUnschedulable).
extern "C" int fxp_mlp_fwd_launch(const float* x, const void* const* weights, const void* const* biases,
                                  const int* dims, const int* acts, int n_layers, const float* deltas,
                                  const float* zs, float* y, float* mins, float* maxs, int M, const int* plan,
                                  int quant, int qat, int fxp32_phase1, int n_bits, int save_residuals,
                                  void* const* qs, void* const* hs, const int* phase, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24)
    return (int)cudaErrorInvalidValue;
  if (qat && (deltas == nullptr || zs == nullptr)) return (int)cudaErrorInvalidValue;
  if (save_residuals && (qs == nullptr || (n_layers > 1 && hs == nullptr))) return (int)cudaErrorInvalidValue;
  if (save_residuals && phase != nullptr) return (int)cudaErrorInvalidValue;
  const int bm = plan[0], C = plan[1], n_clusters = plan[2], resident = plan[3];
  MlpArgs args = {};
  WeightMaps maps = {};
  ResArgs res = {};
  args.n_layers = n_layers;
  args.kmax = plan[4];
  args.smax = plan[5];
  args.pmax = plan[6];
  args.nbuf = plan[7];
  args.full_off = plan[8];
  args.act_off = plan[9];
  args.part_off = plan[10];
  const int smem = plan[11];
  if ((bm != 1 && bm != 8) || C < 1 || C > 16 || n_clusters < 1 || (args.nbuf != 1 && args.nbuf != 2) ||
      args.kmax % 4 != 0 || args.smax % 4 != 0 || smem < 0 || smem > fxp::kMaxSmem - STATIC_SMEM)
    return (int)cudaErrorInvalidValue;
  auto sw = [C](int d) { return ((d + C - 1) / C + 3) / 4 * 4; };
  int w_end = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    args.dims[l] = dims[l];
    if (sw(dims[l]) > args.smax) return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < n_layers; ++l) {
    const int K = dims[l], N = dims[l + 1];
    if (acts[l] < 0 || acts[l] > 2) return (int)cudaErrorInvalidValue;
    args.w[l] = static_cast<const float*>(weights[l]);
    args.b[l] = static_cast<const float*>(biases[l]);
    args.acts[l] = acts[l];
    args.ksplit[l] = plan[12 + l];
    args.bulk[l] = plan[12 + n_layers + l];
    args.w_off[l] = plan[12 + 2 * n_layers + l];
    if ((args.ksplit[l] && N > args.pmax) || (K + 3) / 4 * 4 > args.kmax) return (int)cudaErrorInvalidValue;
    if (resident) {  // the slices lie in order before the buffers, 16-byte aligned
      const int extent = args.ksplit[l] ? sw(K) * N : tma_boxes(K) * tma_rows(K) * sw(N);
      if (args.w_off[l] < w_end || args.w_off[l] % 32 != 0) return (int)cudaErrorInvalidValue;
      w_end = args.w_off[l] + extent;
      if (args.bulk[l] && (N % 4 != 0 || ((size_t)weights[l] & 15) != 0 || (!args.ksplit[l] && sw(N) > 256)))
        return (int)cudaErrorInvalidValue;
      if (args.bulk[l] && !args.ksplit[l]) {
        const int rc = weight_map(&maps.m[l], args.w[l], K, N, C);
        if (rc != 0) return rc;
      }
    } else if (args.bulk[l]) {
      return (int)cudaErrorInvalidValue;
    }
    if (save_residuals) {
      res.q[l] = static_cast<float*>(qs[l]);
      res.h[l] = l < n_layers - 1 ? static_cast<float*>(hs[l]) : nullptr;
      if (res.q[l] == nullptr || (l < n_layers - 1 && res.h[l] == nullptr)) return (int)cudaErrorInvalidValue;
    }
  }
  if (args.full_off < w_end || args.full_off % 4 != 0 || args.act_off % 4 != 0 ||
      args.act_off < args.full_off + 2 * args.nbuf * bm * args.kmax || args.part_off < args.act_off + bm * args.smax ||
      smem < 4 * (args.part_off + 2 * bm * args.pmax))
    return (int)cudaErrorInvalidValue;
  const float q_max = (float)((1 << n_bits) - 1);
  const cudaStream_t s = (cudaStream_t)stream;
#define FXP_MLP_FWD_LAUNCH(BM, SAVE, DEV_PHASE, RESIDENT)                                                      \
  launch<BM, SAVE, DEV_PHASE, RESIDENT>(x, args, maps, res, deltas, zs, y, mins, maxs, M, quant, qat, fxp32_phase1, \
                                        q_max, phase, C, n_clusters, (size_t)smem, s)
#define FXP_MLP_FWD_MODE(BM, RESIDENT)                                       \
  (save_residuals ? FXP_MLP_FWD_LAUNCH(BM, true, false, RESIDENT)            \
                  : phase != nullptr ? FXP_MLP_FWD_LAUNCH(BM, false, true, RESIDENT) \
                                     : FXP_MLP_FWD_LAUNCH(BM, false, false, RESIDENT))
  if (bm == 8) return resident ? FXP_MLP_FWD_MODE(8, true) : FXP_MLP_FWD_MODE(8, false);
  return resident ? FXP_MLP_FWD_MODE(1, true) : FXP_MLP_FWD_MODE(1, false);
#undef FXP_MLP_FWD_MODE
#undef FXP_MLP_FWD_LAUNCH
}

// How many clusters of `cluster` blocks with `smem` bytes of dynamic shared
// memory the card can hold at once (cudaOccupancyMaxActiveClusters), for
// the serving instance of kernel B with bm rows and resident weights or
// not; negative: a CUDA error code.  A diagnostic for the launch plan.
extern "C" int fxp_mlp_fwd_max_clusters(int bm, int cluster, int smem, int resident) {
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
  if (bm == 8) return resident ? query(fxp_mlp_fwd_kernel<8, false, false, true>)
                               : query(fxp_mlp_fwd_kernel<8, false, false, false>);
  return resident ? query(fxp_mlp_fwd_kernel<1, false, false, true>) : query(fxp_mlp_fwd_kernel<1, false, false, false>);
}

extern "C" const char* fxp_mlp_fwd_error_string(int code) { return fxp::error_string(code); }

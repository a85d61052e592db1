// Kernel 3: the whole L-layer MLP backward, QAT sites' straight-through
// masks included, for sm_90a.
//
// Replaces the TPU kernel `fxp_mlp_bwd_pallas` → `_mlp_bwd_kernel` in
// src/repro/kernels/fxp_mlp/kernel.py (:299 → :223).  From the cotangent g
// of y and the forward's residuals (qs[l], the input layer l's products
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
// So it is f32-compute-bound on paper, and latency-bound in practice: each
// row block walks L dependent layer steps.
//
// Design — two launches on the caller's stream, both deterministic (CUDA
// blocks are unordered and atomics would make the sums' order, and so two
// training runs from one seed, differ; the TPU grid summed dW/db across row
// blocks in order):
//  * Pass 1 (`bwd_chain_kernel`), the chain, on kernels 4 + 5's
//    weight-split clusters and their backward code (csrc/fxp_bwd_slices.cuh):
//    a cluster of C blocks runs the chain for one block of BM rows (8 or
//    16; 4 in the streamed instance), persistent clusters striding over the
//    row blocks.  Every width d is cut into C slices of sw(d) =
//    ⌈⌈d/C⌉/4⌉·4 columns; block q owns slice q of every layer's input and
//    output.  Block q keeps its slice of every W resident in shared memory,
//    loaded once per launch by TMA (2-D tensor boxes or bulk copies,
//    `fxp_slices.cuh`): W[:, slice q] for a layer with N > 8 (column-split),
//    W[slice q, :] for a narrower one (K-split).  A row block loads its
//    slices of the residuals from global memory (kernel B wrote them): g of
//    y, each layer's output hs[l] (the whole output of a K-split layer,
//    which every block holds), and x0.  Per layer, last to first:
//    `act_bwd` on the block's slice of the cotangent (its columns of G_l
//    go to global memory for pass 2), then `bwd_dx` — a column-split
//    layer's partial dx over all K from its N slice, stored into the
//    owners' receive rows through distributed shared memory, one cluster
//    barrier, the owners adding the C partials in rank order (no atomics);
//    a K-split layer's dx slice local — and the site's mask on the block's
//    input slice.  After layer 0 the block stores its dx slice.  Rows past
//    the batch carry exact zeros.  Where the slices do not fit a block's
//    shared memory, the RESIDENT = false instance reads W from L2 (the
//    plan picks it).
//  * Pass 2 (`bwd_dw_kernel`): dW_l = q_lᵀ G_l, tiled 32 × 32 over
//    (K_l, N_l) for every layer in one grid, each tile summing all M rows
//    in a fixed order through 32-row shared-memory tiles of q and G; the
//    tiles at k = 0 also sum db_l.
//  * Plain CUDA-core f32 FMA: q and g are not bf16-exact, so no bf16 or
//    TF32 MMA reproduces the f32 products.  The tanh backward is
//    __fmul_rn / __fsub_rn, so nvcc contracts nothing into an FMA that the
//    plain version's separate ops do not do.  No fast-math.
// What limits it (measured on an H100 at B = 128, monitor phase, 8-row
// blocks on 16 clusters of 4; tools/bwd_phases.py, PERF.md §6): the chain
// pass takes ≈ 20 µs, pass 2 ≈ 9.6.  Of the chain, layer 1's (400 → 300)
// partial dx ≈ 7.5 µs (from the code: neighbouring lanes read float4s of
// W rows 4 apart at a stride of sw(N) = 76 floats, so a quarter warp's
// loads fall on two bank groups, a four-way conflict), layer 0's ≈ 4 µs
// (only 2·⌈K0/4⌉ threads busy, K0 = 17 or 23), the residual loads ≈ 2 µs
// and the weights' TMA requests ≈ 1.4 µs; the activation backwards and the narrow
// last layer ≈ 2–3 µs together.
// Launch plan: `repro_torch.kernels.fxp_mlp.kernel.bwd_plan(m, dims)`
// computes BM, C, the cluster count, the instance (resident or streamed W)
// and the shared-memory layout; this file checks the layout's extents
// before it launches.

#include <cooperative_groups.h>
#include <cuda.h>

#include "fxp_bwd_slices.cuh"
#include "fxp_cluster.cuh"
#include "fxp_common.cuh"
#include "fxp_slices.cuh"

namespace cg = cooperative_groups;

namespace {

using fxp::act_bwd;
using fxp::bwd_dx;
using fxp::cluster_sync;
using fxp::cp_async4;
using fxp::Ctx;
using fxp::load_slice_bulk;
using fxp::load_slice_plain;
using fxp::mbar_wait;
using fxp::slice_width;
using fxp::smem_u32;
using fxp::tma_boxes;
using fxp::tma_rows;
using fxp::weight_map;

constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int TILE = 32;           // pass 2 tile: 32 (k) × 32 (n) outputs, 32-row steps
constexpr int STATIC_SMEM = 1024;  // bytes kept back for the chain kernel's static shared memory

// The net's layers as the shared backward reads them.
struct Net {
  const float* w[MAX_LAYERS];  // (dims[l], dims[l+1]) row-major
  int dims[MAX_LAYERS + 1];
  int acts[MAX_LAYERS];        // 0 none, 1 relu, 2 tanh
  int ksplit[MAX_LAYERS];      // 1: the layer sums K slices across the cluster
  int bulk[MAX_LAYERS];        // 1: its resident slice loads with bulk copies
  int w_off[MAX_LAYERS];       // float offsets of the resident W slices
  int x_off[MAX_LAYERS + 1];   // this block's slice of each layer's input; [L] of the last output
  int hf_off[MAX_LAYERS];      // a K-split layer's whole output (every block holds it)
  int site0;
};

struct ChainArgs {
  Net net[1];
  int n_layers;
  int smax, pmax, rmax, gmax;  // row strides (the plan's)
  int full_off, g_off[2];      // float offsets: the receive rows, two cotangent buffers
  const float* gy;             // (M, dims[L]) the cotangent of y
  const float* x0;             // (M, dims[0])
  const float* h[MAX_LAYERS];  // (M, dims[l+1]) layer outputs; h[L-1] = y
  float* g[MAX_LAYERS];        // (M, dims[l+1]) scratch: the cotangent after step 1, for pass 2
  float* dx;                   // (M, dims[0])
  int M;
};

// The 2-D tensor maps of the column-split layers' W (bulk tensor copies).
struct alignas(64) WeightMaps {
  CUtensorMap m[MAX_LAYERS];
};

// Rows [row0, row0 + BM) of src (M, width) into dst: all `width` columns at
// stride `stride` (`full`), or the block's slice of them at stride sw(width);
// rows past `rows` are 0.  Asynchronous 4-byte copies, so every load of a
// row block is in flight at once; the caller waits (cp.async.wait_all).
template <int BM>
__device__ __forceinline__ void load_rows(const Ctx& x, float* dst, const float* __restrict__ src, int width,
                                          bool full, int stride, int row0, int rows) {
  const int s = slice_width(width, x.C), lo = full ? 0 : x.q * s;
  const int n = full ? width : max(0, min(s, width - lo));
  const int st = full ? stride : s;
  for (int e = threadIdx.x; e < BM * n; e += THREADS) {
    const int r = e / n, c = e % n;
    cp_async4(dst + r * st + c, r < rows ? src + (size_t)(row0 + r) * width + lo + c : src, r < rows);
  }
}

#ifdef FXP_BWD_TRACE
// Phase stamps of the chain pass, for tools/bwd_phases.py (a build with
// -DFXP_BWD_TRACE; the kernels' own build compiles them out): thread 0 of
// each block writes clock64() at slot i < 30 of its row of the buffer, and
// %globaltimer at entry (30) and exit (31).
constexpr int TRACE_SLOTS = 32;
__device__ unsigned long long* g_trace = nullptr;
__device__ __forceinline__ void stamp(int i, bool timer = false) {
  if (threadIdx.x != 0 || g_trace == nullptr) return;
  unsigned long long* row = g_trace + (size_t)blockIdx.x * TRACE_SLOTS;
  row[i] = clock64();
  if (timer) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    row[i == 0 ? 30 : 31] = t;
  }
}
#define FXP_STAMP(...) stamp(__VA_ARGS__)
#else
#define FXP_STAMP(...) ((void)0)
#endif

template <int BM, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
bwd_chain_kernel(const ChainArgs a, const __grid_constant__ WeightMaps maps, const float* __restrict__ deltas,
                 const float* __restrict__ zs, int quant, int qat, int fxp32_phase1, float q_max) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) unsigned long long bars[MAX_LAYERS];

  cg::cluster_group cluster = cg::this_cluster();
  Ctx x;
  x.smem = smem;
  x.deltas = deltas;
  x.zs = zs;
  x.q_max = q_max;
  x.C = (int)cluster.num_blocks();
  x.q = (int)cluster.block_rank();
  x.quant = quant;
  x.qat = qat;
  x.fxp32_phase1 = fxp32_phase1;
  const int C = x.C, q = x.q;
  const int cid = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = a.n_layers;
  const Net& nt = a.net[0];
  FXP_STAMP(0, true);

  if (RESIDENT) {
    if (tid == 0) {
      for (int l = 0; l < L; ++l)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bars[l])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      if (!nt.bulk[l])
        load_slice_plain<THREADS>(nt, l, q, C, smem + nt.w_off[l]);
      else if (warp == 0)
        load_slice_bulk(nt, &maps.m[l], l, q, C, smem + nt.w_off[l], &bars[l], lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  FXP_STAMP(1);

  const int n_rb = (a.M + BM - 1) / BM;
  const int K0 = nt.dims[0], s0 = slice_width(K0, C), klo = q * s0, kn = max(0, min(s0, K0 - klo));
  int rit = 0;
  for (int rb = cid; rb < n_rb; rb += n_clusters) {
    if (rb != cid) cluster_sync();  // every peer is done with this block's buffers
    const int row0 = rb * BM;
    const int rows = min(BM, a.M - row0);
    float* gb = smem + a.g_off[0];
    float* gn = smem + a.g_off[1];

    // ---- the row block's residuals: g of y and every layer's output in the
    // form their activation backward reads (a K-split layer's whole output,
    // else the block's slice), and x0's slice for layer 0's mask
    load_rows<BM>(x, gb, a.gy, nt.dims[L], nt.ksplit[L - 1], a.pmax, row0, rows);
    for (int l = 0; l < L; ++l)
      load_rows<BM>(x, smem + (nt.ksplit[l] ? nt.hf_off[l] : nt.x_off[l + 1]), a.h[l], nt.dims[l + 1],
                    nt.ksplit[l], a.pmax, row0, rows);
    load_rows<BM>(x, smem + nt.x_off[0], a.x0, K0, false, 0, row0, rows);
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's copies (and its plain W copies)
    if (rb == cid) FXP_STAMP(2);
    if (RESIDENT && rb == cid)
      for (int l = 0; l < L; ++l)
        if (nt.bulk[l]) mbar_wait(&bars[l], 0);
    __syncthreads();
    if (rb == cid) FXP_STAMP(3);

    // ---- the chain: G_l for pass 2, dx below every layer ----------------
    for (int l = L - 1; l >= 0; --l) {
      act_bwd<BM, THREADS>(a, x, nt, l, gb, nt.ksplit[l], a.g[l], row0, rows);
      if (rb == cid) FXP_STAMP(4 + 2 * (L - 1 - l));
      const bool below_full = l > 0 && nt.ksplit[l - 1];
      const float* x_in = smem + (below_full ? nt.hf_off[l - 1] : nt.x_off[l]);
      bwd_dx<BM, RESIDENT, THREADS>(a, x, 0, l, gb, 0, nt.dims[l], below_full, gn, x_in, rows, rit);
      if (rb == cid) FXP_STAMP(5 + 2 * (L - 1 - l));
      float* t = gb;
      gb = gn;
      gn = t;
    }
    for (int e = tid; e < rows * kn; e += THREADS) {
      const int r = e / kn, c = e % kn;
      a.dx[(size_t)(row0 + r) * K0 + klo + c] = gb[r * s0 + c];
    }
  }
  FXP_STAMP(4 + 2 * L);
  cluster_sync();  // peers may still write this block's receive rows
  FXP_STAMP(5 + 2 * L, true);
}

struct DwArgs {
  const float* q[MAX_LAYERS];  // (M, dims[l]) effective dense inputs
  const float* g[MAX_LAYERS];  // (M, dims[l+1]) pass 1's cotangents
  float* dw[MAX_LAYERS];       // (dims[l], dims[l+1])
  float* db[MAX_LAYERS];       // (dims[l+1],)
  int dims[MAX_LAYERS + 1];
  int tile0[MAX_LAYERS + 1];   // first tile of layer l; tile0[L] = total
  int tiles_n[MAX_LAYERS];     // tiles across dims[l+1]
};

__global__ void __launch_bounds__(THREADS)
bwd_dw_kernel(const DwArgs args, int M) {
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

struct Launch {
  int bm, C, n_clusters, resident;
  size_t smem;
};

// Read a plan as `kernel._c_bwd_plan` writes it — bm, cluster, n_clusters,
// resident, smax, pmax, rmax, gmax, full_off, g_off[2], smem, then per layer
// ksplit, bulk, w_off, per layer and the last output x_off, per layer
// hf_off — into `a` (whose net is filled) and `maps`; check that every
// region of the layout lies inside the block's shared memory, apart from
// every other, 16-byte aligned (W slices 128-byte aligned), and wide enough
// for the shapes.  Returns 0 or a CUDA error code.
int read_plan(const int* plan, ChainArgs& a, WeightMaps& maps, Launch& ln) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const int L = a.n_layers;
  ln.bm = plan[0];
  ln.C = plan[1];
  ln.n_clusters = plan[2];
  ln.resident = plan[3];
  a.smax = plan[4];
  a.pmax = plan[5];
  a.rmax = plan[6];
  a.gmax = plan[7];
  a.full_off = plan[8];
  a.g_off[0] = plan[9];
  a.g_off[1] = plan[10];
  const int smem = plan[11];
  const int C = ln.C, bm = ln.bm;
  const bool instance = ln.resident ? (bm == 8 || bm == 16) : (bm == 4 || bm == 8);
  if (!instance || C < 1 || C > 16 || ln.n_clusters < 1 || smem < 0 || smem > fxp::kMaxSmem - STATIC_SMEM)
    return (int)cudaErrorInvalidValue;
  ln.smem = (size_t)smem;
  const int strides[4] = {a.smax, a.pmax, a.rmax, a.gmax};
  for (int v : strides)
    if (v < 0 || v % 4 != 0) return (int)cudaErrorInvalidValue;
  if (a.rmax < a.smax || a.rmax < a.pmax || a.gmax < a.smax || a.gmax < a.pmax) return (int)cudaErrorInvalidValue;
  // regions: (offset, floats, alignment in floats)
  int off[4 + 4 * MAX_LAYERS], len[4 + 4 * MAX_LAYERS], n_reg = 0;
  auto region = [&](int o, int n, int align) {
    if (o < 0 || n < 0 || o % align != 0) return false;
    off[n_reg] = o;
    len[n_reg++] = n;
    return true;
  };
  bool ok = region(a.full_off, 2 * C * bm * a.rmax, 4) && region(a.g_off[0], bm * a.gmax, 4) &&
            region(a.g_off[1], bm * a.gmax, 4);
  Net& nt = a.net[0];
  const int* p = plan + 12;
  for (int l = 0; l < L; ++l) {
    nt.ksplit[l] = p[l];
    nt.bulk[l] = p[L + l];
    nt.w_off[l] = p[2 * L + l];
    nt.hf_off[l] = p[4 * L + 1 + l];
  }
  for (int l = 0; l <= L; ++l) nt.x_off[l] = p[3 * L + l];
  for (int l = 0; l <= L && ok; ++l) {
    if (slice_width(nt.dims[l], C) > a.smax) ok = false;
    ok = ok && region(nt.x_off[l], bm * slice_width(nt.dims[l], C), 4);
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
        const int rc = weight_map(&maps.m[l], nt.w[l], K, N, C);
        if (rc != 0) return rc;
      }
    } else if (nt.bulk[l]) {
      ok = false;
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

}  // namespace

// C interface, loaded with ctypes.  gy (M, dims[L]); x0 (M, dims[0]);
// weights[l] (dims[l], dims[l+1]); qs[l] (M, dims[l]); hs[l]
// (M, dims[l+1]) with hs[L-1] = y; gs[l] (M, dims[l+1]) scratch; dws[l]
// (dims[l], dims[l+1]) and dbs[l] (dims[l+1],) outputs; deltas/zs
// (n_layers,) or null when qat == 0; dx (M, dims[0]).  All float32,
// contiguous, on the current device.  plan: `kernel.bwd_plan` as ints
// (`read_plan`).  Launches pass 1 (a cluster launch) and pass 2 on
// `stream` and returns 0 or a CUDA error code (cudaErrorInvalidValue for
// arguments the kernels do not take, fxp::kErrClusterUnschedulable for a
// cluster shape the card cannot run).
extern "C" int fxp_mlp_bwd_launch(const float* gy, const float* x0, const void* const* weights,
                                  const void* const* qs, const void* const* hs, void* const* gs,
                                  void* const* dws, void* const* dbs, const int* dims,
                                  const int* acts, int n_layers, const float* deltas,
                                  const float* zs, float* dx, int M, const int* plan, int quant, int qat,
                                  int fxp32_phase1, int n_bits, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || M <= 0 || n_bits < 1 || n_bits > 24)
    return (int)cudaErrorInvalidValue;
  if (qat && (deltas == nullptr || zs == nullptr)) return (int)cudaErrorInvalidValue;
  ChainArgs a = {};
  DwArgs d = {};
  a.n_layers = n_layers;
  a.gy = gy;
  a.x0 = x0;
  a.dx = dx;
  a.M = M;
  Net& nt = a.net[0];
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    nt.dims[l] = d.dims[l] = dims[l];
  }
  d.tile0[0] = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < 0 || acts[l] > 2) return (int)cudaErrorInvalidValue;
    nt.w[l] = static_cast<const float*>(weights[l]);
    nt.acts[l] = acts[l];
    a.h[l] = static_cast<const float*>(hs[l]);
    a.g[l] = static_cast<float*>(gs[l]);
    d.q[l] = static_cast<const float*>(qs[l]);
    d.g[l] = a.g[l];
    d.dw[l] = static_cast<float*>(dws[l]);
    d.db[l] = static_cast<float*>(dbs[l]);
    if (!nt.w[l] || !a.h[l] || !a.g[l] || !d.q[l] || !d.dw[l] || !d.db[l]) return (int)cudaErrorInvalidValue;
    const int tk = (dims[l] + TILE - 1) / TILE, tn = (dims[l + 1] + TILE - 1) / TILE;
    d.tiles_n[l] = tn;
    d.tile0[l + 1] = d.tile0[l] + tk * tn;
  }
  nt.site0 = 0;
  WeightMaps maps = {};
  Launch ln;
  int rc = read_plan(plan, a, maps, ln);
  if (rc != 0) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const float q_max = (float)((1 << n_bits) - 1);
  const dim3 grid(ln.n_clusters * ln.C), block(THREADS), cluster(ln.C, 1, 1);
#define FXP_BWD_LAUNCH(BM, RES)                                                                                  \
  fxp::launch_cluster(bwd_chain_kernel<BM, RES>, grid, block, ln.smem, cluster, s, a, maps, deltas, zs, quant, qat, \
                      fxp32_phase1, q_max)
  if (ln.resident)
    rc = ln.bm == 16 ? FXP_BWD_LAUNCH(16, true) : FXP_BWD_LAUNCH(8, true);
  else
    rc = ln.bm == 8 ? FXP_BWD_LAUNCH(8, false) : FXP_BWD_LAUNCH(4, false);
#undef FXP_BWD_LAUNCH
  if (rc != 0) return rc;
  bwd_dw_kernel<<<d.tile0[n_layers], THREADS, 0, s>>>(d, M);
  return (int)cudaGetLastError();
}

extern "C" const char* fxp_mlp_bwd_error_string(int code) { return fxp::error_string(code); }

#ifdef FXP_BWD_TRACE
// Point the chain pass's phase stamps at `buffer` (blocks × TRACE_SLOTS
// uint64 on the device), or at nothing.
extern "C" int fxp_mlp_bwd_set_trace(unsigned long long* buffer) {
  return (int)cudaMemcpyToSymbol(g_trace, &buffer, sizeof(buffer));
}
#endif

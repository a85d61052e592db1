// Kernel A: the dual-precision dense layer, y = act(x·W + b), for sm_90a.
//
// Replaces the TPU kernel `fxp_dense_pallas` → `_dense_kernel_full` /
// `_dense_kernel_half` in src/repro/kernels/fxp_matmul/kernel.py.
//
// What it computes (the value-space model of FIXAR's PE, ref_fxp_dense):
//   hi = bf16(x) rounded to nearest even, lo = x − hi   (exact split)
//   full precision: acc = Σ_k hi·w + Σ_k lo·w   (two sums, one per limb)
//   half precision: acc = Σ_k hi·w              (one sum)
//   y = act(acc + b), act ∈ {none, relu, tanh}
// The limb split happens here, on the shared-memory store of x.
//
// What bounds it on the H100: at the serving shapes — (B,17)×(17,400),
// (B,400)×(400,300), (B,300)×(300,6), B ≤ 512 — at most 2 limbs ×
// 2·512·400·300 ≈ 0.25 GFLOP of f32 FMA against ≈ 1.5 MB of operands:
// operations (the non-tensor f32 peak) at large B, bytes at B = 1, and
// in practice launch and L2 latency, since at B = 1 a layer is a few µs.
//
// Design: CUDA-core f32 FMA (W is f32 and not bf16-exact, so no bf16 or
// TF32 MMA reproduces dot(hi, W)).  The launch plan,
// `repro_torch.kernels.fxp_matmul.kernel.dense_plan(m, k, n)`, picks one of
// two bodies, an output tile and a split of K:
//  * the tiled body (M > 32 and N > 32): 64×64 (or 32×64) output tiles,
//    256 threads, each owning a 4×4 (at 32 rows 2×4) register tile per limb.
//    W tiles (16×64) pass through a 3-stage cp.async ring, x tiles (BM×16)
//    through a register prefetch and a double-buffered, transposed shared
//    tile where they are split into limbs; per k step a thread reads one
//    vector of each limb and a float4 of W for 16 (32 in full precision)
//    FMAs at 64 rows.  A thread whose rows or columns all lie outside the
//    output skips the FMAs.
//  * the small body (M ≤ 32 or N ≤ 32): 8-row tiles of bn ∈ {8, 16, 32}
//    columns; the block's 256 threads split its K range into 256/bn
//    interleaved groups, each thread holding one column × the valid rows
//    (a compile-time row count from 1 to 8, so masked rows spend no FMAs);
//    W is read straight from L2, four loads in flight per thread; the
//    groups' partial sums are added in group order in shared memory.
// Split K: the blocks that share one output tile form a thread-block
// cluster of `split` blocks along z; block z sums K range z.  After a
// cluster barrier each block adds a share of the tile's outputs from the
// blocks' shared memory (distributed shared memory), rank by rank in
// order, per limb; then acc_hi + acc_lo, the bias and the activation, in
// the reference's order.  No atomics: two calls are bitwise equal.  A
// second cluster barrier keeps every block alive until its peers have read
// its partial sums.  Per output the sum runs in k order within a group,
// then over the groups, then over the split: another order than a single
// dot, within the 2e-5 contract.
//
// Launch plan (dense_plan): the first of tiled 64-row, tiled 32-row and
// small 32-, 16- and 8-column tiles that launches at least half a wave of
// blocks (66), the tiled body splitting K into at most 8 chunks of at
// least 32 toward a wave (132), the small body into at most 16 chunks of
// at least 16 toward half a wave; a K too shallow to split (17) runs split
// 1 on more, narrower tiles.

#include <cooperative_groups.h>

#include "fxp_cluster.cuh"
#include "fxp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using fxp::activate;
using fxp::bf16_hi;

constexpr int THREADS = 256;
// tiled body: BM (64 or 32) × 64 output tiles, a thread owning BM/16 × 4
constexpr int T_BN = 64, T_BK = 16, T_STAGES = 3, T_TN = 4;
template <int BM>
__host__ __device__ constexpr int t_xs() { return BM + 4; }  // row stride of the transposed x limb tiles (float4-aligned)
template <int BM>
__host__ __device__ constexpr int t_smem() {  // floats: the ring and the x tiles, or the two limbs' partial sums
  return T_STAGES * T_BK * T_BN + 2 * 2 * T_BK * t_xs<BM>() > 2 * BM * T_BN
             ? T_STAGES * T_BK * T_BN + 2 * 2 * T_BK * t_xs<BM>()
             : 2 * BM * T_BN;
}
// small body
constexpr int S_BM = 8, S_SK = 256;

struct DenseArgs {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  int M, K, N, act, chunk;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The epilogue of one output from its two limb sums.
__device__ __forceinline__ void finish(const DenseArgs& a, int gr, int gc, float hi, float lo, bool full) {
  float v = full ? hi + lo : hi;
  if (a.b != nullptr) v = v + a.b[gc];
  a.y[(size_t)gr * a.N + gc] = activate(v, a.act);
}

// Split K: the outputs [0, n_out) of this tile, partial sums ph/pl in
// every block's shared memory at the same offsets; block `rank` of the
// cluster adds outputs rank·THREADS + tid, … over the ranks in order.
// `place(o, gr, gc)` maps an output to its row and column (false: masked).
template <typename Place>
__device__ __forceinline__ void cluster_reduce(const DenseArgs& a, float* ph, float* pl, int n_out, bool full,
                                               Place place) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int o = rank * THREADS + (int)threadIdx.x; o < n_out; o += split * THREADS) {
    int gr, gc;
    if (!place(o, gr, gc)) continue;
    float hi = *cluster.map_shared_rank(ph + o, 0);
    float lo = full ? *cluster.map_shared_rank(pl + o, 0) : 0.0f;
    for (int s = 1; s < split; ++s) {
      hi += *cluster.map_shared_rank(ph + o, s);
      if (full) lo += *cluster.map_shared_rank(pl + o, s);
    }
    finish(a, gr, gc, hi, lo, full);
  }
  cluster.sync();  // peers may still read this block's partial sums
}

// ---- tiled body ---------------------------------------------------------

// A thread's TM (4 or 2) consecutive x limbs of one k, as one vector load.
template <int TM>
__device__ __forceinline__ void limbs(const float* p, float (&v)[TM]) {
  if constexpr (TM == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

template <bool FULL, bool VEC, int T_BM>
__global__ void __launch_bounds__(THREADS) dense_tiled(const DenseArgs a) {
  constexpr int T_TM = T_BM / 16, T_XS = t_xs<T_BM>();
  __shared__ __align__(16) float smem[t_smem<T_BM>()];
  float* ws = smem;                                // [T_STAGES][T_BK][T_BN]
  float* xh = smem + T_STAGES * T_BK * T_BN;       // [2][T_BK][T_XS]
  float* xl = xh + 2 * T_BK * T_XS;                // [2][T_BK][T_XS]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int n_ct = (a.N + T_BN - 1) / T_BN;  // column tiles; blockIdx.x = row tile · n_ct + column tile
  const int row0 = (blockIdx.x / n_ct) * T_BM, col0 = (blockIdx.x % n_ct) * T_BN;
  const int k_lo = blockIdx.z * a.chunk;
  const int k_hi = min(a.K, k_lo + a.chunk);
  const int nk = max(0, k_hi - k_lo);
  const int tiles = (nk + T_BK - 1) / T_BK;
  const bool active = row0 + ty * T_TM < a.M && col0 + tx * T_TN < a.N;

  float ah[T_TM][T_TN], al[T_TM][T_TN];
#pragma unroll
  for (int i = 0; i < T_TM; ++i)
#pragma unroll
    for (int j = 0; j < T_TN; ++j) ah[i][j] = al[i][j] = 0.0f;

  auto load_w = [&](int t) {
    float* dst = ws + (t % T_STAGES) * T_BK * T_BN;
    const int k0 = k_lo + t * T_BK;
    if (VEC) {  // N % 4 == 0: one float4 per thread, wholly in or out
      const int r = tid / (T_BN / 4), c = (tid % (T_BN / 4)) * 4;
      const bool ok = k0 + r < k_hi && col0 + c < a.N;
      cp_async16(dst + r * T_BN + c, ok ? a.w + (size_t)(k0 + r) * a.N + col0 + c : a.w, ok);
    } else {
      for (int e = tid; e < T_BK * T_BN; e += THREADS) {
        const int r = e / T_BN, c = e % T_BN;
        const bool ok = k0 + r < k_hi && col0 + c < a.N;
        cp_async4(dst + e, ok ? a.w + (size_t)(k0 + r) * a.N + col0 + c : a.w, ok);
      }
    }
  };
  float xr[T_BM * T_BK / THREADS];
  auto fetch_x = [&](int t) {
    const int k0 = k_lo + t * T_BK;
#pragma unroll
    for (int i = 0; i < T_BM * T_BK / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / T_BK, c = e % T_BK;
      xr[i] = (row0 + r < a.M && k0 + c < k_hi) ? __ldg(a.x + (size_t)(row0 + r) * a.K + k0 + c) : 0.0f;
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int i = 0; i < T_BM * T_BK / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / T_BK, c = e % T_BK;
      const float h = bf16_hi(xr[i]);
      xh[buf * T_BK * T_XS + c * T_XS + r] = h;
      if (FULL) xl[buf * T_BK * T_XS + c * T_XS + r] = xr[i] - h;
    }
  };
  auto mac = [&](const float* wt, const float* xht, const float* xlt, int kk) {
    const float4 w4 = *reinterpret_cast<const float4*>(wt + kk * T_BN + tx * T_TN);
    const float wv[T_TN] = {w4.x, w4.y, w4.z, w4.w};
    float hv[T_TM];
    limbs<T_TM>(xht + kk * T_XS + ty * T_TM, hv);
#pragma unroll
    for (int i = 0; i < T_TM; ++i)
#pragma unroll
      for (int j = 0; j < T_TN; ++j) ah[i][j] = fmaf(hv[i], wv[j], ah[i][j]);
    if (FULL) {
      float lv[T_TM];
      limbs<T_TM>(xlt + kk * T_XS + ty * T_TM, lv);
#pragma unroll
      for (int i = 0; i < T_TM; ++i)
#pragma unroll
        for (int j = 0; j < T_TN; ++j) al[i][j] = fmaf(lv[i], wv[j], al[i][j]);
    }
  };

  if (tiles > 0) {
#pragma unroll
    for (int s = 0; s < T_STAGES - 1; ++s) {
      if (s < tiles) load_w(s);
      cp_async_commit();
    }
    fetch_x(0);
    store_x(0);
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<T_STAGES - 2>();  // this thread's copies of stage t have landed
    if (t + 1 < tiles) fetch_x(t + 1);
    __syncthreads();  // every copy of stage t and x buffer t&1 visible; stage t−1 free
    if (t + T_STAGES - 1 < tiles) load_w(t + T_STAGES - 1);
    cp_async_commit();
    const float* wt = ws + (t % T_STAGES) * T_BK * T_BN;
    const float* xht = xh + (t & 1) * T_BK * T_XS;
    const float* xlt = xl + (t & 1) * T_BK * T_XS;
    const int kk_end = min(T_BK, nk - t * T_BK);
    if (active) {
      if (kk_end == T_BK) {
#pragma unroll
        for (int kk = 0; kk < T_BK; ++kk) mac(wt, xht, xlt, kk);
      } else {
        for (int kk = 0; kk < kk_end; ++kk) mac(wt, xht, xlt, kk);
      }
    }
    if (t + 1 < tiles) store_x((t + 1) & 1);  // buffer (t+1)&1 was last read in step t−1
  }

  if (gridDim.z == 1) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < T_TM; ++i)
#pragma unroll
      for (int j = 0; j < T_TN; ++j) {
        const int gr = row0 + ty * T_TM + i, gc = col0 + tx * T_TN + j;
        if (gr < a.M && gc < a.N) finish(a, gr, gc, ah[i][j], al[i][j], FULL);
      }
    return;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the x tiles are free: the partial sums take their place
  float* ph = smem;
  float* pl = smem + T_BM * T_BN;
#pragma unroll
  for (int i = 0; i < T_TM; ++i)
#pragma unroll
    for (int j = 0; j < T_TN; ++j) {
      const int o = (ty * T_TM + i) * T_BN + tx * T_TN + j;
      ph[o] = ah[i][j];
      pl[o] = al[i][j];
    }
  cluster_reduce(a, ph, pl, T_BM * T_BN, FULL, [&](int o, int& gr, int& gc) {
    gr = row0 + o / T_BN;
    gc = col0 + o % T_BN;
    return gr < a.M && gc < a.N;
  });
}

// ---- small body -----------------------------------------------------------

// One thread's share of a K sub-tile: k = g, g + kg, … < kn, in order, for
// R rows and the thread's column (wcol = W + column, row stride N).
template <int R, bool FULL>
__device__ __forceinline__ void small_mac(const float* xh, const float* xl, const float* wcol, int N, int k0,
                                          int kn, int g, int kg, float (&ah)[S_BM], float (&al)[S_BM]) {
  int kk = g;
  for (; kk + 3 * kg < kn; kk += 4 * kg) {
    float wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wv[u] = __ldg(wcol + (size_t)(k0 + kk + u * kg) * N);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ah[r] = fmaf(xh[r * S_SK + kk + u * kg], wv[u], ah[r]);
        if (FULL) al[r] = fmaf(xl[r * S_SK + kk + u * kg], wv[u], al[r]);
      }
  }
  for (; kk < kn; kk += kg) {
    const float wv = __ldg(wcol + (size_t)(k0 + kk) * N);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ah[r] = fmaf(xh[r * S_SK + kk], wv, ah[r]);
      if (FULL) al[r] = fmaf(xl[r * S_SK + kk], wv, al[r]);
    }
  }
}

template <bool FULL>
__global__ void __launch_bounds__(THREADS) dense_small(const DenseArgs a, int bn) {
  __shared__ __align__(16) float xh[S_BM * S_SK];
  __shared__ __align__(16) float xl[S_BM * S_SK];
  __shared__ float rh[THREADS * S_BM];  // (group, row, column) partial sums
  __shared__ float rl[THREADS * S_BM];
  __shared__ float ph[S_BM * 32];  // the block's sums of its K range, (row, column)
  __shared__ float pl[S_BM * 32];

  const int tid = threadIdx.x;
  const int kg = THREADS / bn, c = tid % bn, g = tid / bn;
  const int n_ct = (a.N + bn - 1) / bn;
  const int row0 = (blockIdx.x / n_ct) * S_BM;
  const int rows = min(S_BM, a.M - row0);
  const int col0 = (blockIdx.x % n_ct) * bn;
  const int col = col0 + c;
  const int k_lo = blockIdx.z * a.chunk;
  const int k_hi = min(a.K, k_lo + a.chunk);

  float ah[S_BM], al[S_BM];
#pragma unroll
  for (int r = 0; r < S_BM; ++r) ah[r] = al[r] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += S_SK) {
    const int kn = min(S_SK, k_hi - k0);
    for (int e = tid; e < rows * kn; e += THREADS) {
      const int r = e / kn, cc = e % kn;
      const float v = __ldg(a.x + (size_t)(row0 + r) * a.K + k0 + cc);
      const float h = bf16_hi(v);
      xh[r * S_SK + cc] = h;
      if (FULL) xl[r * S_SK + cc] = v - h;
    }
    __syncthreads();
    if (col < a.N) {
      const float* wcol = a.w + col;
      switch (rows) {
#define FXP_DENSE_ROWS(R) \
  case R:                 \
    small_mac<R, FULL>(xh, xl, wcol, a.N, k0, kn, g, kg, ah, al); \
    break;
        FXP_DENSE_ROWS(1)
        FXP_DENSE_ROWS(2)
        FXP_DENSE_ROWS(3)
        FXP_DENSE_ROWS(4)
        FXP_DENSE_ROWS(5)
        FXP_DENSE_ROWS(6)
        FXP_DENSE_ROWS(7)
        FXP_DENSE_ROWS(8)
#undef FXP_DENSE_ROWS
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < S_BM; ++r) {
    rh[(g * S_BM + r) * bn + c] = ah[r];
    rl[(g * S_BM + r) * bn + c] = al[r];
  }
  __syncthreads();
  const int n_out = rows * bn;
  if (tid < n_out) {  // add the groups in order
    const int r = tid / bn, cc = tid % bn;
    float hi = rh[r * bn + cc], lo = rl[r * bn + cc];
    for (int g2 = 1; g2 < kg; ++g2) {
      hi += rh[(g2 * S_BM + r) * bn + cc];
      if (FULL) lo += rl[(g2 * S_BM + r) * bn + cc];
    }
    if (gridDim.z == 1) {
      if (col0 + cc < a.N) finish(a, row0 + r, col0 + cc, hi, lo, FULL);
    } else {
      ph[tid] = hi;
      pl[tid] = lo;
    }
  }
  if (gridDim.z == 1) return;
  cluster_reduce(a, ph, pl, n_out, FULL, [&](int o, int& gr, int& gc) {
    gr = row0 + o / bn;
    gc = col0 + o % bn;
    return gc < a.N;
  });
}

template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), dim3 grid, int split, cudaStream_t stream, Args... args) {
  if (split == 1) {
    kernel<<<grid, THREADS, 0, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  return fxp::launch_cluster(kernel, grid, dim3(THREADS), 0, dim3(1, 1, split), stream, args...);
}

}  // namespace

// C interface, loaded with ctypes.  x (M, K), w (K, N), b (N,) or null,
// y (M, N): float32, contiguous, on the current device.  act: 0 none,
// 1 relu, 2 tanh.  bm, bn, split: the launch plan (`dense_plan`): bm 64
// or 32 with bn 64 is the tiled body, bm 8 with bn ∈ {8, 16, 32} the small body;
// split ∈ 1..16 chunks of K (a cluster of `split` blocks per output tile
// when > 1).  The grid is (row tiles × column tiles, 1, split).  Launches on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take, or
// fxp::kErrClusterUnschedulable).
extern "C" int fxp_dense_launch(const float* x, const float* w, const float* b, float* y, int M, int K, int N,
                                int full, int act, int bm, int bn, int split, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < 0 || act > 2 || split < 1 || split > 16) return (int)cudaErrorInvalidValue;
  const bool small = bm == S_BM;
  if (small ? (bn != 8 && bn != 16 && bn != 32) : ((bm != 64 && bm != 32) || bn != T_BN))
    return (int)cudaErrorInvalidValue;
  const int chunk = K == 0 ? 0 : (K + split - 1) / split;
  if (split > 1 && (split - 1) * chunk >= K) return (int)cudaErrorInvalidValue;  // an empty chunk
  const long long tiles = (long long)((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, split);
  const DenseArgs a = {x, w, b, y, M, K, N, act, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  if (small) return full ? launch(dense_small<true>, grid, split, s, a, bn) : launch(dense_small<false>, grid, split, s, a, bn);
  const bool vec = N % 4 == 0 && ((size_t)w & 15) == 0;
#define FXP_DENSE_TILED(BM)                                                                       \
  (full ? (vec ? launch(dense_tiled<true, true, BM>, grid, split, s, a)                          \
               : launch(dense_tiled<true, false, BM>, grid, split, s, a))                        \
        : (vec ? launch(dense_tiled<false, true, BM>, grid, split, s, a)                         \
               : launch(dense_tiled<false, false, BM>, grid, split, s, a)))
  return bm == 64 ? FXP_DENSE_TILED(64) : FXP_DENSE_TILED(32);
#undef FXP_DENSE_TILED
}

extern "C" const char* fxp_dense_error_string(int code) { return fxp::error_string(code); }

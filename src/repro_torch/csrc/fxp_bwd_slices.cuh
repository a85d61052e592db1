// The weight-split backward shared by kernel 3 (fxp_mlp_bwd.cu) and kernels
// 4 and 5 (fxp_ddpg_step.cu): per layer, the activation backward on a
// block's slice of the cotangent (`act_bwd`) and the cotangent of the layer
// input (`bwd_dx`) — a column-split layer's partial dx over all K inputs
// reduce-scattered onto the owners' slices in rank order through
// distributed shared memory, a K-split layer's dx slice local — then the
// site's straight-through mask.  Templated on the argument and net structs
// each file keeps (members: the layout's row strides pmax and rmax, the
// receive rows full_off, net[]; a net's w, dims, acts, ksplit, w_off,
// x_off, hf_off, site0), so the layer count is each file's own.

#pragma once

#include <cooperative_groups.h>

#include "fxp_common.cuh"
#include "fxp_slices.cuh"

namespace fxp {
namespace {  // internal to each file that includes it, as the code it replaced

constexpr int RB = 4;  // rows of a backward partial-dx item

// Per-launch constants of a block.
struct Ctx {
  float* smem;
  const float* deltas;
  const float* zs;
  float q_max;
  int C, q, quant, qat, fxp32_phase1;
};

__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// Activation backward in place on the cotangent of layer l's output: the
// whole output (`full`, a K-split layer, stride pmax, from hf) or the
// block's slice (stride sw(N), from xout, zeros past the slice's columns).
// Rows past `rows` become 0.  With G, the valid rows of the block's own
// columns go to G (M, N) for pass 2.
template <int BM, int THREADS, class Args, class Net>
__device__ void act_bwd(const Args& a, const Ctx& x, const Net& nt, int l, float* g, bool full, float* G,
                        int row0, int rows) {
  const int N = nt.dims[l + 1], act = nt.acts[l];
  const int s_out = slice_width(N, x.C), nlo = x.q * s_out, nq = max(0, min(s_out, N - nlo));
  const float* h = x.smem + (full ? nt.hf_off[l] : nt.x_off[l + 1]);
  const int width = full ? N : s_out, stride = full ? a.pmax : s_out;
  for (int u = threadIdx.x; u < BM * width; u += THREADS) {
    const int r = u / width, c = u % width, o = r * stride + c;
    const int n = full ? c : nlo + c;  // the output column
    const bool live = r < rows && (full || c < nq);
    float v = live ? g[o] : 0.0f;
    if (live && act == 1) {
      v = h[o] > 0.0f ? v : 0.0f;
    } else if (live && act == 2) {
      const float hv = h[o];
      v = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(hv, hv)));
    }
    g[o] = v;
    if (G != nullptr && live && n >= nlo && n < nlo + nq) G[(size_t)(row0 + r) * N + n] = v;
  }
  __syncthreads();
}

// dx of layer l over its input columns [kb, kb + D), from the cotangent g
// of its output (act_bwd's result: the whole output for a K-split layer,
// the block's slice for a column-split one), into dst: every block all D
// columns (`to_full`, stride pmax) or the block's slice of sw(D) columns
// (stride sw(D)); then the site's straight-through mask on x_in (the
// layer's pre-projection input, in dst's form and stride) and zero rows
// past `rows`.  `rit` counts reductions (the receive rows' parity).
template <int BM, bool RESIDENT, int THREADS, class Args>
__device__ void bwd_dx(const Args& a, const Ctx& x, int ni, int l, const float* g, int kb, int D, bool to_full,
                       float* dst, const float* x_in, int rows, int& rit) {
  const auto& nt = a.net[ni];
  const int K = nt.dims[l], N = nt.dims[l + 1], C = x.C, q = x.q, tid = threadIdx.x;
  const int s_in = slice_width(K, C), klo = q * s_in, kn = max(0, min(s_in, K - klo));
  const int s_out = slice_width(N, C), nlo = q * s_out, nq = max(0, min(s_out, N - nlo));
  const int PM = a.pmax, RM = a.rmax;
  const int sd = slice_width(D, C);
  const int stride = to_full ? PM : sd;
  const int dlo = to_full ? 0 : q * sd;
  const int dn = to_full ? D : max(0, min(sd, D - dlo));
  const float* wl = RESIDENT ? x.smem + nt.w_off[l] : nt.w[l];
  float* recv = x.smem + a.full_off + (rit & 1) * C * BM * RM;  // [sender][BM][rmax]
  const bool local = nt.ksplit[l] && !to_full && kb == 0 && D == K;

  if (local) {
    // ---- K-split, the block's own K slice: no exchange
    for (int u = tid; u < BM * kn; u += THREADS) {
      const int r = u / kn, k = u % kn;
      float v = 0.0f;
      if (r < rows)
        for (int n = 0; n < N; ++n)
          v = fmaf(g[r * PM + n], RESIDENT ? wl[k * N + n] : __ldg(wl + (size_t)(klo + k) * N + n), v);
      dst[r * stride + k] = v;
    }
  } else if (nt.ksplit[l]) {
    // ---- K-split, to every block or onto another slicing: each block
    // contributes its own K rows and zeros elsewhere
    for (int u = tid; u < BM * D; u += THREADS) {
      const int r = u / D, j = u % D, k = kb + j;
      float v = 0.0f;
      if (r < rows && k >= klo && k < klo + kn)
        for (int n = 0; n < N; ++n)
          v = fmaf(g[r * PM + n], RESIDENT ? wl[(k - klo) * N + n] : __ldg(wl + (size_t)k * N + n), v);
      if (to_full) {
        for (int p = 0; p < C; ++p) peer(recv, p)[(q * BM + r) * RM + j] = v;
      } else {
        const int p = j / sd;
        peer(recv, p)[(q * BM + r) * RM + j - p * sd] = v;
      }
    }
  } else {
    // ---- column-split: the partial over this block's N slice, RB rows and
    // four input columns an item, in c order per output
    const int d4 = (D + 3) / 4, nq4 = (nq + 3) / 4 * 4;
    for (int u = tid; u < d4 * (BM / RB); u += THREADS) {
      const int j0 = (u % d4) * 4, r0 = (u / d4) * RB;
      float acc[RB][4];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][t] = 0.0f;
      if (r0 < rows) {
        int kr[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) kr[t] = kb + min(j0 + t, D - 1);  // past D: a row whose result is dropped
        for (int c = 0; c < nq4; c += 4) {
          float4 gv[RB], wv[4];
#pragma unroll
          for (int i = 0; i < RB; ++i) gv[i] = *reinterpret_cast<const float4*>(g + (r0 + i) * s_out + c);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (RESIDENT) {
              wv[t] = *reinterpret_cast<const float4*>(wl + kr[t] * s_out + c);
            } else {
              const float* wr = wl + (size_t)kr[t] * N + nlo + c;
              wv[t] = make_float4(c < nq ? __ldg(wr) : 0.0f, c + 1 < nq ? __ldg(wr + 1) : 0.0f,
                                  c + 2 < nq ? __ldg(wr + 2) : 0.0f, c + 3 < nq ? __ldg(wr + 3) : 0.0f);
            }
          }
#pragma unroll
          for (int i = 0; i < RB; ++i)
#pragma unroll
            for (int t = 0; t < 4; ++t)
              acc[i][t] = fmaf(gv[i].w, wv[t].w,
                               fmaf(gv[i].z, wv[t].z, fmaf(gv[i].y, wv[t].y, fmaf(gv[i].x, wv[t].x, acc[i][t]))));
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        const int o = (q * BM + r0 + i) * RM;
        if (to_full) {
          for (int p = 0; p < C; ++p) *reinterpret_cast<float4*>(peer(recv, p) + o + j0) = v;
        } else {
          const int p = j0 / sd;
          *reinterpret_cast<float4*>(peer(recv, p) + o + j0 - p * sd) = v;
        }
      }
    }
  }
  if (!local) {
    cluster_sync();  // every block's partials are in their owners' receive rows
    ++rit;
  }
  // ---- add the C partials in rank order; mask; zero rows past the batch
  const int site = nt.site0 + l;
  const bool mask = x.qat != 0;
  const float delta = mask ? x.deltas[site] : 1.0f;
  const float z = mask ? x.zs[site] : 0.0f;
  const float lo = -z * delta;
  const float hi = (x.q_max - z) * delta;
  const int width = local ? kn : dn;
  for (int u = tid; u < BM * width; u += THREADS) {
    const int r = u / width, j = u % width;
    float v = dst[r * stride + j];
    if (!local) {
      v = recv[r * RM + j];
      for (int p = 1; p < C; ++p) v += recv[(p * BM + r) * RM + j];
    }
    if (r >= rows || (mask && !ste_pass(x_in[r * stride + j], x.quant, lo, hi, x.fxp32_phase1))) v = 0.0f;
    dst[r * stride + j] = v;
  }
  __syncthreads();
}

}  // namespace
}  // namespace fxp

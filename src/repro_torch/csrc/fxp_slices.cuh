// The weight-split cluster code shared by kernel B (fxp_mlp_fwd.cu) and
// kernels 4 and 5 (fxp_ddpg_step.cu): a layer's W slice per block of a
// thread-block cluster (its width, its tensor boxes and their map), the
// resident slice's loads (bulk tensor copies on an mbarrier, or 4-byte
// asynchronous copies), and the column-split MAC (one fmaf chain per output
// in k order per limb).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <mutex>

namespace fxp {
namespace {  // internal to each file that includes it, as the code it replaced

__host__ __device__ __forceinline__ int slice_width(int d, int c) { return ((d + c - 1) / c + 3) / 4 * 4; }

// A column-split slice loads as ⌈K/256⌉ tensor boxes of tma_rows(K) rows
// (a multiple of 8, so every box lands 128-byte aligned).
__host__ __device__ __forceinline__ int tma_boxes(int k) { return (k + 255) / 256; }
__host__ __device__ __forceinline__ int tma_rows(int k) { return ((k + tma_boxes(k) - 1) / tma_boxes(k) + 7) / 8 * 8; }

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Issue the bulk copies of layer l's resident slice (called by one warp):
// a K-split slice is contiguous rows of W, one copy; a column-split slice is
// a K × sw(N) window of W, ⌈K/256⌉ 2-D tensor boxes (columns past N and
// rows past K arrive as zeros).  `a`: a net's layers (w, dims, ksplit).
template <class Layers>
__device__ void load_slice_bulk(const Layers& a, const CUtensorMap* map, int l, int q, int C, float* ws,
                                unsigned long long* bar, int lane) {
  const int K = a.dims[l], N = a.dims[l + 1];
  if (a.ksplit[l]) {
    const int s = slice_width(K, C), klo = q * s, kn = max(0, min(s, K - klo));
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(kn * N * 4)
                   : "memory");
      if (kn > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                smem_u32(ws)),
            "l"(a.w[l] + (size_t)klo * N), "r"(kn * N * 4), "r"(smem_u32(bar))
            : "memory");
    }
    return;
  }
  const int s = slice_width(N, C), nlo = q * s;
  const int boxes = nlo < N ? tma_boxes(K) : 0, rows = tma_rows(K);
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(boxes * rows * s * 4)
                 : "memory");
  __syncwarp();
  if (lane < boxes)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
        "[%4];\n" ::"r"(smem_u32(ws + (size_t)lane * rows * s)),
        "l"(reinterpret_cast<unsigned long long>(map)), "r"(nlo), "r"(lane * rows), "r"(smem_u32(bar))
        : "memory");
}

// Copy layer l's resident slice with 4-byte asynchronous copies (W not fit
// for bulk copies); each thread waits for its own before the layer's
// cluster barrier.  Columns past N arrive as zeros, as from a tensor box.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

template <int THREADS, class Layers>
__device__ void load_slice_plain(const Layers& a, int l, int q, int C, float* ws) {
  const int K = a.dims[l], N = a.dims[l + 1];
  const float* w = a.w[l];
  if (a.ksplit[l]) {
    const int s = slice_width(K, C), klo = q * s, kn = max(0, min(s, K - klo));
    for (int e = threadIdx.x; e < kn * N; e += THREADS) cp_async4(ws + e, w + (size_t)klo * N + e, true);
  } else {
    const int s = slice_width(N, C), nlo = q * s;
    if (nlo >= N) return;
    for (int e = threadIdx.x; e < K * s; e += THREADS) {
      const int k = e / s, c = e % s;
      cp_async4(ws + e, nlo + c < N ? w + (size_t)k * N + nlo + c : w, nlo + c < N);
    }
  }
}

// Column-split MAC: TR rows r0.. of the block, output column c of the
// slice; each output one fmaf chain in k order per limb.  The limbs are
// read four k at a time (one float4 per row and limb).
template <int TR, bool RESIDENT>
__device__ __forceinline__ void col_mac(const float* hi, const float* lo, int kmax, int K, const float* wp,
                                        int w_stride, int c, bool quant, float (&ah)[TR], float (&al)[TR]) {
#pragma unroll
  for (int i = 0; i < TR; ++i) ah[i] = al[i] = 0.0f;
  auto wload = [&](int k) { return RESIDENT ? wp[k * w_stride + c] : __ldg(wp + (size_t)k * w_stride + c); };
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= K; k += 4) {
    const float w0 = wload(k), w1 = wload(k + 1), w2 = wload(k + 2), w3 = wload(k + 3);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 h = *reinterpret_cast<const float4*>(hi + i * kmax + k);
      ah[i] = fmaf(h.w, w3, fmaf(h.z, w2, fmaf(h.y, w1, fmaf(h.x, w0, ah[i]))));
      if (!quant) {
        const float4 l = *reinterpret_cast<const float4*>(lo + i * kmax + k);
        al[i] = fmaf(l.w, w3, fmaf(l.z, w2, fmaf(l.y, w1, fmaf(l.x, w0, al[i]))));
      }
    }
  }
  for (; k < K; ++k) {
    const float wv = wload(k);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      ah[i] = fmaf(hi[i * kmax + k], wv, ah[i]);
      if (!quant) al[i] = fmaf(lo[i * kmax + k], wv, al[i]);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of W (K, N) in boxes of sw(N) columns × tma_rows(K) rows,
// encoded once per (W, K, N, C) and kept.  Returns 0 or an error code.
int weight_map(CUtensorMap* out, const float* w, int K, int N, int C) {
  struct Entry {
    const float* w;
    int K, N, C;
    CUtensorMap map;
  };
  static Entry cache[64];
  static int n_cache = 0, next = 0;
  static EncodeTiled encode = nullptr;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i)
    if (cache[i].w == w && cache[i].K == K && cache[i].N == N && cache[i].C == C) {
      *out = cache[i].map;
      return 0;
    }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)slice_width(N, C), (cuuint32_t)tma_rows(K)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims, strides, box,
                             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const int slot = n_cache < 64 ? n_cache++ : (next++ % 64);
  cache[slot] = {w, K, N, C, *out};
  return 0;
}

}  // namespace
}  // namespace fxp

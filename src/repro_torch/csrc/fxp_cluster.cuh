// Host-side launch of a kernel as thread-block clusters (sm_90), shared by
// kernel A (fxp_dense.cu) and kernel B (fxp_mlp_fwd.cu).
//
// `launch_cluster` launches with `cudaLaunchKernelEx` and the cluster
// dimension attribute.  The first time it meets a (kernel, cluster size,
// dynamic shared memory) triple it raises the kernel's dynamic
// shared-memory limit to what a block's maximum leaves beside the
// kernel's static shared memory, allows non-portable cluster
// sizes (> 8), and asks `cudaOccupancyMaxActiveClusters` whether the
// shape can be scheduled at all; a shape that cannot returns
// kErrClusterUnschedulable, and the Python wrapper raises with
// `error_string`'s reason.  Nothing falls back to another design.  The
// triples seen are cached, so after one eager launch a captured CUDA graph
// makes no attribute or occupancy call.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <utility>

namespace fxp {

constexpr int kMaxSmem = 232448;  // a block's shared-memory limit on sm_90
constexpr int kErrClusterUnschedulable = 0x10001;

inline const char* error_string(int code) {
  if (code == kErrClusterUnschedulable)
    return "thread-block cluster shape cannot be scheduled on this device "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString((cudaError_t)code);
}

// Runs `check()` the first time (fn, cluster, smem) is met; 0 after that.
template <typename F>
int check_once(const void* fn, int cluster, size_t smem, F check) {
  struct Key {
    const void* fn;
    int cluster;
    size_t smem;
  };
  static Key seen[128];
  static int n_seen = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].cluster == cluster && seen[i].smem == smem) return 0;
  const int rc = check();
  if (rc == 0 && n_seen < 128) seen[n_seen++] = {fn, cluster, smem};
  return rc;
}

template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem, dim3 cluster,
                   cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int size = (int)(cluster.x * cluster.y * cluster.z);
  const int rc = check_once((const void*)kernel, size, smem, [&]() -> int {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    return n < 1 ? kErrClusterUnschedulable : 0;
  });
  if (rc != 0) {
    cudaGetLastError();  // a refused set-up call must not surface at the next launch
    return rc;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace fxp

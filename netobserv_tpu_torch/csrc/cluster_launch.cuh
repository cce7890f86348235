// The launch of a kernel as thread-block clusters (kernel 2,
// topk_reduce.cu, and the launch floor, launch_floor.cu). Needs sm_90.

#pragma once

#include <cuda_runtime.h>

// Launch `kernel` as `clusters` thread-block clusters of `cluster` CTAs on
// `stream`, with `smem` bytes of dynamic shared memory per CTA. Sets the
// function attributes the shape needs first (dynamic shared memory past
// 48 KiB; a cluster past the portable 8 CTAs) and returns the first error.
template <typename... Params, typename... Args>
static inline cudaError_t launch_clusters(void (*kernel)(Params...),
                                          int clusters, int cluster,
                                          int threads, size_t smem,
                                          cudaStream_t stream,
                                          Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

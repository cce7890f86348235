// The launch floor of a kernel: an empty kernel launched at a given grid,
// cluster (1: a plain launch), block and dynamic shared memory, optionally
// with cluster barriers (kernel 2, topk_reduce.cu, takes two per slot
// tile). Its device time is the least any kernel of that shape can take;
// chip_smoke.py prints it beside every kernel's byte bound (for kernel 6,
// the sum over its four launches). No path of the port launches it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

__global__ void launch_floor_kernel(int syncs) {
  for (int i = 0; i < syncs; ++i) cg::this_cluster().sync();
}

extern "C" int launch_floor(int clusters, int cluster, int threads, int smem,
                            int syncs, cudaStream_t stream) {
  if (cluster > 1) {
    cudaError_t err = launch_clusters(launch_floor_kernel, clusters, cluster,
                                      threads, (size_t)smem, stream, syncs);
    if (err != cudaSuccess) return (int)err;
  } else if (syncs == 0) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          launch_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return (int)err;
    }
    launch_floor_kernel<<<clusters, threads, smem, stream>>>(0);
  } else {
    return (int)cudaErrorInvalidValue;  // barriers need a cluster
  }
  return (int)cudaGetLastError();
}

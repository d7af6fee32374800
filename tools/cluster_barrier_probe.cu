// The cost of one thread-block cluster barrier (cooperative_groups'
// cluster.sync(): barrier.cluster.arrive.release + wait.acquire) on the
// card, against a CTA barrier, for the cluster sizes the banded solve
// (csrc/banded_ldlt.cu) may launch.  One cluster of C CTAs of 512 threads
// runs 1010 and then 10 barriers; the difference over 1000 is the time of
// one.  remote = 0: the barrier alone; 1: first every warp's lanes ℓ < C
// store one value into CTA ℓ's shared memory (the stores a forward step of
// the banded solve makes); 2: 16 threads store into every CTA (a backward
// step's); 3: __syncthreads() in place of the cluster barrier.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/cluster_barrier_probe \
//        tools/cluster_barrier_probe.cu && build/cluster_barrier_probe
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdio.h>
namespace cg = cooperative_groups;
__global__ void bar_kernel(int iters, int remote, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float buf[1024];
  const int C = cluster.num_blocks();
  cluster.sync();
  float* at = cluster.map_shared_rank(buf, (threadIdx.x % 32) % C);
  float acc = 0;
  for (int i = 0; i < iters; ++i) {
    if (remote == 1 && (threadIdx.x % 32) < C) at[threadIdx.x / 32 + (i & 1) * 512] = (float)i;
    if (remote == 2 && threadIdx.x < 16) for (int r = 0; r < C; ++r) cluster.map_shared_rank(buf, r)[threadIdx.x + (i & 1) * 512] = (float)i;
    if (remote == 3) __syncthreads(); else cluster.sync();
    acc += buf[(threadIdx.x + i) % 1024];
  }
  if (acc == 12345.f) out[0] = acc;
}
int main() {
  float* out; cudaMalloc(&out, 4);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  for (int C : {1, 2, 4, 8, 16}) for (int remote : {0, 1, 2, 3}) {
    cudaFuncSetAttribute(bar_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchAttribute attr; attr.id = cudaLaunchAttributeClusterDimension; attr.val.clusterDim.x = C; attr.val.clusterDim.y = 1; attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(C); cfg.blockDim = dim3(512); cfg.attrs = &attr; cfg.numAttrs = 1;
    float ms[2];
    for (int k = 0; k < 2; ++k) {
      int iters = k == 0 ? 10 : 1010;
      cudaLaunchKernelEx(&cfg, bar_kernel, iters, remote, out);
      cudaEventRecord(a); cudaLaunchKernelEx(&cfg, bar_kernel, iters, remote, out); cudaEventRecord(b); cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms[k], a, b);
    }
    printf("C=%d remote=%d  us per barrier %.3f  (launch+10: %.1f us) err=%s\n", C, remote, (ms[1] - ms[0]) * 1000 / 1000, ms[0] * 1000, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}

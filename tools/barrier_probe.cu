// Barrier latency on one card, for the design of K1 (piece_starts.cu):
// a cooperative grid barrier over every co-resident block against a
// thread-block cluster barrier, at one and two blocks per SM, and how
// many clusters of 8 and 16 blocks the card holds at once. Built and run
// by tools/barrier_probe.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

// dynamic shared memory (unused) sets the blocks per SM
__global__ void grid_barriers(int rounds, unsigned* sink) {
  for (int r = 0; r < rounds; ++r) cg::this_grid().sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) *sink = rounds;
}

__global__ void cluster_barriers(int rounds, unsigned* sink) {
  cg::cluster_group c = cg::this_cluster();
  for (int r = 0; r < rounds; ++r) c.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) *sink = rounds;
}

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::printf("%s: %s\n", #x, cudaGetErrorString(e_));              \
      return 1;                                                         \
    }                                                                   \
  } while (0)

int main() {
  int sms = 0;
  CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  int rounds = 20000;
  unsigned* sink;
  CHECK(cudaMalloc(&sink, sizeof(unsigned)));
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  CHECK(cudaFuncSetAttribute(grid_barriers,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             200 * 1024));
  CHECK(cudaFuncSetAttribute(cluster_barriers,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             200 * 1024));
  CHECK(cudaFuncSetAttribute(cluster_barriers,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1));
  // (threads, dynamic shared memory): one block per SM, then two
  const int shapes[2][2] = {{1024, 150 * 1024}, {512, 100 * 1024}};
  for (const auto& sh : shapes) {
    const int threads = sh[0];
    const size_t smem = sh[1];
    int per = 0;
    CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, grid_barriers,
                                                        threads, smem));
    const int blocks = sms * per;
    void* args[] = {&rounds, &sink};
    float ms = 0.f;
    for (int rep = 0; rep < 2; ++rep) {  // the first is a warm-up
      CHECK(cudaEventRecord(a));
      CHECK(cudaLaunchCooperativeKernel((const void*)grid_barriers,
                                        dim3(blocks), dim3(threads), args,
                                        smem, 0));
      CHECK(cudaEventRecord(b));
      CHECK(cudaEventSynchronize(b));
      CHECK(cudaEventElapsedTime(&ms, a, b));
    }
    std::printf("grid barrier: %d blocks of %d threads (%d per SM): "
                "%.4f us per barrier\n",
                blocks, threads, per, ms * 1e3 / rounds);
    for (int cs : {8, 16}) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = cs;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      cfg.gridDim = dim3(cs);
      int fit = 0;
      const cudaError_t q =
          cudaOccupancyMaxActiveClusters(&fit, cluster_barriers, &cfg);
      if (q != cudaSuccess || fit == 0) {
        std::printf("cluster barrier: size %d with %d threads: no cluster "
                    "fits (%s)\n",
                    cs, threads, cudaGetErrorString(q));
        cudaGetLastError();
        continue;
      }
      cfg.gridDim = dim3(fit * cs);
      for (int rep = 0; rep < 2; ++rep) {
        CHECK(cudaEventRecord(a));
        CHECK(cudaLaunchKernelEx(&cfg, cluster_barriers, rounds, sink));
        CHECK(cudaEventRecord(b));
        CHECK(cudaEventSynchronize(b));
        CHECK(cudaEventElapsedTime(&ms, a, b));
      }
      std::printf("cluster barrier: size %d, %d clusters fit at once (%d "
                  "blocks of %d threads): %.4f us per barrier\n",
                  cs, fit, fit * cs, threads, ms * 1e3 / rounds);
    }
  }
  return 0;
}

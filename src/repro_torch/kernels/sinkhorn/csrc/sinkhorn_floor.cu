// The Sinkhorn kernel's exchanges alone, sm_90a: two trivial kernels that
// chain `steps` dependent half-steps with no arithmetic beyond a combine,
// so their time is a floor under the kernel's 2 * n_iters half-steps at
// the same launch shape (chip_smoke.py's [sinkhorn] floor lines).
//
// * team_floor_kernel: one block of `warps` warps; a step is a 5-shuffle
//   warp sum (when `shuffle` is set), a partial per lane to shared memory,
//   one named barrier over the block and every warp reading the warps'
//   partials, as a team half-step does (which has no shuffle).
// * cluster_floor_kernel: one cluster of the plan's shape; a step is warp
//   w < rows of each block pushing one value into every block by st.async
//   on that block's mbarrier, and every block waiting for R values, as a
//   cluster half-step does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCycles = 1023;   // out[kCycles]: the steps' SM clock cycles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(128)
team_floor_kernel(float* __restrict__ out, int steps, int shuffle) {
  __shared__ float part[2][4][32];         // by step parity, as the team
  const int nw = blockDim.x >> 5, q = threadIdx.x >> 5, l = threadIdx.x & 31;
  const long long t0 = clock64();
  float v = 1e-3f * (float)threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    if (shuffle)
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    part[s & 1][q][l] = v;
    asm volatile("bar.sync 1, %0;\n" :: "r"(nw * 32) : "memory");
    float m = part[s & 1][0][l];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, part[s & 1][w][l]);
    v = 0.5f * m;
  }
  out[threadIdx.x] = v;
  if (threadIdx.x == 0) out[kCycles] = (float)(clock64() - t0);
}

__global__ void __launch_bounds__(1024)
cluster_floor_kernel(float* __restrict__ out, int r, int steps, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lo = rank * span, rows = min(span, r - lo);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + 16);        // [2][r]
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&bar[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int x = threadIdx.x; x < 2 * r; x += blockDim.x) buf[x] = 0.0f;
  cluster.sync();
  const long long t0 = clock64();
  float v = 1e-3f * (float)(lo + w);
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1, prev = cur ^ 1;
    if (s > 0) {
      bar_wait(&bar[prev], (uint32_t)((s - 1) >> 1) & 1u);
      v = 0.5f * (v + buf[prev * r + (lo + w + 1) % r]);
    }
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(&bar[cur])), "r"(4 * r) : "memory");
    if (w < rows && l < C) {
      uint32_t rs, rb;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(rs) : "r"(smem_u32(&buf[cur * r + lo + w])),
                     "r"((unsigned)l));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(rb) : "r"(smem_u32(&bar[cur])), "r"((unsigned)l));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
          "[%0], %1, [%2];\n"
          :: "r"(rs), "r"(__float_as_uint(v)), "r"(rb) : "memory");
    }
  }
  if (steps > 0)
    bar_wait(&bar[(steps - 1) & 1], (uint32_t)((steps - 1) >> 1) & 1u);
  if (w < rows && l == 0) out[lo + w] = v;
  if (rank == 0 && threadIdx.x == 0) out[kCycles] = (float)(clock64() - t0);
  cluster.sync();
}

}  // namespace

extern "C" {

// One block of `warps` warps chaining `steps` team steps; out: 1024 floats,
// the steps' clock cycles (block 0, thread 0) at out[1023].
int sinkhorn_team_floor(float* out, int warps, int steps, int shuffle,
                        void* stream) {
  if (warps < 1 || warps > 4) return (int)cudaErrorInvalidValue;
  team_floor_kernel<<<1, 32 * warps, 0, (cudaStream_t)stream>>>(out, steps,
                                                                 shuffle);
  return (int)cudaGetLastError();
}

// One cluster of `cluster` blocks of `threads` threads, block b owning
// `span` of R < 1023 values, chaining `steps` exchanges; out: 1024 floats,
// the steps' clock cycles at out[1023].
int sinkhorn_cluster_floor(float* out, int r, int steps, int threads,
                           int cluster, int span, void* stream) {
  if (cluster < 1 || cluster > 16 || span < 1 || cluster * span < r ||
      r >= kCycles || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  auto fn = cluster_floor_kernel;
  const size_t smem = 16 + 8 * (size_t)r;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, out, r, steps, span);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"

// Batched log-domain entropic OT (Sinkhorn) for the macro layer, sm_90a.
//
// Replaces: src/repro/kernels/sinkhorn/kernel.py:50 sinkhorn_batched
// (Pallas body _kernel at :20).  Same iteration, the Pallas formula:
//   t1 = mk + g/reg;  f = reg*(logmu - (max_j t1 + log sum_j exp(t1 - max)))
//   t2 = mk + f/reg;  g = reg*(lognu - (max_i t2 + log sum_i exp(t2 - max)))
//   plan = exp(mk + (f_i + g_j)/reg),  mk = -cost/reg,
// for a fixed number of iterations.
//
// What bounds it on the H100: latency.  One problem is an R x R tile with
// R <= 32 (25 on the main path), so the whole input is a few KB and the
// arithmetic is a few hundred thousand flops; what costs time is the
// chain of 2 * n_iters dependent logsumexp half-steps, each a
// reduction followed by a block barrier.
//
// Design: one block per problem, one warp per row (R warps).  The -cost/reg
// tile lives in shared memory, padded to 33 columns so the transposed
// (column) reads hit distinct banks, together with f and g.  Row
// reductions are warp shuffles over the lanes of a row; column
// reductions read the tile transposed (warp w owns column w, lane i reads
// row i) and reduce with the same shuffles.  All iterations run inside
// the block; nothing but the inputs and the plan touches device memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxR = 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kMaxR * 32)
sinkhorn_kernel(const float* __restrict__ mu, const float* __restrict__ nu,
                const float* __restrict__ cost, float* __restrict__ plan,
                int r, int n_iters, float reg) {
  __shared__ float mk[kMaxR][kMaxR + 1];
  __shared__ float f[kMaxR];
  __shared__ float g[kMaxR];
  const int b = blockIdx.x;
  const int w = threadIdx.x >> 5;      // row (row phase) / column (col phase)
  const int l = threadIdx.x & 31;      // column (row phase) / row (col phase)
  const bool lane_ok = l < r;
  const float* c = cost + (size_t)b * r * r;
  if (lane_ok) mk[w][l] = -c[w * r + l] / reg;
  if (l == 0) {
    f[w] = 0.0f;
    g[w] = 0.0f;
  }
  const float logmu = logf(fmaxf(mu[b * r + w], 1e-30f));
  const float lognu = logf(fmaxf(nu[b * r + w], 1e-30f));
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // rows: warp w reduces row w over its lanes
    float t = lane_ok ? mk[w][l] + g[l] / reg : -INFINITY;
    float m = warp_max(t);
    float s = warp_sum(lane_ok ? expf(t - m) : 0.0f);
    if (l == 0) f[w] = reg * (logmu - (m + logf(s)));
    __syncthreads();
    // columns: warp w reduces column w, reading the tile transposed
    t = lane_ok ? mk[l][w] + f[l] / reg : -INFINITY;
    m = warp_max(t);
    s = warp_sum(lane_ok ? expf(t - m) : 0.0f);
    if (l == 0) g[w] = reg * (lognu - (m + logf(s)));
    __syncthreads();
  }
  if (lane_ok)
    plan[(size_t)b * r * r + w * r + l] = expf(mk[w][l] + (f[w] + g[l]) / reg);
}

}  // namespace

// mu, nu: (B, R); cost: (B, R, R); plan: (B, R, R); all float32,
// contiguous, on the device.  Returns the launch's cudaError_t.
extern "C" int sinkhorn_launch(const float* mu, const float* nu,
                               const float* cost, float* plan, int b, int r,
                               int n_iters, float reg, void* stream) {
  if (b <= 0) return 0;
  if (r < 1 || r > kMaxR) return (int)cudaErrorInvalidValue;
  sinkhorn_kernel<<<b, r * 32, 0, (cudaStream_t)stream>>>(
      mu, nu, cost, plan, r, n_iters, reg);
  return (int)cudaGetLastError();
}

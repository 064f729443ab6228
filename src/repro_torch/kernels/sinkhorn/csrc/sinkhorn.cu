// Batched log-domain entropic OT (Sinkhorn) for the macro layer, sm_90a.
//
// Replaces: src/repro/kernels/sinkhorn/kernel.py:50 sinkhorn_batched
// (Pallas body _kernel at :20).  Same iteration, the Pallas formula:
//   t1 = mk + g/reg;  f = reg*(logmu - (max_j t1 + log sum_j exp(t1 - max)))
//   t2 = mk + f/reg;  g = reg*(lognu - (max_i t2 + log sum_i exp(t2 - max)))
//   plan = exp(mk + (f_i + g_j)/reg),  mk = -cost/reg,
// for a fixed number of iterations, for any number of regions R.
//
// What bounds it on the H100: latency.  One problem is an R x R tile (25
// on the main path, 200 on the fused route's largest fleet), a few KB to
// a few hundred KB, and the arithmetic is 2 * n_iters dependent
// logsumexp half-steps, each a reduction followed by a block barrier.
//
// Design: one block per problem, min(R, 32) warps (ops.launch_plan).
// Warp w reduces rows w, w + nwarps, ...: each lane first folds columns
// l, l + 32, ... (the max, then the sum of exp(t - max)), keeping its
// terms in registers, then the warp adds its lanes by the same shuffle
// tree for every R.  Columns are reduced the same way, reading the tile
// transposed.  For R <= 32 each lane holds one element, so the
// arithmetic and its order are those of the one-warp-a-row kernel this
// one replaced.  Past 32 regions the lane that writes f_k (or g_k) also
// writes f_k / reg, the value every term of the next half-step adds, so
// no term divides.
// The -cost/reg tile lives in dynamic shared memory, its rows padded to
// an odd stride of at least R + 1 floats (ld) so the transposed reads hit
// distinct banks, while it fits a block's 232,448 bytes with f, g, f/reg
// and g/reg (R <= 238); beyond that the kernel recomputes -cost/reg from
// device memory, where the tile stays L2-resident, and gets the same
// bits.  Nothing but the inputs and the plan touches device memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;       // 32 warps
constexpr int kMaxColumns = 8;          // a lane's terms, shared tile

// Row stride of the shared tile: the least odd number above R, so lane
// l's element of a column sits in bank (l * ld + j) % 32, distinct for
// the 32 lanes.
__host__ __device__ __forceinline__ int tile_ld(int r) {
  return (r + 1) | 1;
}

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

// -cost/reg at (i, j): from the shared tile (kShared) or recomputed from
// the problem's cost in device memory.
template <bool kShared>
struct Tile {
  const float* mk;      // shared, r x ld
  const float* c;       // device, r x r
  int r, ld;
  float reg;
  __device__ __forceinline__ float operator()(int i, int j) const {
    if constexpr (kShared) return mk[i * ld + j];
    else return -c[i * r + j] / reg;
  }
};

// logsumexp half-step: warp w sets out[k] = reg * (log m_k - lse_k) for
// its rows k = w + nwarps kk, where lse_k runs over x of mk(k, x) +
// in[x] / reg (rows) or mk(x, k) + in[x] / reg (columns, the tile read
// transposed).  A lane holds the terms of its columns x = l, l + 32, ...:
// up to NPL of them in registers (NPL = 1 for R <= 32, 8 for the shared
// tile), with its warp's rows' log m_k (logm[kk]); with NPL = 0 (the tile
// in device memory) it recomputes the terms in a second pass and log m_k
// from `marg`.  Past R = 32 the writer of out[k] also writes out_s[k] =
// out[k] / reg, which the next half-step's terms read (in_s) instead of
// dividing R times; at R <= 32 a term divides, as the one-warp-a-row
// kernel did.  Both give the same bits.
template <bool kShared, bool kRows, int NPL>
__device__ __forceinline__ void half_step(const Tile<kShared>& mk,
                                          const float* in, const float* in_s,
                                          const float* marg,
                                          const float (&logm)[NPL ? NPL : 1],
                                          float* out, float* out_s, int r,
                                          float reg) {
  constexpr bool kScaled = NPL != 1;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, l = threadIdx.x & 31;
  auto term = [&](int k, int x) {
    return (kRows ? mk(k, x) : mk(x, k)) + (kScaled ? in_s[x] : in[x] / reg);
  };
  auto finish = [&](int k, float m, float s, float lm) {
    s = warp_sum(s);
    if (l == 0) {
      const float v = reg * (lm - (m + logf(s)));
      out[k] = v;
      if (kScaled) out_s[k] = v / reg;
    }
  };
  if constexpr (NPL > 0) {
#pragma unroll
    for (int kk = 0; kk < NPL; ++kk) {
      const int k = w + nw * kk;
      // at R <= 32 warp w's one row is w < R: no branch, so the shuffles
      // stay in straight-line code, as in the one-warp-a-row kernel
      if (NPL > 1 && k >= r) break;
      float t[NPL], m = -INFINITY, s = 0.0f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int x = l + 32 * j;
        t[j] = x < r ? term(k, x) : -INFINITY;
        m = fmaxf(m, t[j]);
      }
      m = warp_max(m);
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        if (l + 32 * j < r) s += expf(t[j] - m);
      finish(k, m, s, logm[kk]);
    }
  } else {
    for (int k = w; k < r; k += nw) {
      float m = -INFINITY, s = 0.0f;
      for (int x = l; x < r; x += 32) m = fmaxf(m, term(k, x));
      m = warp_max(m);
      for (int x = l; x < r; x += 32) s += expf(term(k, x) - m);
      finish(k, m, s, logf(fmaxf(marg[k], 1e-30f)));
    }
  }
}

template <bool kShared, int NPL>
__global__ void __launch_bounds__(kMaxThreads)
sinkhorn_kernel(const float* __restrict__ mu, const float* __restrict__ nu,
                const float* __restrict__ cost, float* __restrict__ plan,
                int r, int n_iters, float reg) {
  extern __shared__ float smem[];
  float* f = smem;
  float* g = f + r;
  float* f_s = g + r;                   // f / reg
  float* g_s = f_s + r;                 // g / reg
  float* mk_s = g_s + r;                // r x ld when kShared
  const int b = blockIdx.x, ld = tile_ld(r);
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5;
  const float* c = cost + (size_t)b * r * r;
  mu += b * r;
  nu += b * r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    f[i] = 0.0f;
    g[i] = 0.0f;
    f_s[i] = 0.0f;
    g_s[i] = 0.0f;
  }
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < r * r; i += blockDim.x)
      mk_s[(i / r) * ld + i % r] = -c[i] / reg;
  }
  float logmu[NPL ? NPL : 1], lognu[NPL ? NPL : 1];   // the warp's rows
#pragma unroll
  for (int kk = 0; kk < NPL; ++kk) {
    const int k = w + nw * kk;
    logmu[kk] = k < r ? logf(fmaxf(mu[k], 1e-30f)) : 0.0f;
    lognu[kk] = k < r ? logf(fmaxf(nu[k], 1e-30f)) : 0.0f;
  }
  __syncthreads();
  const Tile<kShared> mk{mk_s, c, r, ld, reg};

  for (int it = 0; it < n_iters; ++it) {
    half_step<kShared, true, NPL>(mk, g, g_s, mu, logmu, f, f_s, r, reg);
    __syncthreads();
    half_step<kShared, false, NPL>(mk, f, f_s, nu, lognu, g, g_s, r, reg);
    __syncthreads();
  }
  float* p = plan + (size_t)b * r * r;
  for (int i = threadIdx.x; i < r * r; i += blockDim.x) {
    const int row = i / r, col = i % r;
    p[i] = expf(mk(row, col) + (f[row] + g[col]) / reg);
  }
}

template <bool kShared, int NPL>
cudaError_t launch(const float* mu, const float* nu, const float* cost,
                   float* plan, int b, int r, int n_iters, float reg,
                   int threads, int smem, cudaStream_t stream) {
  auto fn = sinkhorn_kernel<kShared, NPL>;
  static int allowed = 48 * 1024;       // dynamic shared bytes admitted
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  fn<<<b, threads, smem, stream>>>(mu, nu, cost, plan, r, n_iters, reg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared bytes of a block at R with the tile in shared memory
// (shared != 0) or in device memory (ops.launch_plan's smem): f, g, f/reg
// and g/reg, and the padded tile.
int sinkhorn_smem_bytes(int r, int shared) {
  return (int)sizeof(float) * (4 * r + (shared ? r * tile_ld(r) : 0));
}

// mu, nu: (B, R); cost: (B, R, R); plan: (B, R, R); all float32,
// contiguous, on the device.  threads, smem and shared are
// ops.launch_plan(R)'s.  Returns the launch's cudaError_t.
int sinkhorn_launch(const float* mu, const float* nu, const float* cost,
                    float* plan, int b, int r, int n_iters, float reg,
                    int threads, int smem, int shared, void* stream) {
  if (b <= 0) return 0;
  if (r < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      smem != sinkhorn_smem_bytes(r, shared))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!shared)
    return (int)launch<false, 0>(mu, nu, cost, plan, b, r, n_iters, reg,
                                 threads, smem, st);
  if (r <= 32)
    return (int)launch<true, 1>(mu, nu, cost, plan, b, r, n_iters, reg,
                                threads, smem, st);
  if (r <= 32 * kMaxColumns)
    return (int)launch<true, kMaxColumns>(mu, nu, cost, plan, b, r, n_iters,
                                          reg, threads, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

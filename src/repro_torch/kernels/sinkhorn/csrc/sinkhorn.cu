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
// on the main path, 200 on the fused route's largest fleet), and the
// arithmetic is 2 * n_iters dependent logsumexp half-steps, each a
// reduction followed by an exchange of its R results.
//
// What every half-step carries is X = f/reg (or g/reg), the bracket of
// the formula, so no term divides; f = reg X where the plan needs it.  A
// lane's terms are held in registers and folded branch-free (padding is a
// -inf term) as trees, so their exps overlap; the half-steps' exp and log
// are __expf and __logf (ex2.approx, lg2.approx; the set-up and the plan
// keep expf and logf).  ops.launch_plan picks one of two forms from B
// and R, whichever the card ran faster:
//
// * a team (R = 1, or R <= 32 when the clusters of the B problems would
//   have more blocks than the card has SMs; at R <= 32 any team size may
//   be forced): one block of up to four warps a problem, one a
//   scheduler partition.  Lane i owns row i (row half-step) or column i
//   (column half-step); warp q takes the q-th chunk of the other index,
//   with its -cost/reg terms in registers, and writes a partial (max,
//   sum of exp(t - max)) per row to shared memory.  One named barrier
//   over the team; then every warp merges the partials itself in warp
//   order, each sum rescaled by exp(m_q - m), so every warp holds the new
//   X with no second barrier and keeps its own copy of it for the next
//   half-step (ordered by __syncwarp).  No shuffle on the critical path.
// * a thread-block cluster (every other shape): C blocks a problem (up
//   to 16, each owning span rows and columns [b span, (b + 1) span), by
//   default span = min(max(ceil(R / 16), 8), R)), a warp a
//   row (or column).  Lane l folds the terms x = l, l + 32, ...; the
//   warp's max is one redux on order-preserving integers and its sum one
//   redux in fixed point (warp_sum).  Lanes d < C push the row's X into
//   block d of the cluster by st.async, completing 4 bytes on that
//   block's mbarrier for the half-step; each block waits on its own
//   mbarrier for the cluster's R values.  No cluster barrier a half-step.
//   -cost/reg lives in registers (R <= 256, a row and a column a warp),
//   else in two shared-memory slabs (the block's rows, and its columns
//   transposed), else, past what a block holds, in a device workspace the
//   kernel fills with the same slabs (L2-resident).
//
// Every sum is taken in a fixed order (or exactly, in integers) and no
// atomic decides one, so two calls give the same bits.  Nothing but the
// inputs, the plan and the device-slab workspace touches device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTeamWarps = 4;
constexpr int kTeamMaxR = 32;
constexpr int kMaxCluster = 16;
constexpr int kRegTerms = 8;            // a lane's terms in registers, at most
enum Slab { kRegisters = 0, kShared = 1, kDevice = 2 };

__device__ __forceinline__ float log_marg(float v) {
  return logf(fmaxf(v, 1e-30f));
}

// float <-> int with the same order (for every non-NaN value), so that a
// warp's max is one redux
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float warp_max(float v) {
  const int m = __reduce_max_sync(0xffffffffu, ordered(v));
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// The warp's sum of its lanes' v in fixed point: each v (at most n, the
// lane's terms, each an exp(t - max) <= 1) rounded to a multiple of 2^-k,
// k = 26 - ceil(log2 n), so that the 32 lanes' sum stays below 2^31, then
// added exactly by one integer redux.  The sum is at least 1 (the max
// term), so its relative error is under 32 * 2^-(k+1) <= 2^-(21-log2 n),
// and it takes one instruction and no order.
__device__ __forceinline__ float warp_sum(float v, int n) {
  const int k = 26 - (32 - __clz(n - 1));
  const unsigned q = __float2uint_rn(v * __int_as_float((127 + k) << 23));
  return (float)__reduce_add_sync(0xffffffffu, q)
         * __int_as_float((127 - k) << 23);
}

// Max and sum of a lane's N terms (N a power of two, padded with -inf
// and 0) as a tree of halves: log2(N) dependent steps instead of N.
template <int N>
__device__ __forceinline__ float tree_max(const float* t) {
  if constexpr (N == 1) return t[0];
  else return fmaxf(tree_max<N / 2>(t), tree_max<N / 2>(t + N / 2));
}

template <int N>
__device__ __forceinline__ float tree_sum(const float* t) {
  if constexpr (N == 1) return t[0];
  else return tree_sum<N / 2>(t) + tree_sum<N / 2>(t + N / 2);
}

__device__ __forceinline__ void team_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// ------------------------------------------------------------------ team

// Dynamic shared bytes of a team of `warps` warps: the partials
// [2][warps][32] (max, sum), then each warp's copies of X_f and X_g.
__host__ __device__ __forceinline__ int team_smem(int warps) {
  return warps * 32 * (2 * 8 + 2 * 4);
}

// One half-step of a team: lane l's new X over the terms mk[j] + in[x0 +
// j], j < nx, of its warp's chunk (kChunk >= nx, a power of two); a team
// of more than one warp merges the warps' partials of buffer `part` (the
// row half-steps use one buffer and the column half-steps the other, so a
// buffer is written again only after every warp has passed the next
// half-step's barrier): the max of the maxes, the sums rescaled by
// exp(m_q - m) and added as a tree.
template <int kChunk>
__device__ __forceinline__ float team_half(const float (&mk)[kChunk],
                                           const float* in, float lm,
                                           float2* part, int x0, int nx,
                                           int nw, int q, int l) {
  // branch-free: every load and exp is issued (the padding loads stay
  // inside the warp's 32-entry copy and give -inf terms, whose exp is 0),
  // so the exps overlap instead of waiting on one another
  float t[kChunk], e[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const float v = in[x0 + j];
    t[j] = j < nx ? mk[j] + v : -INFINITY;
  }
  const float m = tree_max<kChunk>(t);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) e[j] = __expf(t[j] - m);
  const float s = tree_sum<kChunk>(e);
  if (nw == 1) return lm - (m + __logf(s));
  part[q * 32 + l] = make_float2(m, s);
  team_barrier(nw * 32);
  float pm[kTeamWarps], ps[kTeamWarps];
#pragma unroll
  for (int w = 0; w < kTeamWarps; ++w) {
    const float2 v = part[min(w, nw - 1) * 32 + l];
    pm[w] = w < nw ? v.x : -INFINITY;
    ps[w] = w < nw ? v.y : 0.0f;
  }
  const float mm = tree_max<kTeamWarps>(pm);
#pragma unroll
  for (int w = 0; w < kTeamWarps; ++w) ps[w] *= __expf(pm[w] - mm);
  return lm - (mm + __logf(tree_sum<kTeamWarps>(ps)));
}

template <int kChunk>
__global__ void __launch_bounds__(kTeamWarps * 32)
team_kernel(const float* __restrict__ mu, const float* __restrict__ nu,
            const float* __restrict__ cost, float* __restrict__ plan, int r,
            int n_iters, float reg, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, q = threadIdx.x >> 5, l = threadIdx.x & 31;
  float2* part = reinterpret_cast<float2*>(smem);          // [2][nw][32]
  float* my_f = reinterpret_cast<float*>(part + 2 * nw * 32) + q * 32;
  float* my_g = my_f + nw * 32;
  const int b = blockIdx.x;
  const float* c = cost + (size_t)b * r * r;
  const int x0 = q * chunk, nx = min(chunk, r - x0);   // nx >= 1 by the plan
  // -cost/reg of this lane's row (mr) and column (mc) in the warp's chunk
  float mr[kChunk], mc[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const bool ok = l < r && j < nx;
    mr[j] = ok ? -c[l * r + x0 + j] / reg : 0.0f;
    mc[j] = ok ? -c[(x0 + j) * r + l] / reg : 0.0f;
  }
  const float lmu = l < r ? log_marg(mu[b * r + l]) : 0.0f;
  const float lnu = l < r ? log_marg(nu[b * r + l]) : 0.0f;
  my_f[l] = 0.0f;
  my_g[l] = 0.0f;
  __syncwarp();
  float xg = 0.0f;                        // X_g of column l
  for (int it = 0; it < n_iters; ++it) {
    my_f[l] = team_half(mr, my_g, lmu, part, x0, nx, nw, q, l);
    __syncwarp();
    xg = team_half(mc, my_f, lnu, part + nw * 32, x0, nx, nw, q, l);
    my_g[l] = xg;
    __syncwarp();
  }
  // lane l writes column l of the warp's rows x0 .. x0 + nx - 1
  float* p = plan + (size_t)b * r * r;
  if (l < r) {
    const float g = reg * xg;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < nx)
        p[(x0 + j) * r + l] = expf(mc[j] + (reg * my_f[x0 + j] + g) / reg);
  }
}

// --------------------------------------------------------------- cluster

// Dynamic shared bytes of a cluster block: the two mbarriers, X_f and X_g
// of all R regions, log mu and log nu of the block's span, and the two
// slabs (rows; columns transposed) when they live in shared memory.
__host__ __device__ __forceinline__ size_t cluster_smem(int r, int span,
                                                        int slab) {
  return 16 + 4 * (2 * (size_t)r + 2 * (size_t)span)
         + (slab == kShared ? 8 * (size_t)span * r : 0);
}

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

// Post the R * 4 bytes a half-step's values bring to this block.
__device__ __forceinline__ void bar_expect(uint64_t* bar, int r) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(4 * r) : "memory");
}

// Store v at `slot` of block `rank` of the cluster, completing 4 bytes on
// that block's `bar`.
__device__ __forceinline__ void send(const float* slot, uint64_t* bar,
                                     unsigned rank, float v) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rs) : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n"
      :: "r"(rs), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

// A warp's X of one row (or column): the terms mk + in[x] with mk from
// registers (mreg[j] at x = l + 32 j, j < kTerms) or from a slab's row
// (mrow[x]); lane l folds x = l, l + 32, ...
template <int kSlab, int kTerms>
__device__ __forceinline__ float cluster_row(const float (&mreg)[kTerms],
                                             const float* mrow,
                                             const float* in, float lm,
                                             int r, int l) {
  float m = -INFINITY, s = 0.0f;
  if constexpr (kSlab == kRegisters) {
    // branch-free, as a team's half-step (padding: in[r - 1], -inf terms)
    float t[kTerms], e[kTerms];
#pragma unroll
    for (int j = 0; j < kTerms; ++j) {
      const int x = l + 32 * j;
      const float v = in[min(x, r - 1)];
      t[j] = x < r ? mreg[j] + v : -INFINITY;
    }
    m = warp_max(tree_max<kTerms>(t));
#pragma unroll
    for (int j = 0; j < kTerms; ++j) e[j] = __expf(t[j] - m);
    s = warp_sum(tree_sum<kTerms>(e), kTerms);
  } else {
    for (int x = l; x < r; x += 32) m = fmaxf(m, mrow[x] + in[x]);
    m = warp_max(m);
    for (int x = l; x < r; x += 32) s += __expf(mrow[x] + in[x] - m);
    s = warp_sum(s, (r + 31) >> 5);
  }
  return lm - (m + __logf(s));
}

template <int kSlab, int kTerms>
__global__ void __launch_bounds__(1024)
cluster_kernel(const float* __restrict__ mu, const float* __restrict__ nu,
               const float* __restrict__ cost, float* __restrict__ plan,
               float* __restrict__ ws, int r, int n_iters, float reg,
               int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int lo = rank * span, rows = min(span, r - lo);   // rows >= 1
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, l = threadIdx.x & 31;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);      // X_f, X_g
  float* xf = reinterpret_cast<float*>(smem + 16);         // [r]
  float* xg = xf + r;                                      // [r]
  float* lm = xg + r;                                      // [2][span]
  // rows [span][r]: mk(lo + k, x); columns [span][r]: mk(x, lo + k)
  float* slab = kSlab == kShared   ? lm + 2 * span
                : kSlab == kDevice ? ws + (size_t)blockIdx.x * 2 * span * r
                                   : nullptr;
  const float* c = cost + (size_t)b * r * r;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&bar[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int x = threadIdx.x; x < r; x += blockDim.x) {
    xf[x] = 0.0f;
    xg[x] = 0.0f;
  }
  for (int k = threadIdx.x; k < rows; k += blockDim.x) {
    lm[k] = log_marg(mu[b * r + lo + k]);
    lm[span + k] = log_marg(nu[b * r + lo + k]);
  }
  float mr[kTerms], mc[kTerms];           // warp w's row and column lo + w
  if constexpr (kSlab == kRegisters) {
#pragma unroll
    for (int j = 0; j < kTerms; ++j) {
      const int x = l + 32 * j;
      const bool ok = w < rows && x < r;
      mr[j] = ok ? -c[(size_t)(lo + w) * r + x] / reg : 0.0f;
      mc[j] = ok ? -c[(size_t)x * r + lo + w] / reg : 0.0f;
    }
  } else {
    for (int e = threadIdx.x; e < rows * r; e += blockDim.x)
      slab[e] = -c[(size_t)lo * r + e] / reg;
    for (int e = threadIdx.x; e < rows * r; e += blockDim.x) {
      const int x = e / rows, k = e % rows;
      slab[(size_t)(span + k) * r + x] = -c[(size_t)x * r + lo + k] / reg;
    }
  }
  // every block of the cluster has set its mbarriers and zeroed X before
  // any value is pushed to it
  cluster.sync();

  for (int it = 0; it < n_iters; ++it) {
    // rows: X_f from the cluster's X_g of the last iteration (0 at first)
    if (it > 0) bar_wait(&bar[1], (uint32_t)(it - 1) & 1u);
    if (threadIdx.x == 0) bar_expect(&bar[0], r);
    for (int k = w; k < rows; k += nw) {
      const float v = cluster_row<kSlab, kTerms>(
          mr, slab + (size_t)k * r, xg, lm[k], r, l);
      if (l < C) send(&xf[lo + k], &bar[0], (unsigned)l, v);
    }
    // columns: X_g from the cluster's X_f of this iteration
    bar_wait(&bar[0], (uint32_t)it & 1u);
    if (threadIdx.x == 0) bar_expect(&bar[1], r);
    for (int k = w; k < rows; k += nw) {
      const float v = cluster_row<kSlab, kTerms>(
          mc, slab + (size_t)(span + k) * r, xf, lm[span + k], r, l);
      if (l < C) send(&xg[lo + k], &bar[1], (unsigned)l, v);
    }
  }
  if (n_iters > 0) bar_wait(&bar[1], (uint32_t)(n_iters - 1) & 1u);
  // the block's rows of the plan
  float* p = plan + (size_t)b * r * r + (size_t)lo * r;
  if constexpr (kSlab == kRegisters) {
    if (w < rows) {
      const float f = reg * xf[lo + w];
#pragma unroll
      for (int j = 0; j < kTerms; ++j) {
        const int x = l + 32 * j;
        if (x < r) p[(size_t)w * r + x] = expf(mr[j] + (f + reg * xg[x]) / reg);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * r; e += blockDim.x) {
      const int k = e / r, x = e % r;
      p[e] = expf(slab[e] + (reg * xf[lo + k] + reg * xg[x]) / reg);
    }
  }
  // no block leaves while a value it pushed may be in flight
  cluster.sync();
}

template <int kSlab, int kTerms = 1>
cudaError_t launch_cluster(const float* mu, const float* nu, const float* cost,
                           float* plan, float* ws, int b, int r, int n_iters,
                           float reg, int threads, int cluster, int span,
                           size_t smem, cudaStream_t stream) {
  auto fn = cluster_kernel<kSlab, kTerms>;
  // raise the function's attributes only when a launch needs more than
  // any earlier one (they are per function)
  static size_t smem_allowed = 48 * 1024;
  static bool non_portable = false;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  if (cluster > 8 && !non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, mu, nu, cost, plan, ws,
                                             r, n_iters, reg, span);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared bytes of a block of the plan (ops.launch_plan's smem):
// a team of threads / 32 warps (team != 0), or a cluster block owning
// `span` rows with -cost/reg where `slab` says (0 registers, 1 shared
// memory, 2 a device workspace).
long long sinkhorn_shared_bytes(int team, int r, int threads, int span,
                                int slab) {
  return team ? team_smem(threads / 32)
              : (long long)cluster_smem(r, span, slab);
}

// mu, nu: (B, R); cost: (B, R, R); plan: (B, R, R); all float32,
// contiguous, on the device; ws: B * cluster * 2 * span * R floats when
// slab is 2 (else unused).  team, threads, cluster, span, slab and smem
// are ops.launch_plan(B, R)'s.  Returns the launch's cudaError_t.
int sinkhorn_launch(const float* mu, const float* nu, const float* cost,
                    float* plan, float* ws, int b, int r, int n_iters,
                    float reg, int team, int threads, int cluster, int span,
                    int slab, long long smem, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (r < 1 || span < 1 || threads < 32 || threads % 32 || n_iters < 0 ||
      smem != sinkhorn_shared_bytes(team, r, threads, span, slab))
    return (int)cudaErrorInvalidValue;
  if (team) {
    const int nw = threads / 32;
    const int kc = span <= 8 ? 8 : span <= 16 ? 16 : 32;   // the instance
    if (r > kTeamMaxR || nw > kTeamWarps || cluster != 1 || nw * span < r ||
        (nw - 1) * span >= r || (nw - 1) * span + kc > 32)
      return (int)cudaErrorInvalidValue;
    auto fn = kc == 8 ? team_kernel<8> : kc == 16 ? team_kernel<16>
                                                  : team_kernel<32>;
    fn<<<b, threads, (size_t)smem, st>>>(mu, nu, cost, plan, r, n_iters, reg,
                                         span);
    return (int)cudaGetLastError();
  }
  if (cluster < 1 || cluster > kMaxCluster ||
      (long long)cluster * span < r || (long long)(cluster - 1) * span >= r ||
      threads != 32 * (span < 32 ? span : 32) ||
      (slab == kRegisters && (span > 32 || r > 32 * kRegTerms)) ||
      (slab == kDevice && ws == nullptr) || slab < 0 || slab > 2)
    return (int)cudaErrorInvalidValue;
  switch (slab) {
    case kRegisters: {
      // the instance holding ceil(R / 32) terms a lane, to a power of two
      auto fn = r <= 32   ? launch_cluster<kRegisters, 1>
                : r <= 64  ? launch_cluster<kRegisters, 2>
                : r <= 128 ? launch_cluster<kRegisters, 4>
                           : launch_cluster<kRegisters, 8>;
      return (int)fn(mu, nu, cost, plan, ws, b, r, n_iters, reg, threads,
                     cluster, span, (size_t)smem, st);
    }
    case kShared:
      return (int)launch_cluster<kShared>(mu, nu, cost, plan, ws, b, r,
                                          n_iters, reg, threads, cluster,
                                          span, (size_t)smem, st);
    default:
      return (int)launch_cluster<kDevice>(mu, nu, cost, plan, ws, b, r,
                                          n_iters, reg, threads, cluster,
                                          span, (size_t)smem, st);
  }
}

}  // extern "C"

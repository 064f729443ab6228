// The fused multi-region micro greedy (Eq 6-10 task-server matching), sm_90a.
//
// Replaces: src/repro/core/micro_jax.py:353 _scan_assign_multi_impl, the
// lax.scan body at :398-463 (XLA, not Pallas; jitted at :472).  For every
// region and every task in the region's greedy order it scores all of the
// region's servers in float64 (the numpy oracle's op order), takes the
// first-index argmax over eligible servers, pushes the chosen server's
// projected queue and writes the task at the head of its 4-entry
// locality ring, so later tasks see it.
//
// A second instantiation (kStatic) serves the per-region scan with the
// fused score kernel, src/repro/core/micro_jax.py:158 _scan_assign with
// fused=True: there the static Eq 7-9 part, warm bonus included, comes
// precomputed as an (R, N_pad, S_pad) float64 operand, and a server scores
// (static[r, i, s] + w_loc * loc) + 0.0 in place of
// (w_hw * hw + w_load * load + w_loc * loc) + w_warm * warm.  Eligibility,
// penalties, the switch cost and both pushes are the same code.
//
// What bounds it on the H100: latency.  The task loop is sequential (each
// choice changes the projected queues and rings the next task is scored
// against), so a region costs N steps, each a block-wide argmax; the
// bytes are a few MB and the flops a few GFLOP, far below what the card
// moves or computes in that time.  With one block per region only R of
// the 132 SMs work (25 on the main path).
//
// Design: one block per region, one thread per server (a thread loops over
// servers s = tid, tid + blockDim, ... when S_pad > 1024).  The task loop
// runs inside the block.  A server's projected queue and locality ring
// live in shared memory for the whole loop (laid out server-fastest, so a
// warp's reads are conflict-free) and only the owning thread ever touches
// them, so the only barrier per step is the one of the argmax: each warp
// reduces (score, index) with shuffles, lane 0 writes a double-buffered
// partial, and after one __syncthreads every thread folds the partials
// and knows the winner.  Static per-server facts are read through the
// read-only cache.
//
// Parity: built with -fmad=false, so no a*b+c contracts into an FMA and
// every float64 op rounds exactly as numpy's and torch's do; the Eq-10
// decay comes from a 41-entry table the wrapper computes once; the f32
// embedding dot is a left-to-right sum; the ring entries are summed newest
// first.  The plain version (ref.py) does the same ops in the same order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kKeep = 4;          // ring depth (MicroAllocator.KEEP)
constexpr int kNoWinner = 0x7fffffff;

struct Params {
  int n_regions, s_pad, n_pad, embed_dim, warm_slots, t;
  int empty;                      // unused ring entry (micro_state.EMPTY)
  int max_age;                    // Eq-10 age clip (decay has max_age + 1)
  double slot_s;
  // server operands (R, S_pad) [, W]
  const double* tflops;
  const double* mem_s;
  const int* kind_s;
  const double* load;
  const int* cur_model;
  const int* warm_srv;
  const double* switch_scale;
  const uint8_t* active;          // bool tensors: one byte, 0 or 1
  const double* speed;
  const double* proj0;
  // rings (R, S_pad, K [, E]): read at entry, written at exit
  int* l_mids;
  int* l_slots;
  float* l_emb;
  float* l_nrm;
  // task operands (R, N_pad) [, E]
  const int* t_mids;
  const int* t_kinds;
  const double* t_mem;
  const double* t_work;
  const double* t_demand;
  const float* t_emb;
  const float* t_norms;
  const float* t_note;
  const uint8_t* t_has;
  const int64_t* n_real;          // (R,) tasks per region
  const double* decay;            // (41,) exp(LOC_DECAY * age)
  const double* static_score;     // (R, N_pad, S_pad) or null
  double w_hw, w_load, w_loc, w_warm, w_model, w_embed;
  double warm_hit_s, model_switch_s;
  int* out;                       // (R, N_pad) server-in-region or -1
};

__device__ __forceinline__ bool better(double a, int ia, double b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <bool kStatic>
__global__ void __launch_bounds__(1024) greedy_kernel(const Params p) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ double red_score[2][32];
  __shared__ int red_index[2][32];
  const int S = p.s_pad, E = p.embed_dim, W = p.warm_slots;
  const int r = blockIdx.x;
  double* proj = reinterpret_cast<double*>(smem);           // [S]
  float* nrm = reinterpret_cast<float*>(proj + S);          // [K][S]
  float* emb = nrm + kKeep * S;                             // [K][E][S]
  int* mid = reinterpret_cast<int*>(emb + kKeep * E * S);   // [K][S]
  int* slot = mid + kKeep * S;                              // [K][S]

  const size_t srv0 = (size_t)r * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    proj[s] = p.proj0[srv0 + s];
    for (int k = 0; k < kKeep; ++k) {
      const size_t g = (srv0 + s) * kKeep + k;
      mid[k * S + s] = p.l_mids[g];
      slot[k * S + s] = p.l_slots[g];
      nrm[k * S + s] = p.l_nrm[g];
      for (int e = 0; e < E; ++e) emb[(k * E + e) * S + s] = p.l_emb[g * E + e];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n = (int)p.n_real[r];
  const double cap = 16.0 * p.slot_s;
  for (int i = 0; i < n; ++i) {
    const size_t ti = (size_t)r * p.n_pad + i;
    const int mid_i = p.t_mids[ti], kind_i = p.t_kinds[ti];
    const double mem_i = p.t_mem[ti], work_i = p.t_work[ti];
    const double demand_i = p.t_demand[ti];
    const float norm_i = p.t_norms[ti];
    const bool has_i = p.t_has[ti] != 0;
    const float* emb_i = p.t_emb + ti * E;

    double best = -CUDART_INF;
    int best_s = kNoWinner;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const size_t g = srv0 + s;
      if (!(__ldg(&p.active[g]) != 0 && __ldg(&p.mem_s[g]) >= mem_i &&
            proj[s] <= cap))
        continue;
      // Eq-10 locality against the ring, newest entry first
      double loc = 0.0;
      for (int k = 0; k < kKeep; ++k) {
        const int mk = mid[k * S + s];
        double contrib = 0.0;
        if (mk != p.empty) {
          double sim = p.w_model * (mk == mid_i ? 1.0 : 0.0);
          float dot = emb[(k * E) * S + s] * emb_i[0];
          for (int e = 1; e < E; ++e) dot = dot + emb[(k * E + e) * S + s] * emb_i[e];
          const float denom = norm_i * nrm[k * S + s];
          if (has_i && denom > 1e-9f)
            sim = sim + (p.w_embed * (double)dot) / (double)denom;
          const int age = min(max(p.t - slot[k * S + s], 0), p.max_age);
          contrib = sim / p.decay[age];
        }
        loc = k == 0 ? contrib : loc + contrib;
      }
      double stat;
      if (kStatic) {
        stat = (__ldg(&p.static_score[ti * S + s]) + p.w_loc * loc) + 0.0;
      } else {
        // static Eq 7-9 row and warm bonus
        const double c = fmin(1.0, __ldg(&p.tflops[g]) / demand_i);
        const double m = fmin(1.0, __ldg(&p.mem_s[g]) / fmax(mem_i, 1e-9));
        const double tm = __ldg(&p.kind_s[g]) == kind_i ? 1.0 : 0.5;
        const double base =
            p.w_hw * (c * m * tm) + p.w_load * __ldg(&p.load[g]);
        double warm = 0.0;
        if (__ldg(&p.cur_model[g]) == mid_i) {
          warm = 1.0;
        } else {
          for (int w = 0; w < W; ++w)
            if (__ldg(&p.warm_srv[g * W + w]) == mid_i) warm = 0.4;
        }
        stat = (base + p.w_loc * loc) + p.w_warm * warm;
      }
      const double q = proj[s] / p.slot_s;
      const double sc = (stat - (0.8 * q + 0.4 * q * q))
                        - (0.3 * (work_i / __ldg(&p.speed[g])) / p.slot_s);
      if (better(sc, s, best, best_s)) {
        best = sc;
        best_s = s;
      }
    }
    // block argmax: shuffles within the warp, then one barrier
    for (int off = 16; off > 0; off >>= 1) {
      const double ob = __shfl_down_sync(0xffffffffu, best, off);
      const int os = __shfl_down_sync(0xffffffffu, best_s, off);
      if (better(ob, os, best, best_s)) {
        best = ob;
        best_s = os;
      }
    }
    const int buf = i & 1;
    if (lane == 0) {
      red_score[buf][warp] = best;
      red_index[buf][warp] = best_s;
    }
    __syncthreads();
    best = red_score[buf][0];
    best_s = red_index[buf][0];
    for (int w = 1; w < n_warps; ++w)
      if (better(red_score[buf][w], red_index[buf][w], best, best_s)) {
        best = red_score[buf][w];
        best_s = red_index[buf][w];
      }
    const bool any = best_s != kNoWinner;
    if (threadIdx.x == 0) p.out[ti] = any ? best_s : -1;
    if (!any || best_s % blockDim.x != threadIdx.x) continue;

    // the owning thread pushes the projected queue and the ring
    const size_t g = srv0 + best_s;
    double sw = 0.0;
    if (__ldg(&p.cur_model[g]) != mid_i) {
      bool warm_hit = false;
      for (int w = 0; w < W; ++w) warm_hit |= __ldg(&p.warm_srv[g * W + w]) == mid_i;
      const double scale = __ldg(&p.switch_scale[g]);
      sw = warm_hit ? scale * p.warm_hit_s : scale * p.model_switch_s;
    }
    proj[best_s] = proj[best_s] + (work_i / __ldg(&p.speed[g]) + sw);
    for (int k = kKeep - 1; k > 0; --k) {
      mid[k * S + best_s] = mid[(k - 1) * S + best_s];
      slot[k * S + best_s] = slot[(k - 1) * S + best_s];
      nrm[k * S + best_s] = nrm[(k - 1) * S + best_s];
      for (int e = 0; e < E; ++e)
        emb[(k * E + e) * S + best_s] = emb[((k - 1) * E + e) * S + best_s];
    }
    mid[best_s] = mid_i;
    slot[best_s] = p.t;
    nrm[best_s] = has_i ? p.t_note[ti] : 0.0f;
    for (int e = 0; e < E; ++e) emb[e * S + best_s] = has_i ? emb_i[e] : 0.0f;
  }
  for (int i = n + threadIdx.x; i < p.n_pad; i += blockDim.x)
    p.out[(size_t)r * p.n_pad + i] = -1;
  __syncthreads();

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    for (int k = 0; k < kKeep; ++k) {
      const size_t g = (srv0 + s) * kKeep + k;
      p.l_mids[g] = mid[k * S + s];
      p.l_slots[g] = slot[k * S + s];
      p.l_nrm[g] = nrm[k * S + s];
      for (int e = 0; e < E; ++e) p.l_emb[g * E + e] = emb[(k * E + e) * S + s];
    }
  }
}

template <bool kStatic>
cudaError_t launch(const Params& p, size_t smem, int threads,
                   cudaStream_t stream) {
  // raise the kernel's dynamic shared-memory limit only when a launch
  // needs more than any earlier one (the attribute is per function)
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        greedy_kernel<kStatic>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  greedy_kernel<kStatic><<<p.n_regions, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for S_pad servers and embedding
// width E (the wrapper checks it against the card's limit).
size_t greedy_assign_smem_bytes(int s_pad, int embed_dim) {
  return (size_t)s_pad * (sizeof(double) + kKeep * sizeof(float) * (embed_dim + 1)
                          + 2 * kKeep * sizeof(int));
}

// One launch for the whole slot: grid = n_regions blocks.  Pointers are
// device pointers to contiguous tensors; the rings are updated in place.
// static_score null scores from the server and task operands, non-null
// from that (R, N_pad, S_pad) matrix.  Returns the launch's cudaError_t.
int greedy_assign_launch(
    int n_regions, int s_pad, int n_pad, int embed_dim, int warm_slots, int t,
    int empty, int max_age, double slot_s, const double* tflops, const double* mem_s, const int* kind_s,
    const double* load, const int* cur_model, const int* warm_srv,
    const double* switch_scale, const uint8_t* active, const double* speed,
    const double* proj0, int* l_mids, int* l_slots, float* l_emb, float* l_nrm,
    const int* t_mids, const int* t_kinds, const double* t_mem,
    const double* t_work, const double* t_demand, const float* t_emb,
    const float* t_norms, const float* t_note, const uint8_t* t_has,
    const int64_t* n_real, const double* decay, const double* static_score,
    double w_hw, double w_load,
    double w_loc, double w_warm, double w_model, double w_embed,
    double warm_hit_s, double model_switch_s, int* out, void* stream) {
  if (n_regions <= 0) return 0;
  if (s_pad < 1 || embed_dim < 1) return (int)cudaErrorInvalidValue;
  Params p{n_regions, s_pad, n_pad, embed_dim, warm_slots, t, empty, max_age,
           slot_s,
           tflops, mem_s, kind_s, load, cur_model, warm_srv, switch_scale,
           active, speed, proj0, l_mids, l_slots, l_emb, l_nrm, t_mids,
           t_kinds, t_mem, t_work, t_demand, t_emb, t_norms, t_note, t_has,
           n_real, decay, static_score, w_hw, w_load, w_loc, w_warm, w_model,
           w_embed,
           warm_hit_s, model_switch_s, out};
  const size_t smem = greedy_assign_smem_bytes(s_pad, embed_dim);
  const int threads = s_pad >= 1024 ? 1024 : ((s_pad + 31) / 32) * 32;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(static_score ? launch<true>(p, smem, threads, st)
                            : launch<false>(p, smem, threads, st));
}

}  // extern "C"

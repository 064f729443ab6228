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
// What bounds it on the H100: the latency of a sequential step.  The task
// loop is sequential (each choice changes the projected queues and rings
// the next task is scored against), so a region costs N steps, each a
// score of every server and an argmax over them; the bytes are a few
// hundred MB and the flops a few GFLOP, far below what the card moves or
// computes in that time.  A step's cost is a chain of dependent float64
// operations (each division is ~10 of them) plus the argmax's trip across
// SMs.  The design cuts both:
//
// 1. One thread-block cluster per region.  Block b of a region's cluster
//    owns servers [b * span, (b + 1) * span), contiguous and ascending in
//    b, and keeps their projected queues and rings in its shared memory;
//    four lanes score a server, one ring entry each.  A step's argmax:
//    each warp reduces its (key, index) with redux.sync, stores it with
//    st.async into every block of the cluster (by step parity), where it
//    completes 16 bytes on that block's mbarrier; every warp waits on its
//    own block's mbarrier, folds the cluster's partials and knows the
//    winner, and the owning quad pushes.  No cluster barrier a step: its
//    release/acquire costs more than the whole exchange.  The wrapper
//    picks C (ops.launch_plan).
// 2. The static terms leave the task loop.  A pre-pass kernel over
//    (region, task, server), on every SM, writes per task a record of its
//    loop operands (with the locality its predecessor's ring entry gives
//    it) and per (task, server) the Eq 7-9 row with the load term (or
//    the given static score), the work penalty
//    (0.3 * (work / speed)) / slot_s, and one byte of eligibility by
//    state and memory and the warm code (0, 0.4 or 1).  The loop reads
//    task i's record and its block's slice of the row from a ring of
//    shared-memory stages, filled kStages - 1 steps ahead by
//    cp.async.bulk against an mbarrier, so no device-memory read sits on
//    a step's critical path.
// 3. The step is pipelined: while step i's partials travel, each quad
//    scores task i + 1 twice, with its server as it stands (lane 0) and
//    with task i pushed onto it (lane 1: the queue after the push, the
//    ring with task i's entry in front); step i's winner then picks which
//    key each server offers at step i + 1.  Both keys use the same
//    per-entry contributions, so they are exact.  Exact shortcuts: a ring
//    is circular (a push moves its head, not its entries), and
//    sim / decay[age] is skipped where decay[age] is exactly 1.0 (age 0),
//    as sim / 1.0 == sim in IEEE arithmetic.  The queue penalty
//    0.8q + 0.4q^2 is worked out from the queue in the same instructions
//    for both lanes (lane 1 needs its division anyway).
//
// Parity: built with -fmad=false, so no a*b+c contracts into an FMA and
// every float64 op rounds exactly as numpy's and torch's do; every
// division stays a division; the Eq-10 decay comes from a 41-entry table
// the wrapper computes once; the f32 embedding dot is a left-to-right
// sum; the ring entries are summed newest first; the score is
// (stat - (0.8q + 0.4q^2)) - pen.  The plain version (ref.py) does the
// same ops in the same order.  The argmax order (score descending, then
// index ascending) is total, so the order in which partials are folded
// does not change the winner.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kKeep = 4;          // ring depth (MicroAllocator.KEEP)
constexpr int kLanes = 4;         // lanes a server: one per ring entry
constexpr int kStages = 4;        // prefetched task rows in flight
constexpr int kNoWinner = 0x7fffffff;
constexpr int kTaskHead = 32;     // task record: bytes before the embedding

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
  // pre-pass workspace (R, N_pad) rows of row_bytes: the task record
  // (task_bytes: mid, has, norm, note, work, the predecessor's locality
  // contribution, the embedding), then base [s_ws] f64, pen [s_ws] f64,
  // flags [s_ws] u8
  unsigned char* ws;
  long long row_bytes;
  int task_bytes, s_ws;
  // launch plan: block b of a cluster owns [b * span, (b + 1) * span)
  int span;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Step profile (a build with -DGREEDY_STEP_PROFILE, read by
// greedy_assign_step_cycles): lane 0 of every warp of the first cluster
// sums the clock64 cycles of each phase of its task steps, and counts the
// steps.  Phases: 0 pick and send the step's partial, 1 score the next
// task both ways, 2 wait for the cluster's partials, 3 fold them, 4 push.
constexpr int kPhases = 5, kProfileWarps = 16 * 32;
#ifdef GREEDY_STEP_PROFILE
__device__ unsigned long long g_step_cycles[kProfileWarps * (kPhases + 1)];
#define PROBE_INIT long long probe_t = clock64(), probe_acc[kPhases + 1] = {};
#define PROBE(ph)                                     \
  {                                                   \
    const long long now = clock64();                  \
    probe_acc[ph] += now - probe_t;                   \
    probe_t = now;                                    \
  }
#define PROBE_STEP ++probe_acc[kPhases];
#define PROBE_SAVE                                                        \
  if (blockIdx.x < C && lane == 0)                                        \
    for (int ph = 0; ph <= kPhases; ++ph)                                 \
      g_step_cycles[(blockIdx.x * 32 + warp) * (kPhases + 1) + ph] =      \
          probe_acc[ph];
#else
#define PROBE_INIT
#define PROBE(ph)
#define PROBE_STEP
#define PROBE_SAVE
#endif

// Byte offsets of one block's dynamic shared memory: the prefetch stages
// (16-byte aligned for the bulk copies), the cluster's partials, the
// per-server float64 state, the decay table, the rings, the mbarriers.
struct Layout {
  size_t stage_bytes, part, f64, decay, ring, bar, total;
  __host__ __device__ Layout(int span, int embed_dim, int cluster,
                             int threads, int task_bytes, int max_age) {
    stage_bytes = round16((size_t)task_bytes + 17 * (size_t)span);
    part = kStages * stage_bytes;
    f64 = part + 2 * (size_t)cluster * (threads / 32) * 16;
    decay = f64 + 6 * 8 * (size_t)span;
    ring = decay + round16(8 * (size_t)(max_age + 1));
    bar = ring + round16((size_t)span * (16 * embed_dim + 52));
    total = bar + round16(8 * (kStages + 2));
  }
};

// The argmax order, score descending then index ascending, on integer
// keys: an order-preserving map of the float64 score (-0.0 taken as +0.0,
// so equal scores have equal keys; scores are never NaN).  The order is
// total, so partials may be folded in any order.
__device__ __forceinline__ unsigned long long order_key(double score) {
  const long long b = __double_as_longlong(score + 0.0);
  return b >= 0 ? (unsigned long long)b ^ 0x8000000000000000ull
                : ~(unsigned long long)b;
}

__device__ __forceinline__ bool better(unsigned long long ka, int ia,
                                       unsigned long long kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Warp argmax with three redux.sync: the largest key's high word, then
// its low word, then the least index holding that key.  Every lane gets
// the result.
__device__ __forceinline__ void warp_argmax(unsigned long long& key, int& idx) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mhi = __reduce_max_sync(0xffffffffu, hi);
  const unsigned mlo = __reduce_max_sync(0xffffffffu, hi == mhi ? lo : 0u);
  idx = __reduce_min_sync(0xffffffffu, hi == mhi && lo == mlo ? idx : kNoWinner);
  key = (unsigned long long)mhi << 32 | mlo;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for an mbarrier's phase: a prefetch stage (filled by this block's
// bulk copies) at the block's scope, the partials (stored by the whole
// cluster) at the cluster's.
template <bool kCluster>
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  if constexpr (kCluster)
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
  else
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Store a warp's (key, index) partial into block `rank` of the cluster,
// completing 16 bytes on that block's partial mbarrier.
__device__ __forceinline__ void send_partial(const void* slot, uint64_t* bar,
                                             unsigned rank,
                                             unsigned long long key, int idx) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rs) : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(rs), "r"((unsigned)key), "r"((unsigned)(key >> 32)),
         "r"((unsigned)idx), "r"(0u), "r"(rb) : "memory");
}

// One thread: copy task j's record and this block's slice of its row into
// a stage, completing on that stage's mbarrier.
__device__ __forceinline__ void prefetch(const Params& p, size_t ti, int lo,
                                         int len16, int span,
                                         unsigned char* stage, uint64_t* bar) {
  const unsigned char* row = p.ws + ti * (size_t)p.row_bytes;
  const unsigned char* base = row + p.task_bytes;
  const uint32_t tb = (uint32_t)p.task_bytes;
  const uint32_t bytes = tb + 17u * (uint32_t)len16;
  const uint32_t b = smem_u32(bar);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  const void* src[4] = {row, base + 8 * (size_t)lo,
                        base + 8 * ((size_t)p.s_ws + lo),
                        base + 16 * (size_t)p.s_ws + lo};
  const uint32_t dst[4] = {0u, tb, tb + 8u * span, tb + 16u * span};
  const uint32_t len[4] = {tb, 8u * len16, 8u * len16, (uint32_t)len16};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(stage) + dst[c]), "l"(src[c]), "r"(len[c]), "r"(b)
        : "memory");
}

// The pre-pass: one thread per (task, server) of the real tasks.
template <bool kStatic>
__global__ void __launch_bounds__(256) prepass_kernel(const Params p) {
  const int r = blockIdx.z;
  const int n = (int)p.n_real[r];
  const int S = p.s_pad, E = p.embed_dim, W = p.warm_slots;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t ti = (size_t)r * p.n_pad + i;
    unsigned char* row = p.ws + ti * (size_t)p.row_bytes;
    const int mid_i = p.t_mids[ti];
    const double work_i = p.t_work[ti];
    if (blockIdx.x == 0) {
      float* emb = reinterpret_cast<float*>(row + kTaskHead);
      for (int e = threadIdx.x; e < E; e += blockDim.x) emb[e] = p.t_emb[ti * E + e];
      if (threadIdx.x == 0) {
        const bool has_i = p.t_has[ti] != 0;
        const float norm_i = p.t_norms[ti];
        reinterpret_cast<int*>(row)[0] = mid_i;
        reinterpret_cast<int*>(row)[1] = has_i;
        reinterpret_cast<float*>(row)[2] = norm_i;
        reinterpret_cast<float*>(row)[3] = p.t_note[ti];
        reinterpret_cast<double*>(row)[2] = work_i;
        // Eq-10 contribution of task i - 1's ring entry (age 0) to task
        // i's locality, the same on every server it may be pushed onto
        double c_prev = 0.0;
        const int mid_p = i > 0 ? p.t_mids[ti - 1] : p.empty;
        if (mid_p != p.empty) {
          const bool has_p = p.t_has[ti - 1] != 0;
          double sim = p.w_model * (mid_p == mid_i ? 1.0 : 0.0);
          const float denom = norm_i * (has_p ? p.t_note[ti - 1] : 0.0f);
          if (has_i && denom > 1e-9f) {   // denom > 0: the entry is emb_p
            const float* ep = p.t_emb + (ti - 1) * E;
            const float* ei = p.t_emb + ti * E;
            float dot = ep[0] * ei[0];
            for (int e = 1; e < E; ++e) dot = dot + ep[e] * ei[e];
            sim = sim + (p.w_embed * (double)dot) / (double)denom;
          }
          const double d = p.decay[0];
          c_prev = d == 1.0 ? sim : sim / d;
        }
        reinterpret_cast<double*>(row)[3] = c_prev;
      }
    }
    double* base = reinterpret_cast<double*>(row + p.task_bytes);
    double* pen = base + p.s_ws;
    uint8_t* flags = reinterpret_cast<uint8_t*>(pen + p.s_ws);
    const int kind_i = p.t_kinds[ti];
    const double mem_i = p.t_mem[ti], demand_i = p.t_demand[ti];
    for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S;
         s += gridDim.x * blockDim.x) {
      const size_t g = (size_t)r * S + s;
      const bool elig = p.active[g] != 0 && p.mem_s[g] >= mem_i;
      int code = 0;                     // warm bonus 0.0 / 0.4 / 1.0
      if (p.cur_model[g] == mid_i) {
        code = 2;
      } else {
        for (int w = 0; w < W; ++w)
          if (p.warm_srv[g * W + w] == mid_i) code = 1;
      }
      double b;
      if (kStatic) {
        b = p.static_score[ti * S + s];
      } else {
        // static Eq 7-9 row and the load term
        const double c = fmin(1.0, p.tflops[g] / demand_i);
        const double m = fmin(1.0, p.mem_s[g] / fmax(mem_i, 1e-9));
        const double tm = p.kind_s[g] == kind_i ? 1.0 : 0.5;
        b = p.w_hw * (c * m * tm) + p.w_load * p.load[g];
      }
      base[s] = b;
      pen[s] = 0.3 * (work_i / p.speed[g]) / p.slot_s;
      flags[s] = (uint8_t)((elig ? 1 : 0) | (code << 1));
    }
  }
}

template <bool kStatic, int kE>
__global__ void __launch_bounds__(1024) greedy_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int S = p.s_pad, E = p.embed_dim, L = p.span;
  const int r = blockIdx.x / C;
  const int lo = min(rank * L, S);
  const int n_srv = min(lo + L, S) - lo;
  const int len16 = (n_srv + 15) / 16 * 16;
  const int n_warps = blockDim.x >> 5;
  const int n_part = C * n_warps;
  const Layout lay(L, E, C, blockDim.x, p.task_bytes, p.max_age);
  unsigned char* stages = smem;                                 // [kStages]
  uint4* part = reinterpret_cast<uint4*>(smem + lay.part);      // [2][n_part]
  double* proj = reinterpret_cast<double*>(smem + lay.f64);     // [L]
  double* speed = proj + L;                                     // [L]
  double* scale = speed + L;                                    // [L]
  // the next task's key with the state as it stands (key_a) and if this
  // step's task were pushed onto the server (key_b, with the queue it
  // would then have); key 0: not eligible
  unsigned long long* key_a = reinterpret_cast<unsigned long long*>(scale + L);
  unsigned long long* key_b = key_a + L;                        // [L]
  double* proj_b = reinterpret_cast<double*>(key_b + L);        // [L]
  double* decay = reinterpret_cast<double*>(smem + lay.decay);  // [max_age+1]
  float* emb = reinterpret_cast<float*>(smem + lay.ring);       // [E][L][K]
  float* nrm = emb + (size_t)E * L * kKeep;                     // [L][K]
  int* mid = reinterpret_cast<int*>(nrm + L * kKeep);           // [L][K]
  int* slot = mid + L * kKeep;                                  // [L][K]
  int* head = slot + L * kKeep;                                 // [L]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);  // [kStages]
  uint64_t* part_bar = bar + kStages;                           // [2]
  const size_t stage_bytes = lay.stage_bytes;

  const int n = (int)p.n_real[r];
  const size_t srv0 = (size_t)r * S + lo;                       // first server
  const size_t task0 = (size_t)r * p.n_pad;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kStages + 2; ++b) bar_init(&bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kStages - 1 && j < n; ++j)
      prefetch(p, task0 + j, lo, len16, L, stages + j * stage_bytes, &bar[j]);
  }
  for (int a = threadIdx.x; a <= p.max_age; a += blockDim.x) decay[a] = p.decay[a];
  for (int s = threadIdx.x; s < n_srv; s += blockDim.x) {
    proj[s] = p.proj0[srv0 + s];
    speed[s] = p.speed[srv0 + s];
    scale[s] = p.switch_scale[srv0 + s];
    head[s] = 0;
    for (int k = 0; k < kKeep; ++k) {
      const size_t g = (srv0 + s) * kKeep + k;
      mid[s * kKeep + k] = p.l_mids[g];
      slot[s * kKeep + k] = p.l_slots[g];
      nrm[s * kKeep + k] = p.l_nrm[g];
      for (int e = 0; e < E; ++e)
        emb[((size_t)e * L + s) * kKeep + k] = p.l_emb[g * E + e];
    }
  }
  // every block of the cluster has started (its shared memory may be
  // written remotely from here on), loaded its servers and set its
  // mbarriers
  cluster.sync();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = threadIdx.x & (kLanes - 1);       // this lane's ring entry
  const int quad = threadIdx.x / kLanes;
  const int n_quads = blockDim.x / kLanes;
  const double cap = 16.0 * p.slot_s;

  // Task j's keys against this quad's servers: key_a with the state as it
  // stands and, when `pushed` (task j - 1 may be pushed first), key_b and
  // proj_b with task j - 1 pushed onto the server: its ring then holds
  // task j - 1's entry (age 0) and its first three entries, so loc_b sums
  // the same per-entry contributions, newest first.  The queue penalty
  // 0.8q + 0.4q^2 is worked out from the queue each time (lane 1 needs
  // the division anyway, and lane 0 rides along in the same instructions).
  auto score = [&](int j, bool pushed) {
    const unsigned char* stage = stages + (j % kStages) * stage_bytes;
    const unsigned char* prev = stages + ((j + kStages - 1) % kStages) * stage_bytes;
    bar_wait<false>(&bar[j % kStages], (uint32_t)(j / kStages) & 1u);
    const int mid_j = reinterpret_cast<const int*>(stage)[0];
    const bool has_j = reinterpret_cast<const int*>(stage)[1] != 0;
    const float norm_j = reinterpret_cast<const float*>(stage)[2];
    const float* emb_j = reinterpret_cast<const float*>(stage + kTaskHead);
    // the f32 embedding dot of a ring entry (stride apart in shared
    // memory) and the task, left to right; at a compile-time width the
    // task's embedding sits in registers and all loads precede the sums
    float ej[kE > 0 ? kE : 1];
    if constexpr (kE > 0) {
#pragma unroll
      for (int e = 0; e < kE; ++e) ej[e] = emb_j[e];
    }
    auto dot_task = [&](const float* ek, size_t stride) {
      if constexpr (kE > 0) {
        float a[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) a[e] = ek[e * stride];
        float dot = a[0] * ej[0];
#pragma unroll
        for (int e = 1; e < kE; ++e) dot = dot + a[e] * ej[e];
        return dot;
      } else {
        float dot = ek[0] * emb_j[0];
        for (int e = 1; e < E; ++e) dot = dot + ek[e * stride] * emb_j[e];
        return dot;
      }
    };
    const double* base_row = reinterpret_cast<const double*>(stage + p.task_bytes);
    const double* pen_row = base_row + L;
    const uint8_t* flags_row = reinterpret_cast<const uint8_t*>(pen_row + L);
    // task j - 1's ring entry against task j (from the pre-pass)
    const double c_new = pushed ? reinterpret_cast<const double*>(stage)[3] : 0.0;
    const uint8_t* prev_flags =
        reinterpret_cast<const uint8_t*>(prev + p.task_bytes) + 16 * L;
    const double work_p = reinterpret_cast<const double*>(prev)[2];
    for (int s0 = 0; s0 < n_srv; s0 += n_quads) {
      const int s = s0 + quad;
      const bool valid = s < n_srv;
      const int sv = valid ? s : 0;
      // lane 0 works out key_a and lane 1 key_b, with the same
      // instructions on other operands: lane 1's queue is the one after
      // the push of task j - 1 onto the server (its work and switch cost)
      const bool lane_b = pushed && k == 1;
      const int code_p = prev_flags[sv] >> 1;
      const double sw = code_p == 2 ? 0.0
                        : code_p == 1 ? scale[sv] * p.warm_hit_s
                                      : scale[sv] * p.model_switch_s;
      const double add = work_p / speed[sv] + sw;
      const double pr = lane_b ? proj[sv] + add : proj[sv];
      const double q = pr / p.slot_s;
      const double qp = 0.8 * q + 0.4 * q * q;
      const bool ok = valid && (flags_row[sv] & 1) != 0 && proj[sv] <= cap;
      // Eq-10 locality: this lane's ring entry k (newest first), worked
      // out for every server without branches (so it interleaves with the
      // queue arithmetic above) and counted 0.0 where the server is not
      // eligible or the entry is EMPTY
      const int e0 = sv * kKeep + ((head[sv] + k) & (kKeep - 1));
      const int mk = mid[e0];
      const float dot = dot_task(emb + e0, (size_t)L * kKeep);
      const float denom = norm_j * nrm[e0];
      const double emb_sim = (p.w_embed * (double)dot) / (double)denom;
      double sim = p.w_model * (mk == mid_j ? 1.0 : 0.0);
      sim = has_j && denom > 1e-9f ? sim + emb_sim : sim;
      const double d = decay[min(max(p.t - slot[e0], 0), p.max_age)];
      if (d != 1.0) sim = sim / d;              // x / 1.0 == x exactly
      const double contrib = ok && mk != p.empty ? sim : 0.0;
      // lane 1's ring: task j - 1's entry, then entries 0-2
      const int q0 = lane & ~(kLanes - 1);
      const double c0 = __shfl_sync(0xffffffffu, contrib, q0);
      const double c1 = __shfl_sync(0xffffffffu, contrib, q0 + 1);
      const double c2 = __shfl_sync(0xffffffffu, contrib, q0 + 2);
      const double c3 = __shfl_sync(0xffffffffu, contrib, q0 + 3);
      if (!valid || !(k == 0 || lane_b)) continue;
      unsigned long long key = 0;
      if (ok && pr <= cap) {
        double warm = 0.0;
        if (!kStatic) {
          const int code = flags_row[s] >> 1;
          warm = p.w_warm * (code == 2 ? 1.0 : code == 1 ? 0.4 : 0.0);
        }
        const double loc = lane_b ? ((c_new + c0) + c1) + c2
                                  : ((c0 + c1) + c2) + c3;
        const double stat = (base_row[s] + p.w_loc * loc) + warm;
        key = order_key((stat - qp) - pen_row[s]);
      }
      if (lane_b) {
        proj_b[s] = pr;
        key_b[s] = key;
      } else {
        key_a[s] = key;
      }
    }
  };

  // Pipelined by one step: while step i's partials travel, every quad
  // scores task i + 1 both ways (its server chosen at step i or not);
  // the winner of step i then picks each server's key for step i + 1.
  if (n > 0) score(0, false);
  PROBE_INIT
  int won = kNoWinner;                    // step i - 1's winner
  for (int i = 0; i < n; ++i) {
    unsigned long long best = 0;          // below every score's key
    int best_s = kNoWinner;
    if (k == 0)
      for (int s = quad; s < n_srv; s += n_quads) {
        const unsigned long long key = lo + s == won ? key_b[s] : key_a[s];
        if (key != 0 && better(key, lo + s, best, best_s)) {
          best = key;
          best_s = lo + s;
        }
      }
    // warp argmax; lane j < C stores the warp's partial in block j of
    // the cluster, at this step's parity, and every block waits for the
    // cluster's partials on its own mbarrier
    warp_argmax(best, best_s);
    const int buf = i & 1;
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(&part_bar[buf])), "r"(n_part * 16) : "memory");
    if (lane < C)
      send_partial(part + buf * n_part + rank * n_warps + warp, &part_bar[buf],
                   (unsigned)lane, best, best_s);
    PROBE(0)
    if (i + 1 < n) score(i + 1, true);
    PROBE(1)
    bar_wait<true>(&part_bar[buf], (uint32_t)(i >> 1) & 1u);
    PROBE(2)
    // every warp of the cluster has sent its step-i partial, so this
    // block is done with step i - 1's stage: refill it kStages - 1 steps
    // ahead
    if (threadIdx.x == 0 && i + kStages - 1 < n) {
      const int j = i + kStages - 1;
      prefetch(p, task0 + j, lo, len16, L, stages + (j % kStages) * stage_bytes,
               &bar[j % kStages]);
    }
    // every warp folds the cluster's partials: lane j takes j, j + 32, ...
    best = 0;
    best_s = kNoWinner;
    for (int j = lane; j < n_part; j += 32) {
      const uint4 v = part[buf * n_part + j];
      const unsigned long long key = (unsigned long long)v.y << 32 | v.x;
      if (better(key, (int)v.z, best, best_s)) {
        best = key;
        best_s = (int)v.z;
      }
    }
    warp_argmax(best, best_s);
    PROBE(3)
    won = best_s;
    const bool any = best_s != kNoWinner;
    if (rank == 0 && threadIdx.x == 0) p.out[task0 + i] = any ? best_s : -1;
    const int s = best_s - lo;
    if (any && s >= 0 && s < n_srv && s % n_quads == quad) {
      // the server's quad pushes: the ring's head moves back one entry
      // and the task is written there; lane 0 pushes the queue (worked
      // out by score(i + 1), or here after the last task)
      const unsigned char* stage = stages + (i % kStages) * stage_bytes;
      const bool has_i = reinterpret_cast<const int*>(stage)[1] != 0;
      const float* emb_i = reinterpret_cast<const float*>(stage + kTaskHead);
      const int nh = (head[s] + kKeep - 1) & (kKeep - 1);
      const int e0 = s * kKeep + nh;
      for (int e = k; e < E; e += kLanes)
        emb[(size_t)e * L * kKeep + e0] = has_i ? emb_i[e] : 0.0f;
      if (k == 0) {
        if (i + 1 < n) {
          proj[s] = proj_b[s];
        } else {
          const uint8_t* flags_row = reinterpret_cast<const uint8_t*>(
              stage + p.task_bytes) + 16 * L;
          const int code = flags_row[s] >> 1;
          const double work_i = reinterpret_cast<const double*>(stage)[2];
          const double sw = code == 2 ? 0.0
                            : code == 1 ? scale[s] * p.warm_hit_s
                                        : scale[s] * p.model_switch_s;
          proj[s] = proj[s] + (work_i / speed[s] + sw);
        }
        mid[e0] = reinterpret_cast<const int*>(stage)[0];
        slot[e0] = p.t;
        nrm[e0] = has_i ? reinterpret_cast<const float*>(stage)[3] : 0.0f;
        head[s] = nh;
      }
    }
    __syncwarp();
    PROBE(4)
    PROBE_STEP
  }
  PROBE_SAVE
  if (rank == 0)
    for (int i = n + threadIdx.x; i < p.n_pad; i += blockDim.x)
      p.out[task0 + i] = -1;
  // no block leaves while a partial it sent may be in flight
  cluster.sync();

  // rings back in newest-first order
  for (int s = threadIdx.x; s < n_srv; s += blockDim.x) {
    for (int kk = 0; kk < kKeep; ++kk) {
      const size_t g = (srv0 + s) * kKeep + kk;
      const int e0 = s * kKeep + ((head[s] + kk) & (kKeep - 1));
      p.l_mids[g] = mid[e0];
      p.l_slots[g] = slot[e0];
      p.l_nrm[g] = nrm[e0];
      for (int e = 0; e < E; ++e)
        p.l_emb[g * E + e] = emb[(size_t)e * L * kKeep + e0];
    }
  }
}

using KernelFn = void (*)(Params);

// The loop kernel of a variant and embedding width, and its index among
// the four.  The main path's rings are 8 wide; at that width the dot is
// unrolled (11-15% of the loop's time on the H100, PERF.md).
KernelFn kernel_for(bool stat, int embed_dim, int* which) {
  static const KernelFn fns[4] = {
      greedy_kernel<false, 8>, greedy_kernel<false, 0>,
      greedy_kernel<true, 8>, greedy_kernel<true, 0>};
  *which = (stat ? 2 : 0) + (embed_dim == 8 ? 0 : 1);
  return fns[*which];
}

cudaError_t set_attributes(KernelFn fn, int which, int cluster, size_t smem) {
  // raise a kernel's dynamic shared-memory limit only when a launch needs
  // more than any earlier one (the attributes are per function)
  static size_t smem_allowed[4] = {};
  static bool non_portable[4] = {};
  if (smem > smem_allowed[which]) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed[which] = smem;
  }
  if (cluster > 8 && !non_portable[which]) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable[which] = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t config(int n_regions, int cluster, int threads,
                          size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_regions * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch_greedy(const Params& p, bool stat, int cluster,
                          int threads, size_t smem, cudaStream_t stream) {
  int which;
  const KernelFn fn = kernel_for(stat, p.embed_dim, &which);
  cudaError_t err = set_attributes(fn, which, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(p.n_regions, cluster, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fn, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kStatic>
cudaError_t launch_prepass(const Params& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.s_pad + 255) / 256),
                  (unsigned)(p.n_pad < 1024 ? p.n_pad : 1024),
                  (unsigned)p.n_regions);
  prepass_kernel<kStatic><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

int max_clusters(bool stat, int embed_dim, int cluster, int threads,
                 size_t smem) {
  int which;
  const KernelFn fn = kernel_for(stat, embed_dim, &which);
  if (set_attributes(fn, which, cluster, smem) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(cluster, cluster, threads, smem, nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace

extern "C" {

#ifdef GREEDY_STEP_PROFILE
// The step profile of the last launch: kProfileWarps x (kPhases + 1)
// counters (phase cycles, then steps) for warp w of block b at
// (b * 32 + w); returns the copy's cudaError_t.
int greedy_assign_step_cycles(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_step_cycles, sizeof(g_step_cycles));
}
#endif

// Dynamic shared memory of one block of the launch plan (span servers a
// block, embedding width E, cluster size C, threads a block, task record
// bytes, the Eq-10 age clip); the wrapper holds its own plan to it.
size_t greedy_assign_smem_bytes(int span, int embed_dim, int cluster,
                                int threads, int task_bytes, int max_age) {
  return Layout(span, embed_dim, cluster, threads, task_bytes, max_age).total;
}

// How many clusters of this plan the card keeps resident at once (-1 on
// an error); static_variant selects the kStatic instantiation.
int greedy_assign_max_clusters(int static_variant, int embed_dim, int cluster,
                               int threads, size_t smem) {
  return max_clusters(static_variant != 0, embed_dim, cluster, threads, smem);
}

// One slot's greedy: `stage` 1 launches the pre-pass into the workspace,
// 2 the task loop (n_regions clusters of `cluster` blocks of `threads`
// threads, block b of a cluster owning servers [b * span, (b + 1) * span)),
// which reads it.  Pointers are device pointers to contiguous tensors;
// the rings are updated in place.  static_score null scores from the
// server and task operands, non-null from that (R, N_pad, S_pad) matrix.
// Returns the launch's cudaError_t.
int greedy_assign_launch(
    int stage, int n_regions, int s_pad, int n_pad, int embed_dim,
    int warm_slots, int t, int empty, int max_age, int cluster, int span,
    int threads, size_t smem, int task_bytes, int s_ws, long long row_bytes,
    double slot_s, const double* tflops, const double* mem_s, const int* kind_s,
    const double* load, const int* cur_model, const int* warm_srv,
    const double* switch_scale, const uint8_t* active, const double* speed,
    const double* proj0, int* l_mids, int* l_slots, float* l_emb, float* l_nrm,
    const int* t_mids, const int* t_kinds, const double* t_mem,
    const double* t_work, const double* t_demand, const float* t_emb,
    const float* t_norms, const float* t_note, const uint8_t* t_has,
    const int64_t* n_real, const double* decay, const double* static_score,
    double w_hw, double w_load,
    double w_loc, double w_warm, double w_model, double w_embed,
    double warm_hit_s, double model_switch_s, int* out, unsigned char* ws,
    void* stream) {
  if (n_regions <= 0) return 0;
  if (s_pad < 1 || embed_dim < 1 || cluster < 1 || span < 16 || span % 16
      || threads < 32 || threads > 1024 || threads % 32
      || (size_t)cluster * span < (size_t)s_pad
      || (size_t)(cluster - 1) * span >= (size_t)s_pad
      || task_bytes % 16 || task_bytes < kTaskHead + 4 * embed_dim
      || s_ws % 16 || s_ws < s_pad
      || row_bytes != (long long)task_bytes + 17LL * s_ws
      || smem != Layout(span, embed_dim, cluster, threads, task_bytes,
                        max_age).total)
    return (int)cudaErrorInvalidValue;
  Params p{n_regions, s_pad, n_pad, embed_dim, warm_slots, t, empty, max_age,
           slot_s,
           tflops, mem_s, kind_s, load, cur_model, warm_srv, switch_scale,
           active, speed, proj0, l_mids, l_slots, l_emb, l_nrm, t_mids,
           t_kinds, t_mem, t_work, t_demand, t_emb, t_norms, t_note, t_has,
           n_real, decay, static_score, w_hw, w_load, w_loc, w_warm, w_model,
           w_embed, warm_hit_s, model_switch_s, out,
           ws, row_bytes, task_bytes, s_ws, span};
  cudaStream_t st = (cudaStream_t)stream;
  const bool stat = static_score != nullptr;
  if (stage == 1)
    return (int)(stat ? launch_prepass<true>(p, st) : launch_prepass<false>(p, st));
  if (stage == 2)
    return (int)launch_greedy(p, stat, cluster, threads, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

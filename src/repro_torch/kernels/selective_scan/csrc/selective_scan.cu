// Mamba-1 selective scan, sm_90a.
//
// Replaces: src/repro/kernels/selective_scan/kernel.py:51 selective_scan
// (Pallas body _kernel :23).  For dt, x (B, S, D), Bm, Cm (B, S, N),
// A (D, N) and Dskip (D,), float32 or bfloat16 in, float32 state:
//   h_s = exp(dt_s * A) * h_{s-1} + (dt_s * x_s) * Bm_s      (h_{-1} = 0)
//   y_s = h_s . Cm_s + Dskip * x_s
// y is written in the input type; the last state h_{S-1} (B, D, N) is
// written in float32 too (the Pallas kernel keeps it in scratch only; the
// port's mamba_forward needs it for the decode cache).  Given h_chunks,
// the state each chunk of `chunk` steps starts from, h_{k chunk - 1}
// (zeros for k = 0), is written there too, (B, ceil(S / chunk), D, N)
// float32: the boundaries the backward (selective_scan_bwd.cu) rebuilds
// each chunk's states from (chunk = ref.STEPS, 16, a multiple of a
// register group's steps, so every boundary starts a group).  The stores
// leave the arithmetic as it is, so y and h_last are the same bits with
// and without them.
//
// What bounds it on the H100: the exponentials and the bytes.  Each
// (b, s, d, n) costs one exp and four float32 operations (dt A, the two
// products of the update, the C product); the exps run on the SMs'
// special-function units, 16 a clock an SM, a quarter of a float32 issue
// slot's rate, so B S D N exps are a floor of their own beside the bytes
// (dt, x read once, y written once).  The recurrence itself is one
// dependent FMA a step per state: the exps and products of step s do not
// wait for step s - 1, so a thread keeps many of them in flight.  (The
// kept design runs at ~3x both floors at falcon-mamba-7b's prefill shape,
// stalled rather than saturating one unit: PERF.md §6.)
//
// Design (ops.scan_plan picks the knobs; the CPU tests pin its cover):
// 1. Every operand a step reads is staged in shared memory.  A block of
//    kThreads threads owns kThreads / L channels of one batch row (the
//    shape is fixed at compile time, so every shared-memory read is a
//    constant offset) and walks its steps in stages of
//    `steps` steps: the stage's dt and x rows (its channels) and Bm and Cm
//    rows go into a ring of `stages` stage buffers by cp.async, filled
//    stages - 1 stages ahead of the compute, so no device-memory read sits
//    on a step's chain.  A row moves in 16-, 8- or 4-byte pieces, the
//    largest the operands' alignment allows (ops picks it); unaligned
//    bfloat16 rows fall back to plain loads.
// 2. A channel's N states are spread over L = SCAN_LANES lanes (N / L
//    states each; 4, or another count set with -DSCAN_LANES for the lane
//    sweep), which multiplies the warps an SM runs by L at B = 1.  Each
//    lane reads its operands for a group of steps into registers while
//    the previous group computes, and y's sum over N is added across the
//    L lanes once for every L steps, transposed: each level of shuffles
//    halves the steps a lane carries, so L - 1 shuffles give each lane
//    one step's whole sum (not log2(L) a step), and lane j stores step j.
// A block walks the whole sequence.  Cutting it into chunks scanned from
// a zero state and composed after was slower at falcon-mamba-7b's prefill
// shape, and every Mamba configuration in the repo gives 1,024 warps or
// more at B = 1 (PERF.md §6).
// The exp is ex2.approx.ftz.f32 on dt * (A log2 e), A pre-scaled once a
// thread: relative error ~2^-22 from the unit plus |dt A| 2^-24 from the
// scaled argument's rounding; results below 2^-126 flush to 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef SCAN_LANES
#define SCAN_LANES 4
#endif

constexpr int kThreads = 128;      // threads a block
constexpr int kLanes = SCAN_LANES; // lanes a channel
static_assert(kLanes >= 1 && kLanes <= 16 && (kLanes & (kLanes - 1)) == 0,
              "SCAN_LANES is 1, 2, 4, 8 or 16");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float cvt(float v) { return v; }
__device__ __forceinline__ float cvt(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// P consecutive staged values of a row, widened to float32
template <int P>
__device__ __forceinline__ void load_row(const float* s, float (&o)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(s)[q];
      o[4 * q] = f.x; o[4 * q + 1] = f.y; o[4 * q + 2] = f.z;
      o[4 * q + 3] = f.w;
    }
  } else if constexpr (P == 2) {
    const float2 f = *reinterpret_cast<const float2*>(s);
    o[0] = f.x; o[1] = f.y;
  } else {
    o[0] = s[0];
  }
}
template <int P>
__device__ __forceinline__ void load_row(const __nv_bfloat16* s,
                                         float (&o)[P]) {
  if constexpr (P % 2 == 0) {
#pragma unroll
    for (int q = 0; q < P / 2; ++q) {
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(s)[q]);
      o[2 * q] = f.x; o[2 * q + 1] = f.y;
    }
  } else {
    o[0] = __bfloat162float(s[0]);
  }
}

__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src, int g) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (g == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
  } else if (g == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src));
  } else if (g == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
  } else {                                // 2: a bfloat16 at a time
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::); break;
  }
}

// The sums over the L lanes of a channel of each lane's v[0..L-1]: on
// return lane j holds the sum of everyone's v[j].  Each level sends the
// half of its values its partner keeps and adds the half it keeps, so
// L - 1 shuffles cover L steps.
template <int L>
__device__ __forceinline__ float lane_sum(float (&v)[L], int j) {
#pragma unroll
  for (int w = L / 2; w >= 1; w /= 2) {
    const bool upper = (j & w) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = upper ? v[i] : v[i + w];
      const float keep = upper ? v[i + w] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
  return v[0];
}

struct Params {
  const void* dt;
  const void* bm;
  const void* cm;
  const void* x;
  const float* a;
  const float* d_skip;
  void* y;
  float* h_last;
  float* h_chunks;       // null, or the state each chunk starts from
  int b, s, d;
  int chunk;             // steps a saved state (with h_chunks)
  int channels;          // channels a block
  int steps;             // steps a stage
  int stages;            // stage buffers in the ring
  int gran_dx;           // bytes a piece of a dt / x row (16, 8, 4, 2)
  int gran_bc;           // bytes a piece of a Bm / Cm stage
};

// Shared bytes of one stage: dt and x rows of `channels`, Bm and Cm rows.
__host__ __device__ inline int stage_bytes(int n, int elt, int channels,
                                           int steps) {
  return 2 * steps * channels * elt + 2 * steps * n * elt;
}


// Steps a register group at P states a lane: each group's operands are
// read from shared memory while the group before computes.
__host__ __device__ constexpr int group_steps(int p) {
  return p >= 16 ? 1 : 16 / p;
}

// One group's operands, in registers.
template <int P, int U>
struct Group {
  float dt[U], x[U], b[U][P], c[U][P];
};

// The minimum of one block an SM frees ptxas to take the registers the
// kernel needs: left to its own heuristic it capped the N = 16 instance at
// 128 and spilled, 2-7% slower (PERF.md §6).
template <typename T, int N, int L>
__global__ void __launch_bounds__(kThreads, 1) scan_kernel(const Params p) {
  constexpr int P = N / L;                // states a lane
  constexpr int U = group_steps(P);       // steps a group
  constexpr int DC = kThreads / L;        // channels a block
  constexpr int kRow = DC * (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tsteps = p.steps;
  const int tid = threadIdx.x, c = tid / L, j = tid % L;
  const int d0 = blockIdx.x * DC, d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < p.d;
  const int dx_bytes = tsteps * kRow;
  const int bc_bytes = tsteps * N * (int)sizeof(T);
  const int sbytes = stage_bytes(N, sizeof(T), DC, tsteps);
  const int per_row = min(DC, p.d - d0) * (int)sizeof(T) / p.gran_dx;
  const long long bs = (long long)b * p.s;
  const unsigned char* gdt = (const unsigned char*)p.dt;
  const unsigned char* gx = (const unsigned char*)p.x;
  const unsigned char* gbm = (const unsigned char*)p.bm;
  const unsigned char* gcm = (const unsigned char*)p.cm;

  // stage `stage` of the sequence into buffer stage % stages
  auto issue = [&](int stage) {
    unsigned char* buf = smem + (stage % p.stages) * sbytes;
    const int t0 = stage * tsteps;
    const int rows = min(tsteps, p.s - t0);
    const int g = p.gran_dx;
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, q = i - r * per_row;
      const long long off =
          ((bs + t0 + r) * p.d + d0) * (long long)sizeof(T) + q * g;
      copy_piece(buf + r * kRow + q * g, gdt + off, g);
      copy_piece(buf + dx_bytes + r * kRow + q * g, gx + off, g);
    }
    const int gb = p.gran_bc;
    const long long off = (bs + t0) * N * (long long)sizeof(T);
    for (int i = tid; i < rows * N * (int)sizeof(T) / gb; i += kThreads) {
      copy_piece(buf + 2 * dx_bytes + i * gb, gbm + off + i * gb, gb);
      copy_piece(buf + 2 * dx_bytes + bc_bytes + i * gb, gcm + off + i * gb,
                 gb);
    }
  };

  float a2[P], h[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    a2[q] = live ? p.a[(long long)d * N + j * P + q] * kLog2e : 0.0f;
    h[q] = 0.0f;
  }
  // lane 0 of a channel adds Dskip x to its part of y
  const float xd = (live && j == 0) ? p.d_skip[d] : 0.0f;

  const int n_st = (p.s + tsteps - 1) / tsteps;
  // the next chunk boundary to save the state at, and its chunk
  int save_at = p.h_chunks != nullptr ? 0 : -1, save_k = 0;
  float* hc = p.h_chunks == nullptr ? nullptr
      : p.h_chunks + ((long long)b * ((p.s + p.chunk - 1) / p.chunk) * p.d
                      + d) * N + j * P;
  const long long hc_step = (long long)p.d * N;
  for (int stage = 0; stage < p.stages - 1; ++stage) {
    if (stage < n_st) issue(stage);
    cp_async_commit();
  }
  T* y = (T*)p.y + d;
  for (int stage = 0; stage < n_st; ++stage) {
    cp_async_wait(p.stages - 2);          // this stage has landed
    __syncthreads();                      // and the previous one is used
    if (stage + p.stages - 1 < n_st) issue(stage + p.stages - 1);
    cp_async_commit();
    const unsigned char* buf = smem + (stage % p.stages) * sbytes;
    const T* sdt = (const T*)buf + c;
    const T* sx = (const T*)(buf + dx_bytes) + c;
    const T* sbm = (const T*)(buf + 2 * dx_bytes) + j * P;
    const T* scm = (const T*)(buf + 2 * dx_bytes + bc_bytes) + j * P;
    const int t0 = stage * tsteps;
    const int rows = min(tsteps, p.s - t0);
    T* yst = y + (bs + t0) * p.d;

    // Steps go in groups of U, in two register sets: a group's operands
    // are read while the other set's group computes.  (The compiler does
    // not move a load above a store that might alias it, so the reads are
    // written before the stores of the group that computes meanwhile.)
    // Reads stay inside the stage: steps is a multiple of 2 U.
    auto fetch = [&](Group<P, U>& o, int g) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        o.dt[u] = cvt(sdt[(g + u) * DC]);
        o.x[u] = cvt(sx[(g + u) * DC]);
        load_row<P>(sbm + (g + u) * N, o.b[u]);
        load_row<P>(scm + (g + u) * N, o.c[u]);
      }
    };
    // one group; `tail` guards steps past the stage's rows.  y's parts of
    // every L steps are summed across the channel's L lanes, transposed:
    // lane j ends with step j's whole sum and stores it
    auto compute = [&](const Group<P, U>& o, int g, bool tail) {
      if (t0 + g == save_at) {          // a chunk starts with this group
        if (live) {
#pragma unroll
          for (int q = 0; q < P; ++q) hc[save_k * hc_step + q] = h[q];
        }
        save_at += p.chunk;
        ++save_k;
      }
      float acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[u] = 0.0f;
        if (tail && g + u >= rows) continue;
        const float dxv = o.dt[u] * o.x[u];
        acc[u] = xd * o.x[u];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          h[q] = ex2(o.dt[u] * a2[q]) * h[q] + dxv * o.b[u][q];
          acc[u] += h[q] * o.c[u][q];
        }
      }
#pragma unroll
      for (int r = 0; r < U; r += L) {
        float v[L];
#pragma unroll
        for (int i = 0; i < L; ++i) v[i] = acc[r + i];
        const float tot = lane_sum<L>(v, j);
        const int t = g + r + j;
        if (live && (!tail || t < rows)) store(yst + (long long)t * p.d, tot);
      }
    };
    Group<P, U> ga, gb;
    int g = 0;
    if (rows > 0) fetch(ga, 0);
    for (; g + 2 * U <= rows; g += 2 * U) {
      fetch(gb, g + U);
      compute(ga, g, false);
      if (g + 2 * U < rows) fetch(ga, g + 2 * U);
      compute(gb, g + U, false);
    }
    if (g < rows) {
      if (g + U < rows) fetch(gb, g + U);
      compute(ga, g, true);
      if (g + U < rows) compute(gb, g + U, true);
    }
  }
  cp_async_wait(0);
  if (!live) return;
#pragma unroll
  for (int q = 0; q < P; ++q)
    p.h_last[((long long)b * p.d + d) * N + j * P + q] = h[q];
}

template <typename T, int N>
cudaError_t launch_one(const Params& p, int smem, cudaStream_t stream) {
  if constexpr (N % kLanes != 0) {
    return cudaErrorInvalidValue;
  } else {
    auto fn = scan_kernel<T, N, kLanes>;
    static int allowed = 48 * 1024;     // dynamic shared bytes admitted
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      allowed = smem;
    }
    const dim3 grid((p.d + p.channels - 1) / p.channels, p.b);
    fn<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const Params& p, int n, cudaStream_t stream) {
  const int smem =
      p.stages * stage_bytes(n, sizeof(T), p.channels, p.steps);
  switch (n) {
    case 4: return launch_one<T, 4>(p, smem, stream);
    case 8: return launch_one<T, 8>(p, smem, stream);
    case 16: return launch_one<T, 16>(p, smem, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Lanes a channel this build runs (ops.ScanPlan.lanes must match).
int selective_scan_lanes() { return kLanes; }

// Dynamic shared bytes of a block of the plan (ops.ScanPlan.smem).
int selective_scan_smem_bytes(int n, int dtype, int lanes, int steps,
                              int stages) {
  return stages * stage_bytes(n, dtype == 1 ? 2 : 4, kThreads / lanes,
                              steps);
}

// dt and x (B, S, D), bm and cm (B, S, N) in one type (dtype 0: float32,
// 1: bfloat16), y (B, S, D) in that type; a (D, N), d_skip (D,) and
// h_last (B, D, N) float32; h_chunks null or (B, ceil(S / chunk), D, N)
// float32, chunk a multiple of a register group's steps; all
// contiguous.  N in {4, 8, 16}, divisible
// by the build's lanes; the plan's knobs as ops.ScanPlan documents them
// (a block is kThreads threads, kThreads / lanes channels).  Returns the
// launch's cudaError_t.
int selective_scan_launch(const void* dt, const void* bm, const void* cm,
                          const void* x, const float* a, const float* d_skip,
                          void* y, float* h_last, float* h_chunks, int b,
                          int s, int d, int n, int chunk,
                          int dtype, int lanes, int steps, int stages,
                          int gran_dx, int gran_bc, void* stream) {
  if (b <= 0 || s <= 0 || d <= 0) return 0;
  if (b > 65535 || lanes != kLanes || n % lanes != 0 || steps < 1 ||
      steps % (2 * group_steps(n / lanes)) != 0 || stages < 2 || stages > 5 ||
      (h_chunks != nullptr &&
       (chunk < 1 || chunk % group_steps(n / lanes) != 0)))
    return (int)cudaErrorInvalidValue;
  const Params p{dt, bm, cm, x, a, d_skip, y, h_last, h_chunks, b, s, d,
                 chunk, kThreads / lanes, steps, stages, gran_dx, gran_bc};
  cudaStream_t strm = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(p, n, strm);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, n, strm);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

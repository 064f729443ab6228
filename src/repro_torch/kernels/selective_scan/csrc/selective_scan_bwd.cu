// The gradient of the Mamba-1 selective scan, sm_90a.
//
// Replaces no TPU kernel: the JAX package trains through XLA's
// differentiation of associative_scan (src/repro/models/mamba.py:88), and
// no Pallas kernel of it has a custom_vjp.  This is written against the
// math of the forward (selective_scan.cu).  For dt, x, dy (B, S, D),
// Bm, Cm (B, S, N), A (D, N), Dskip (D,), all float32, with
// u_s = dt_s x_s, a_s = exp(dt_s A) and
//   g_s = dy_s Cm_s + a_{s+1} g_{s+1}     (the gradient of h_s; g_{S-1}
//                                          also takes dh_last)
// it writes
//   dCm_s = sum_d h_s dy_s          dBm_s = sum_d g_s u_s
//   du_s  = sum_n g_s Bm_s          dx_s  = du_s dt_s + Dskip dy_s
//   d dt_s = du_s x_s + sum_n g_s h_{s-1} a_s A
//   dA = sum_{b,s} g_s h_{s-1} a_s dt_s      dDskip = sum_{b,s} dy_s x_s.
//
// What bounds it on the H100: the issue slots of the float32 operations
// (about 19 an element, B S D N elements), the B S D N exps on the
// special-function units, and the bytes (dt, x, dy read once, dx and
// d dt written once), all three of the same order (ops.py's bound,
// chip_smoke.py's numbers).  The sums over D (d Bm, d Cm) are the part
// that costs most beyond the arithmetic: every element takes part in two.
//
// Design.  States are never rebuilt by dividing by exp(dt A), which loses
// everything where a_s underflows.  The forward saves the state each
// chunk of K = 16 steps starts from (h_chunks, (B, ceil(S/K), D, N),
// ref.STEPS); the backward walks the chunks last first, each in two
// passes over registers:
// 1. rebuild the chunk's states forward from its boundary state, keeping
//    a_s and h_{s-1} of every step in registers (2 K P floats a thread:
//    one exp an element, never a second);
// 2. walk the chunk backward carrying g a state in registers.
// A channel's N states are spread over L = BWD_LANES lanes (P = N / L
// each), so a channel's operands are read once a lane and its sums over
// N (du, the A part of d dt) are added in registers, then across the L
// lanes transposed, as the forward's lane_sum: L - 1 shuffles every L
// steps.  A warp holds 32 / L channels, a block BWD_WARPS warps.  The sums
// over the block's channels (d Cm in pass 1, d Bm in pass 2) are added
// across the warp's channels the same transposed way, every 32 / N steps
// (32 / L - 1 shuffles for 32 / L values a lane), then across warps in a
// fixed pairwise order, into a workspace row (B, S, blocks, N) that a
// second kernel adds in a fixed order: no atomics, so two calls give the
// same bits.  Sums over D, B and S are pairwise trees or compensated
// (Kahan); a thread's sums over its own steps (dA's, dDskip's) stay plain.
// Nothing is stored to shared memory inside a pass (the sums and dx, d dt
// wait in registers): a store there keeps the loads after it from moving
// up, and a first version that stored as it went was much slower.
// Each chunk's dt, x, dy, Bm, Cm rows and its boundary states come by
// cp.async, in the largest pieces (16, 8 or 4 bytes) the rows and the
// addresses admit, into a ring of two chunk buffers, one chunk ahead of
// the walk; dx and d dt go out through shared memory as whole rows.
// Rows past S and channels past D read as zero: their a_s is ex2(0) = 1
// exactly (PTX's ex2 maps +-0 to +1) and their u_s, Bm, dy 0, so they
// carry g through unchanged and add exact zeros.  The exp is
// ex2.approx.ftz.f32 on dt * (A log2 e), as in the forward.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef BWD_LANES
#define BWD_LANES 4
#endif
#ifndef BWD_WARPS
#define BWD_WARPS 8
#endif

constexpr int kLanes = BWD_LANES;  // lanes a channel
constexpr int kWarps = BWD_WARPS;  // warps a block
static_assert(kLanes == 2 || kLanes == 4 || kLanes == 8,
              "BWD_LANES is 2, 4 or 8");
static_assert(kWarps == 2 || kWarps == 4 || kWarps == 8,
              "BWD_WARPS is 2, 4 or 8");
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 16;         // K, steps a chunk (ref.STEPS)
constexpr int kStages = 2;         // chunk buffers in the ring
constexpr int kMaxStates = 4;      // P <= 4: 2 K P floats of registers
constexpr int kRowWarps = 8;       // warps a block of the row sums
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A compensated (Kahan) running sum, for the sums over the blocks and
// over the batch.
struct Sum {
  float s = 0.0f, c = 0.0f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
  __device__ __forceinline__ float value() const { return s - c; }
};

// P consecutive floats of shared memory
template <int P>
__device__ __forceinline__ void load_row(const float* s, float (&o)[P]) {
  if constexpr (P == 4) {
    const float4 f = *reinterpret_cast<const float4*>(s);
    o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
  } else if constexpr (P == 2) {
    const float2 f = *reinterpret_cast<const float2*>(s);
    o[0] = f.x; o[1] = f.y;
  } else {
    o[0] = s[0];
  }
}

__device__ __forceinline__ void copy_piece(float* dst, const float* src,
                                           int g) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (g == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
  } else if (g == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
  }
}

__device__ __forceinline__ void store_piece(float* dst, const float* src,
                                            int g) {
  if (g == 16) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  } else if (g == 8) {
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until every committed group has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Transposed sums over V lanes, the lanes `stride` apart whose slot index
// `idx` runs 0..V-1 (the other lane bits fixed): on return the lane of
// slot i holds the sum over the V lanes of everyone's v[i].  Each level
// sends the half of its values its partner keeps and adds the half it
// keeps, so V - 1 shuffles cover V values, in a fixed pairwise order.
// With stride 1 and V = L it sums a channel's lanes (the forward's
// lane_sum); with stride L and V = 32 / L, a warp's channels.
template <int V, int Stride>
__device__ __forceinline__ float xsum(float (&v)[V], int idx) {
#pragma unroll
  for (int w = V / 2; w >= 1; w /= 2) {
    const bool upper = (idx & w) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = upper ? v[i] : v[i + w];
      const float keep = upper ? v[i + w] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w * Stride);
    }
  }
  return v[0];
}

struct Params {
  const float* dt;
  const float* bm;
  const float* cm;
  const float* x;
  const float* a;
  const float* d_skip;
  const float* dy;
  const float* dh_last;    // null for 0
  const float* h_chunks;   // (B, ceil(S / K), D, N)
  float* d_dt;
  float* d_x;
  float* ws_bm;            // (B, S, blocks, N) sums over a block's channels
  float* ws_cm;
  float* ws_a;             // (B, D, N)
  float* ws_d;             // (B, D)
  int b, s, d;
  int blocks;              // blocks along D
  int gran;                // bytes a piece of a (B, S, D) row: 16, 8, 4
  int gran_bc;             // bytes a piece of a Bm / Cm row
  int gran_h;              // bytes a piece of a boundary-state row
};

constexpr int kWarpChannels = 32 / kLanes;         // channels a warp
constexpr int kChannels = kWarps * kWarpChannels;   // channels a block
// A row of a block's channels in shared memory, padded by a warp's
// channels so that the lanes of a channel reading L consecutive steps
// hit L x 32 / L distinct banks.
constexpr int kRow = kChannels + kWarpChannels;

// Floats of one chunk buffer of the ring: the dt, x, dy rows (K rows
// each), the Bm and Cm rows (K x N each), the boundary states (C x N).
__host__ __device__ constexpr int stage_floats(int n) {
  return 3 * kSteps * kRow + 2 * kSteps * n + kChannels * n;
}

// Floats of shared memory a block uses: the ring, the warps' sums of
// d Cm and d Bm (2 x warps x K x N), the dx and d dt rows (2 x K x C).
__host__ __device__ inline int smem_floats(int n) {
  return kStages * stage_floats(n) + 2 * kWarps * kSteps * n
         + 2 * kSteps * kChannels;
}

__host__ __device__ inline long long ws_floats(int b, int s, int d, int n) {
  const long long blocks = (d + kChannels - 1) / kChannels;
  return 2LL * b * s * blocks * n + (long long)b * d * n + (long long)b * d;
}

// The minimum of one block an SM lets ptxas give a thread the registers
// the chunk's 2 K P floats need.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    scan_bwd_kernel(const __grid_constant__ Params p) {
  constexpr int L = kLanes;               // lanes a channel
  constexpr int P = N / L;                // states a lane
  constexpr int CW = kWarpChannels;
  constexpr int C = kChannels;
  constexpr int CS = kRow;                // a row's stride
  constexpr int K = kSteps;
  constexpr int R = CW / P;               // steps a warp sum covers
  constexpr int KN = K * N;
  constexpr int kStage = stage_floats(N);
  static_assert(N % L == 0 && P <= kMaxStates && K % R == 0 && K % L == 0,
                "a lane holds 1-4 states; K covers whole sums");
  extern __shared__ __align__(16) float smem[];
  float* part = smem + kStages * kStage;    // [2][warps][K N]: d Cm, d Bm
  float* out = part + 2 * kWarps * KN;      // [2][K][C]: dx, d dt
  static_assert(kStage % 4 == 0 && CS % 4 == 0 && C % 4 == 0 && KN % 4 == 0,
                "every row of shared memory starts 16-byte aligned");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cw = lane / L, j = lane % L;
  const int c = warp * CW + cw;
  const int d0 = blockIdx.x * C, d = d0 + c;
  const int b = blockIdx.y;
  const int dc = min(C, p.d - d0);          // this block's channels
  const bool live = c < dc;
  const int nc = (p.s + K - 1) / K;
  const long long bs = (long long)b * p.s;

  const int gq = p.gran / 4, per_row = dc / gq;

  // the ring starts zero: rows past S and channels past D stay so
  for (int i = tid; i < kStages * kStage / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // chunk k into buffer k % kStages
  auto issue = [&](int k) {
    float* buf = smem + (k % kStages) * kStage;
    const int t0 = k * K, rows = min(K, p.s - t0);
    const float* h0 = p.h_chunks + (((long long)b * nc + k) * p.d + d0) * N;
    const long long row0 = (bs + t0) * p.d + d0;
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, q = (i - r * per_row) * gq;
      const long long off = row0 + (long long)r * p.d + q;
      float* dst = buf + r * CS + q;
      copy_piece(dst, p.dt + off, p.gran);
      copy_piece(dst + K * CS, p.x + off, p.gran);
      copy_piece(dst + 2 * K * CS, p.dy + off, p.gran);
    }
    const int gb = p.gran_bc / 4;
    for (int i = tid * gb; i < rows * N; i += kThreads * gb) {
      const long long off = (bs + t0) * N + i;
      copy_piece(buf + 3 * K * CS + i, p.bm + off, p.gran_bc);
      copy_piece(buf + 3 * K * CS + KN + i, p.cm + off, p.gran_bc);
    }
    const int gh = p.gran_h / 4;
    for (int i = tid * gh; i < dc * N; i += kThreads * gh)
      copy_piece(buf + 3 * K * CS + 2 * KN + i, h0 + i, p.gran_h);
  };

  float A[P], a2[P], carry[P], da[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const long long i = (long long)d * N + j * P + q;
    A[q] = live ? p.a[i] : 0.0f;
    a2[q] = A[q] * kLog2e;
    carry[q] = (live && p.dh_last != nullptr)
                   ? p.dh_last[(long long)b * p.d * N + i] : 0.0f;
    da[q] = 0.0f;
  }
  const float dsk = live ? p.d_skip[d] : 0.0f;
  float dd = 0.0f;
  float* pcm = part + warp * KN;              // this warp's d Cm sums
  float* pbm = part + (kWarps + warp) * KN;   // and d Bm sums

  issue(nc - 1);
  cp_async_commit();
  for (int k = nc - 1; k >= 0; --k) {
    cp_async_wait_all();                    // chunk k has landed
    __syncthreads();                        // and chunk k + 1 is done with
    if (k >= 1) issue(k - 1);
    cp_async_commit();
    const float* buf = smem + (k % kStages) * kStage;
    const int t0 = k * K, rows = min(K, p.s - t0);
    const float* sdt = buf + c;             // [K][CS], this channel
    const float* sx = sdt + K * CS;
    const float* sdy = sx + K * CS;
    const float* sbm = buf + 3 * K * CS + j * P;   // [K][N], this lane's
    const float* scm = sbm + KN;
    float hp[K][P], av[K][P];               // h_{s-1}, a_s of the chunk
    float v[CW];                            // R steps x P states to sum
    // the warp sums and the lane's dx, d dt, stored after each pass: a
    // store inside a pass would keep the loads after it from moving up
    float sums[K / R], odx[K / L], oddt[K / L];

    // 1. the chunk's states from the state it starts from; d Cm's
    //    products summed over the warp's channels every R steps
    float h[P];
    load_row<P>(buf + 3 * K * CS + 2 * KN + c * N + j * P, h);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float vdt = sdt[r * CS];
      const float u = vdt * sx[r * CS], vdy = sdy[r * CS];
      float bmv[P];
      load_row<P>(sbm + r * N, bmv);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float ar = ex2(vdt * a2[q]);
        av[r][q] = ar;
        hp[r][q] = h[q];
        h[q] = ar * h[q] + u * bmv[q];
        v[(r % R) * P + q] = h[q] * vdy;
      }
      if (r % R == R - 1) sums[r / R] = xsum<CW, L>(v, cw);
    }
#pragma unroll
    for (int i = 0; i < K / R; ++i) pcm[i * 32 + lane] = sums[i];

    // 2. backward through the chunk: du and d dt's A part added across
    //    the channel's lanes every L steps (lane j takes step r + j), d Bm's
    //    products over the warp's channels every R steps
    float du[L], dta[L];
#pragma unroll
    for (int r = K - 1; r >= 0; --r) {
      const float vdt = sdt[r * CS], vx = sx[r * CS], vdy = sdy[r * CS];
      const float u = vdt * vx;
      float bmv[P], cmv[P];
      load_row<P>(sbm + r * N, bmv);
      load_row<P>(scm + r * N, cmv);
      float sdu = 0.0f, sdta = 0.0f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float g = vdy * cmv[q] + carry[q];
        carry[q] = av[r][q] * g;
        const float w = carry[q] * hp[r][q];
        sdu += g * bmv[q];
        sdta += w * A[q];
        da[q] += w * vdt;
        v[(r % R) * P + q] = g * u;
      }
      du[r % L] = sdu;
      dta[r % L] = sdta;
      if (r % R == 0) sums[r / R] = xsum<CW, L>(v, cw);
      if (r % L == 0) {
        const float tdu = xsum<L, 1>(du, j), tdta = xsum<L, 1>(dta, j);
        const int t = r + j;
        const float tdt = sdt[t * CS], tx = sx[t * CS], tdy = sdy[t * CS];
        odx[r / L] = tdu * tdt + dsk * tdy;
        oddt[r / L] = tdu * tx + tdta;
        dd += tdy * tx;
      }
    }
#pragma unroll
    for (int i = 0; i < K / R; ++i) pbm[i * 32 + lane] = sums[i];
#pragma unroll
    for (int i = 0; i < K / L; ++i) {
      out[(i * L + j) * C + c] = odx[i];
      out[(K + i * L + j) * C + c] = oddt[i];
    }
    __syncthreads();

    // the dx and d dt rows out; the warps' sums, pairwise in warp order,
    // into the workspace rows
    const long long row0 = (bs + t0) * p.d + d0;
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, q = (i - r * per_row) * gq;
      const long long off = row0 + (long long)r * p.d + q;
      store_piece(p.d_x + off, out + r * C + q, p.gran);
      store_piece(p.d_dt + off, out + (K + r) * C + q, p.gran);
    }
#pragma unroll
    for (int i = 0; i < (K * N + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (e < rows * N) {
        const int st = e / N, n = e % N;
        const int slot = (st / R) * 32
                         + (((st % R) * P + n % P) * L + n / P);
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const float* src = part + which * kWarps * KN + slot;
          float s[kWarps];
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s[w] = src[w * KN];
#pragma unroll
          for (int h2 = kWarps / 2; h2 >= 1; h2 /= 2) {
#pragma unroll
            for (int w = 0; w < h2; ++w) s[w] += s[w + h2];
          }
          float* ws = which == 0 ? p.ws_cm : p.ws_bm;
          ws[((bs + t0 + st) * p.blocks + blockIdx.x) * N + n] = s[0];
        }
      }
    }
  }
  cp_async_wait_all();
  // dDskip: the channel's lanes added in a fixed order
#pragma unroll
  for (int off = 1; off < L; off *= 2)
    dd += __shfl_xor_sync(0xffffffffu, dd, off);
  if (!live) return;
#pragma unroll
  for (int q = 0; q < P; ++q)
    p.ws_a[((long long)b * p.d + d) * N + j * P + q] = da[q];
  if (j == 0) p.ws_d[(long long)b * p.d + d] = dd;
}

// out[row, m] = sum over blocks of ws[row, block, m]: a warp a row, each
// lane adding (compensated) the float4s of one group of states over every
// 32nd piece in order, then the lanes of a group added by a fixed
// butterfly.
template <int N>
__global__ void scan_bwd_rows_kernel(const float* ws, float* out,
                                     long long rows, int blocks) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;                // the whole warp together
  const float4* src =
      reinterpret_cast<const float4*>(ws + row * blocks * N);
  const int pieces = blocks * N / 4;
  Sum sx, sy, sz, sw;
  for (int i = lane; i < pieces; i += 32) {   // 4 i % N is 4 lane % N
    const float4 v = src[i];
    sx.add(v.x); sy.add(v.y); sz.add(v.z); sw.add(v.w);
  }
  float4 acc = make_float4(sx.value(), sy.value(), sz.value(), sw.value());
#pragma unroll
  for (int off = N / 4; off < 32; off *= 2) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  if (lane < N / 4) reinterpret_cast<float4*>(out + row * N)[lane] = acc;
}

// dA and dDskip: the batch rows' sums, in batch order
__global__ void scan_bwd_batch_kernel(const float* ws_a, const float* ws_d,
                                      float* d_a, float* d_d, int b, int dn,
                                      int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < dn) {
    Sum acc;
    for (int r = 0; r < b; ++r) acc.add(ws_a[(long long)r * dn + i]);
    d_a[i] = acc.value();
  } else if (i < dn + d) {
    Sum acc;
    for (int r = 0; r < b; ++r) acc.add(ws_d[(long long)r * d + i - dn]);
    d_d[i - dn] = acc.value();
  }
}

template <int N>
cudaError_t launch(const Params& p, float* d_bm, float* d_cm, float* d_a,
                   float* d_d, cudaStream_t stream) {
  if constexpr (N % kLanes != 0 || N / kLanes > kMaxStates) {
    return cudaErrorInvalidValue;
  } else {
    auto fn = scan_bwd_kernel<N>;
    const int smem = smem_floats(N) * (int)sizeof(float);
    static int allowed = 48 * 1024;       // dynamic shared bytes admitted
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      allowed = smem;
    }
    fn<<<dim3(p.blocks, p.b), kThreads, smem, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long rows = (long long)p.b * p.s;
    const unsigned grid = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
    scan_bwd_rows_kernel<N><<<grid, 32 * kRowWarps, 0, stream>>>(
        p.ws_bm, d_bm, rows, p.blocks);
    scan_bwd_rows_kernel<N><<<grid, 32 * kRowWarps, 0, stream>>>(
        p.ws_cm, d_cm, rows, p.blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int dn = p.d * N;
    scan_bwd_batch_kernel<<<(dn + p.d + 255) / 256, 256, 0, stream>>>(
        p.ws_a, p.ws_d, d_a, d_d, p.b, dn, p.d);
    return cudaGetLastError();
  }
}

bool good_granule(int g) { return g == 4 || g == 8 || g == 16; }

}  // namespace

extern "C" {

// The build's knobs (ops.BwdPlan must match): lanes a channel, warps a
// block, steps a chunk.
int selective_scan_bwd_lanes() { return kLanes; }
int selective_scan_bwd_warps() { return kWarps; }
int selective_scan_bwd_steps() { return kSteps; }

// Dynamic shared bytes of a block at N states (ops.BwdPlan.smem).
int selective_scan_bwd_smem_bytes(int n) {
  return smem_floats(n) * (int)sizeof(float);
}

// Bytes of the workspace (ops.BwdPlan.workspace_bytes).
long long selective_scan_bwd_workspace_bytes(int b, int s, int d, int n) {
  return ws_floats(b, s, d, n) * (long long)sizeof(float);
}

// dt, x, dy, d_dt, d_x (B, S, D); bm, cm, d_bm, d_cm (B, S, N); a, d_a
// (D, N); d_skip, d_d (D,); dh_last null or (B, D, N); h_chunks (B,
// ceil(S / steps), D, N) from the forward run with the same `steps` (the
// build's K); ws of selective_scan_bwd_workspace_bytes; all float32 and
// contiguous.  N in {4, 8, 16}, divisible by the build's lanes into at
// most 4 states a lane; gran, gran_bc, gran_h the bytes (16,
// 8 or 4) a piece of a (B, S, D) row, a Bm / Cm row and a boundary-state
// row moves in, dividing the row's bytes and every address.  Returns the
// first launch's cudaError_t that is not cudaSuccess, else cudaSuccess.
int selective_scan_bwd_launch(const float* dt, const float* bm,
                              const float* cm, const float* x, const float* a,
                              const float* d_skip, const float* dy,
                              const float* dh_last, const float* h_chunks,
                              float* d_dt, float* d_bm, float* d_cm,
                              float* d_x, float* d_a, float* d_d, float* ws,
                              int b, int s, int d, int n, int steps,
                              int gran, int gran_bc, int gran_h,
                              void* stream) {
  if (b <= 0 || s <= 0 || d <= 0) return 0;
  if (b > 65535 || steps != kSteps || (n != 4 && n != 8 && n != 16) ||
      !good_granule(gran) || !good_granule(gran_bc) ||
      !good_granule(gran_h) ||
      smem_floats(n) * (long long)sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  const int blocks = (d + kChannels - 1) / kChannels;
  const long long rows = (long long)b * s * blocks * n;
  Params p;
  p.dt = dt; p.bm = bm; p.cm = cm; p.x = x; p.a = a; p.d_skip = d_skip;
  p.dy = dy; p.dh_last = dh_last; p.h_chunks = h_chunks;
  p.d_dt = d_dt; p.d_x = d_x;
  p.ws_bm = ws; p.ws_cm = ws + rows; p.ws_a = ws + 2 * rows;
  p.ws_d = ws + 2 * rows + (long long)b * d * n;
  p.b = b; p.s = s; p.d = d; p.blocks = blocks;
  p.gran = gran; p.gran_bc = gran_bc; p.gran_h = gran_h;
  cudaStream_t strm = (cudaStream_t)stream;
  switch (n) {
    case 4: return (int)launch<4>(p, d_bm, d_cm, d_a, d_d, strm);
    case 8: return (int)launch<8>(p, d_bm, d_cm, d_a, d_d, strm);
    case 16: return (int)launch<16>(p, d_bm, d_cm, d_a, d_d, strm);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

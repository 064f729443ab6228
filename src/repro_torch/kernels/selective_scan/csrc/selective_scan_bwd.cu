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
// What bounds it on the H100: the exponentials and the float32
// operations, about level with the bytes (dt, x, dy read once, dx and
// d dt written once: ops.py's bound, chip_smoke.py's numbers).
//
// Design.  States are never rebuilt by dividing by exp(dt A), which loses
// everything where a_s underflows.  The forward kernel saves the state
// each stage of T = `steps` steps starts from (h_chunks, (B, ceil(S/T),
// D, N)); the backward walks those chunks in reverse, each in two passes:
// 1. rebuild the chunk's states forward from its boundary state into
//    shared memory (T x C x N floats: T steps of N floats a thread will
//    not fit in registers);
// 2. walk the chunk backward carrying g in a register, reading h_{s-1}
//    from shared memory and overwriting h_s's slot with g_s u_s.
// A block is C = 256 / N channels of one batch row, one thread a (channel,
// state).  du and the A part of d dt are summed over a channel's N lanes
// by shuffles each step.  The sums over D (dBm, dCm) and over B and S
// (dA, dDskip) are never taken with atomics: each block sums its own
// channels in channel order into a workspace row (B, S, blocks, N), and
// a second kernel adds the rows in a fixed order (one warp a (b, s), a
// fixed butterfly), so two calls give the same bits; those sums are
// compensated (Kahan).  The exp is
// ex2.approx.ftz.f32 on dt * (A log2 e), as in the forward.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads a block: channels x N
constexpr int kRowWarps = 8;       // warps a block of the row sums
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A compensated (Kahan) running sum: the fixed-order sums over a block's
// channels, over the blocks and over the batch keep the error of a few
// additions rather than of one a term: with plain running sums, d Bm and
// d Cm over D = 8192 channels at S = 1 came out 3x further from float64
// than the plain float32 backward's.  The per-thread sums over the steps
// (dA's, dDskip's) stay plain: compensated, they slowed the kernel's
// step loop (PERF.md §6).
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

struct Params {
  const float* dt;
  const float* bm;
  const float* cm;
  const float* x;
  const float* a;
  const float* d_skip;
  const float* dy;
  const float* dh_last;    // null for 0
  const float* h_chunks;   // (B, chunks, D, N)
  float* d_dt;
  float* d_x;
  float* ws_bm;            // (B, S, blocks, N) sums over a block's channels
  float* ws_cm;
  float* ws_a;             // (B, D, N)
  float* ws_d;             // (B, D)
  int b, s, d;
  int steps;               // T, the forward's steps a stage
  int blocks;              // blocks along D
};

// Floats of shared memory a block uses: the chunk's states (T, C, N), its
// dt, x, dy rows and the dx, d dt rows it writes (T, C each), its Bm and
// Cm rows (T, N each).
__host__ __device__ inline int smem_floats(int n, int steps) {
  const int c = kThreads / n;
  return steps * (c * n + 5 * c + 2 * n);
}

__host__ __device__ inline long long ws_floats(int b, int s, int d, int n) {
  const long long blocks = (d + kThreads / n - 1) / (kThreads / n);
  return 2LL * b * s * blocks * n + (long long)b * d * n + (long long)b * d;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const Params p) {
  constexpr int C = kThreads / N;         // channels a block
  extern __shared__ __align__(16) float smem[];
  const int T = p.steps;
  float* hs = smem;                       // [T][C][N]
  float* sdt = hs + T * C * N;            // [T][C]
  float* sx = sdt + T * C;
  float* sdy = sx + T * C;
  float* odx = sdy + T * C;
  float* oddt = odx + T * C;
  float* sbm = oddt + T * C;              // [T][N]
  float* scm = sbm + T * N;
  const int tid = threadIdx.x, c = tid / N, n = tid % N;
  const int d0 = blockIdx.x * C, d = d0 + c;
  const int b = blockIdx.y;
  const int dc = min(C, p.d - d0);        // this block's channels
  const bool live = d < p.d;
  const int nc = (p.s + T - 1) / T;
  const long long bs = (long long)b * p.s;
  const float A = live ? p.a[(long long)d * N + n] : 0.0f;
  const float a2 = A * kLog2e;
  const float dsk = live ? p.d_skip[d] : 0.0f;
  float carry = (live && p.dh_last != nullptr)
                    ? p.dh_last[((long long)b * p.d + d) * N + n] : 0.0f;
  float da = 0.0f, dd = 0.0f;

  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * T, rows = min(T, p.s - t0);
    __syncthreads();                      // the last chunk's rows are out
    for (int i = tid; i < rows * C; i += kThreads) {
      const int r = i / C, q = i - r * C;
      float vdt = 0.0f, vx = 0.0f, vdy = 0.0f;
      if (q < dc) {
        const long long off = (bs + t0 + r) * p.d + d0 + q;
        vdt = p.dt[off];
        vx = p.x[off];
        vdy = p.dy[off];
      }
      sdt[i] = vdt;
      sx[i] = vx;
      sdy[i] = vdy;
    }
    for (int i = tid; i < rows * N; i += kThreads) {
      const long long off = (bs + t0) * N + i;
      sbm[i] = p.bm[off];
      scm[i] = p.cm[off];
    }
    __syncthreads();

    // 1. the chunk's states, from the state it starts from
    const float h0 =
        live ? p.h_chunks[(((long long)b * nc + k) * p.d + d) * N + n]
             : 0.0f;
    float h = h0;
    for (int r = 0; r < rows; ++r) {
      const float vdt = sdt[r * C + c];
      const float u = vdt * sx[r * C + c];
      h = ex2(vdt * a2) * h + u * sbm[r * N + n];
      hs[(r * C + c) * N + n] = h;
    }
    __syncthreads();
    // dCm's sums over this block's channels, in channel order
    for (int i = tid; i < rows * N; i += kThreads) {
      const int r = i / N, m = i - r * N;
      Sum acc;
      for (int q = 0; q < dc; ++q)
        acc.add(hs[(r * C + q) * N + m] * sdy[r * C + q]);
      p.ws_cm[((bs + t0 + r) * p.blocks + blockIdx.x) * N + m] =
          acc.value();
    }
    __syncthreads();

    // 2. backward through the chunk; h_r's slot takes g_r u_r once read
    for (int r = rows - 1; r >= 0; --r) {
      const float vdt = sdt[r * C + c], vx = sx[r * C + c];
      const float vdy = sdy[r * C + c];
      const float ab = ex2(vdt * a2);
      const float g = vdy * scm[r * N + n] + carry;
      const float hp = r > 0 ? hs[((r - 1) * C + c) * N + n] : h0;
      const float w = g * hp * ab;
      float du = g * sbm[r * N + n];
      float dta = w * A;
      da += w * vdt;
      hs[(r * C + c) * N + n] = g * (vdt * vx);
      carry = ab * g;
#pragma unroll
      for (int off = N / 2; off >= 1; off /= 2) {
        du += __shfl_xor_sync(0xffffffffu, du, off);
        dta += __shfl_xor_sync(0xffffffffu, dta, off);
      }
      if (n == 0) {
        odx[r * C + c] = du * vdt + dsk * vdy;
        oddt[r * C + c] = du * vx + dta;
        dd += vdy * vx;
      }
    }
    __syncthreads();
    // dBm's sums over this block's channels; the dx and d dt rows out
    for (int i = tid; i < rows * N; i += kThreads) {
      const int r = i / N, m = i - r * N;
      Sum acc;
      for (int q = 0; q < dc; ++q) acc.add(hs[(r * C + q) * N + m]);
      p.ws_bm[((bs + t0 + r) * p.blocks + blockIdx.x) * N + m] =
          acc.value();
    }
    for (int i = tid; i < rows * C; i += kThreads) {
      const int r = i / C, q = i - r * C;
      if (q < dc) {
        const long long off = (bs + t0 + r) * p.d + d0 + q;
        p.d_x[off] = odx[i];
        p.d_dt[off] = oddt[i];
      }
    }
  }
  if (!live) return;
  p.ws_a[((long long)b * p.d + d) * N + n] = da;
  if (n == 0) p.ws_d[(long long)b * p.d + d] = dd;
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
  auto fn = scan_bwd_kernel<N>;
  const int smem = smem_floats(N, p.steps) * (int)sizeof(float);
  static int allowed = 48 * 1024;         // dynamic shared bytes admitted
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

}  // namespace

extern "C" {

// Threads a block (ops.BWD_THREADS must match).
int selective_scan_bwd_threads() { return kThreads; }

// Dynamic shared bytes of a block at N states and `steps` steps a chunk
// (ops.BwdPlan.smem).
int selective_scan_bwd_smem_bytes(int n, int steps) {
  return smem_floats(n, steps) * (int)sizeof(float);
}

// Bytes of the workspace (ops.BwdPlan.workspace_bytes).
long long selective_scan_bwd_workspace_bytes(int b, int s, int d, int n) {
  return ws_floats(b, s, d, n) * (long long)sizeof(float);
}

// dt, x, dy, d_dt, d_x (B, S, D); bm, cm, d_bm, d_cm (B, S, N); a, d_a
// (D, N); d_skip, d_d (D,); dh_last null or (B, D, N); h_chunks (B,
// ceil(S / steps), D, N) from the forward kernel run with the same
// `steps`; ws of selective_scan_bwd_workspace_bytes; all float32 and
// contiguous.  N in {4, 8, 16}.  Returns the first launch's cudaError_t
// that is not cudaSuccess, else cudaSuccess.
int selective_scan_bwd_launch(const float* dt, const float* bm,
                              const float* cm, const float* x, const float* a,
                              const float* d_skip, const float* dy,
                              const float* dh_last, const float* h_chunks,
                              float* d_dt, float* d_bm, float* d_cm,
                              float* d_x, float* d_a, float* d_d, float* ws,
                              int b, int s, int d, int n, int steps,
                              void* stream) {
  if (b <= 0 || s <= 0 || d <= 0) return 0;
  if (b > 65535 || steps < 1 || (n != 4 && n != 8 && n != 16) ||
      smem_floats(n, steps) * (long long)sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  const int blocks = (d + kThreads / n - 1) / (kThreads / n);
  const long long rows = (long long)b * s * blocks * n;
  Params p{dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks, d_dt, d_x,
           ws, ws + rows, ws + 2 * rows, ws + 2 * rows + (long long)b * d * n,
           b, s, d, steps, blocks};
  cudaStream_t strm = (cudaStream_t)stream;
  switch (n) {
    case 4: return (int)launch<4>(p, d_bm, d_cm, d_a, d_d, strm);
    case 8: return (int)launch<8>(p, d_bm, d_cm, d_a, d_d, strm);
    case 16: return (int)launch<16>(p, d_bm, d_cm, d_a, d_d, strm);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
